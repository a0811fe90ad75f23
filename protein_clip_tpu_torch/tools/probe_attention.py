"""Design readings of the attention kernels K1 and K5 on the card.

    python -m protein_clip_tpu_torch.tools.probe_attention [--out FILE]

Prints the card's name and power limit first, then:

1. The ring's fill route. K5's dk/dv launch as shipped (its ring filled by
   16-byte ``cp.async``) against the same launch fed by TMA
   (``probe_attention.cu`` beside this file: four tensor maps encoded on the
   host per call), at (16, 512) padded and dense and at the finetune chunks'
   (16, 192) and (16, 32) padded, NH=20: device time per launch by CUDA
   events over four input sets, in the order cp.async, TMA, TMA, cp.async;
   whether the two routes' dk and dv agree to the bit; the host time of one
   launch from Python for each route, and of encoding the four maps alone
   (``cuTensorMapEncodeTiled``, host clock).
2. The register caps. K5 and K1 as shipped against builds from patched
   copies of ``csrc/`` (under ``_build/probe/``): K5's dk/dv launch capped
   for three blocks an SM, and K1 capped for five, at head dim 32 (the
   shapes timed; a cap for five leaves the head-dim-128 K1 too few
   registers to compile). Device time per call (K1 by CUDA events, K5's
   two launches by ``timing.kernel_times``: ``torch.profiler`` with its
   kernel records a call, CUDA events and the SM clock beside it) at
   (16, 512) padded and dense, in the order shipped, variants, variants
   reversed, shipped, and each variant's largest difference from the
   shipped build's outputs.

``--out`` writes every reading as JSON too.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import itertools
import json
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ..kernels import build
from ..ops import attention
from .timing import kernel_times

NH, DH = 20, 32
PROBE_SRC = Path(__file__).resolve().parent / "probe_attention.cu"
PROBE_DIR = build.BUILD_ROOT / "probe"
# name: (source, shipped line, patched line)
VARIANTS = {
    "k5_dkdv_capped_3": ("attention_bwd.cu", "__global__ void __launch_bounds__(kThreads)\n"
                         "attention_bwd_dkdv_kernel",
                         "__global__ void __launch_bounds__(kThreads, HD == 32 ? 3 : 1)\n"
                         "attention_bwd_dkdv_kernel"),
    "k1_capped_5": ("attention_fwd.cu", "__global__ void __launch_bounds__(kThreads)\n"
                    "attention_fwd_kernel",
                    "__global__ void __launch_bounds__(kThreads, HD == 32 ? 5 : 1)\n"
                    "attention_fwd_kernel"),
}
ROUTE_SHAPES = ((16, 512, "padded"), (16, 512, "dense"), (16, 192, "padded"), (16, 32, "padded"))


def segments(B: int, T: int, kind: str) -> torch.Tensor:
    """chip_smoke.py's timing segments: true lengths spread over
    [T / 8, T] (padded), or every token in one segment (dense)."""
    seg = torch.zeros(B, T, dtype=torch.int32)
    lengths = np.linspace(max(1, T // 8), T, B).astype(int) if kind == "padded" else [T] * B
    for b, n in enumerate(lengths):
        seg[b, :n] = 1
    return seg.cuda()


def inputs(B: int, T: int, kind: str, gen: torch.Generator) -> dict:
    """q, k, v, dO, segments, K1's statistics, and launch 1's dq and delta."""
    def r(scale):
        return (scale * torch.randn(B, T, NH, DH, device="cuda", generator=gen)).bfloat16()
    x = {"q": r(DH ** -0.5), "k": r(1.0), "v": r(1.0), "do": r(1.0), "seg": segments(B, T, kind)}
    x["lse"] = attention._forward(x["q"], x["k"], x["v"], x["seg"], with_lse=True)[1]
    x["dq"] = torch.empty_like(x["q"])
    x["delta"] = torch.empty(B, NH, T, dtype=torch.float32, device="cuda")
    x["dk"], x["dv"] = torch.empty_like(x["q"]), torch.empty_like(x["q"])
    return x


def events_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean time of fn() by CUDA events over iters calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 2000) -> float:
    """Host microseconds per call of fn() (launches only; the card is
    synchronised before and after)."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(iters):
        fn()
    took = time.perf_counter() - start
    torch.cuda.synchronize()
    return 1e6 * took / iters


def build_all() -> tuple[ctypes.CDLL, dict]:
    """The probe library and each variant's attention_fwd and
    attention_bwd, all compiled at once: (probe, {variant: {kernel: lib}})."""
    jobs = [([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR)], PROBE_SRC,
             PROBE_DIR / "libprobe_attention.so")]
    libs = {}
    for name, (source, line, patched) in VARIANTS.items():
        src = PROBE_DIR / name / "csrc"
        shutil.rmtree(src.parent, ignore_errors=True)
        shutil.copytree(build.CSRC_DIR, src)
        text = (src / source).read_text()
        if text.count(line) != 1:
            raise RuntimeError(f"variant {name}: its line is not in csrc/{source} once")
        (src / source).write_text(text.replace(line, patched))
        for kernel in ("attention_fwd", "attention_bwd"):
            lib = src.parent / f"lib{kernel}.so"
            libs.setdefault(name, {})[kernel] = lib
            jobs.append(([build._nvcc(), *build.NVCC_FLAGS, "-I", str(src)], src / f"{kernel}.cu",
                         lib))
    (PROBE_DIR / "libprobe_attention.so").unlink(missing_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        reports = list(pool.map(lambda job: build.compile_library(*job), jobs))
    for (_, src, lib), report in zip(jobs, reports):
        regs = [ln.strip() for ln in report.splitlines()
                if any(w in ln for w in ("registers", "spill", "Compiling entry", "arning"))]
        print(f"[build] {lib.parent.name}/{lib.name} ({src.name}): {' | '.join(regs)}", flush=True)
    probe = ctypes.CDLL(str(PROBE_DIR / "libprobe_attention.so"))
    for fn, n_ptr in ((probe.pct_probe_delta, 8), (probe.pct_probe_dkdv, 9)):
        first = [ctypes.c_int] if fn is probe.pct_probe_dkdv else []
        fn.argtypes = first + [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    probe.pct_probe_encode_us.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
    probe.pct_probe_encode_us.restype = ctypes.c_double
    return probe, libs


def ptrs(x: dict, *names) -> list[int]:
    return [x[n].data_ptr() for n in names]


def route_readings(probe: ctypes.CDLL, gen: torch.Generator, gpu: str) -> list[dict]:
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for B, T, kind in ROUTE_SHAPES:
        sets = [inputs(B, T, kind, gen) for _ in range(4)]
        for x in sets:
            err = probe.pct_probe_delta(*ptrs(x, "q", "k", "v", "seg", "do", "lse", "dq", "delta"),
                                        B, T, NH, stream)
            if err:
                raise RuntimeError(f"pct_probe_delta: cudaError_t {err}")

        def launcher(tma: int, cycle):
            def launch():
                x = next(cycle)
                err = probe.pct_probe_dkdv(tma, *ptrs(x, "q", "k", "v", "seg", "do", "lse",
                                                      "delta", "dk", "dv"), B, T, NH, stream)
                if err:
                    raise RuntimeError(f"pct_probe_dkdv(tma={tma}): cudaError_t {err}")
            return launch

        outs = []
        for tma in (0, 1):
            launcher(tma, iter(sets[:1]))()
            torch.cuda.synchronize()
            outs.append((sets[0]["dk"].clone(), sets[0]["dv"].clone()))
        equal = all(torch.equal(a, b) for a, b in zip(*outs))
        ms = {0: [], 1: []}
        for tma in (0, 1, 1, 0):
            ms[tma].append(events_ms(launcher(tma, itertools.cycle(sets)), 100))
        host = {tma: host_us(launcher(tma, itertools.cycle(sets)), 500) for tma in (0, 1)}
        x = sets[0]
        encode = probe.pct_probe_encode_us(*ptrs(x, "q", "k", "v", "do"), B, T, NH, 10_000)
        row = {"shape": [B, T, NH, DH], "segments": kind, "cp_async_ms": ms[0], "tma_ms": ms[1],
               "bit_equal": equal, "cp_async_host_us": host[0], "tma_host_us": host[1],
               "encode_4_maps_us": encode}
        print(f"[route] K5 dk/dv launch B={B} T={T} NH={NH} {kind}: cp.async "
              f"{ms[0][0]:.6f}, {ms[0][1]:.6f} ms; TMA {ms[1][0]:.6f}, {ms[1][1]:.6f} ms; "
              f"dk, dv bit-equal {equal}; host per launch from Python: cp.async "
              f"{host[0]:.3f} us, TMA {host[1]:.3f} us (four maps encoded: {encode:.3f} us) "
              f"| {gpu}", flush=True)
        rows.append(row)
    return rows


@contextlib.contextmanager
def launching(libs: dict | None):
    """ops.attention launches these builds (None: its own) in the block."""
    saved = attention._launcher
    if libs is not None:
        bound = {k: attention.bind(ctypes.CDLL(str(lib)), k) for k, lib in libs.items()}
        attention._launcher = lambda name: bound[name]
    try:
        yield
    finally:
        attention._launcher = saved


def cap_readings(libs: dict, gen: torch.Generator, gpu: str) -> list[dict]:
    names = ["shipped", *libs]
    rows = []
    for B, T, kind in ((16, 512, "padded"), (16, 512, "dense")):
        sets = [inputs(B, T, kind, gen) for _ in range(4)]
        want = None
        times = {name: {"k1_ms": [], "k5_ms": [], "k5_records": [], "k5_kept_ms": [],
                        "k5_events_ms": [], "clock_mhz": []} for name in names}
        diff = {}
        for name in names + names[:0:-1] + names[:1]:
            with launching(None if name == "shipped" else libs[name]):
                cycle = itertools.cycle(sets)

                def k1():
                    x = next(cycle)
                    attention.fused_attention(x["q"], x["k"], x["v"], x["seg"])

                def k5():
                    x = next(cycle)
                    attention.fused_attention_bwd(x["q"], x["k"], x["v"], x["seg"], x["do"],
                                                  x["lse"])

                x = sets[0]
                got = (attention._forward(x["q"], x["k"], x["v"], x["seg"], with_lse=True)
                       + attention.fused_attention_bwd(x["q"], x["k"], x["v"], x["seg"], x["do"],
                                                       x["lse"]))
                if want is None:
                    want = got
                diff[name] = max(float((a.float() - b.float()).abs().max())
                                 for a, b in zip(got, want))
                times[name]["k1_ms"].append(events_ms(k1, 100))
                k5_t = kernel_times(k5, 100)
                times[name]["k5_ms"].append(k5_t["device_ms"])
                times[name]["k5_records"].append(k5_t["records"])
                times[name]["k5_kept_ms"].append(k5_t["kept_ms"])
                times[name]["k5_events_ms"].append(k5_t["events_ms"])
                times[name]["clock_mhz"].append(k5_t["clock_mhz"])
        for name in names:
            t = times[name]
            print(f"[caps] {name} B={B} T={T} NH={NH} {kind}: K1 "
                  f"{', '.join(f'{v:.6f}' for v in t['k1_ms'])} ms; K5 "
                  f"{', '.join(f'{v:.6f}' for v in t['k5_ms'])} ms of device time "
                  f"({', '.join(f'{v:g}' for v in t['k5_records'])} kernel records kept a "
                  f"call, {', '.join(f'{v:.6f}' for v in t['k5_kept_ms'])} ms their sum; "
                  f"CUDA events {', '.join(f'{v:.6f}' for v in t['k5_events_ms'])} ms; SM clock "
                  f"{t['clock_mhz']} MHz); max|diff| from shipped {diff[name]:.3g} | {gpu}",
                  flush=True)
            rows.append({"variant": name, "shape": [B, T, NH, DH], "segments": kind, **t,
                         "max_abs_diff": diff[name]})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, help="write the readings as JSON here too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device")
        return 1
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(gpu, flush=True)
    probe, libs = build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"gpu": gpu, "route": route_readings(probe, gen, gpu),
           "caps": cap_readings(libs, gen, gpu)}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
