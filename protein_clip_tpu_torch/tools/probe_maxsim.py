"""Design readings of the FILIP max-sim kernel K4 on the card.

    python -m protein_clip_tpu_torch.tools.probe_maxsim [--out FILE]

Prints the card's name and power limit first, then, at (Ba, Bb, TA, TB)
= (4, 256, 128, 512), the /topk shape (1, 256, 128, 512) and a full block
of the ragged scorer (64, 1024, 256, 256), D = 128, unit-norm f32 tokens
and padded 0/1 masks (true lengths over [T/4, T], as ``chip_smoke.py``
draws them), the device time per call by CUDA events of:

- ``ffma``: K4 as it was before its Hopper redesign, f32 FFMA on the CUDA
  cores (``probe_maxsim_ffma.cu`` beside this file);
- ``shipped``: ``csrc/filip_maxsim.cu`` as the port ships it: the ring
  filled by TMA, two consumer warpgroups (two b-tiles against each
  streamed a-slab), one block per candidate j;
- builds from patched copies of ``csrc/`` (under ``_build/probe/``, each
  launched through the package's C entry point), one choice its design
  leaves open at a time: ``cp.async`` (the ring filled by 16-byte
  ``cp.async``, no tensor maps), ``one warpgroup`` (one b-tile a block),
  ``several j`` (a grid of one block per SM, each walking several j),
  ``truncated hi`` (the raw f32 bits handed to the tensor core as hi, lo
  the remainder of their truncation); and four that leave a part out, their
  outputs wrong by design, to show where the time goes: ``no b split`` (a
  b-tile's chunks taken from the ring but not split into its hi and lo
  tiles), ``no epilogue`` (no row or column maxima; the accumulator is
  still read, so that ptxas keeps every product), ``one product`` (plain
  TF32: hi.hi alone), ``no products`` (no wgmma).

Each is timed twice, in the order listed and then reversed. Beside each:
its largest gap from ``ops.filip.maxsim_reference`` over oa and ob, and
whether its outputs equal, to the bit, those of ``shipped``: the fill
route and the grid change no arithmetic, so they must (one warpgroup sums
the columns' contributions in another order). Then the host time of
encoding K4's two tensor maps; ``shipped`` at the /topk shape with one,
two and a little over two blocks an SM (Bb = SMs, 256, 2 SMs + 2; one
block fits an SM there), which shows how its time goes in waves of
blocks; and last the tensor core's TF32 rate for the products K4 issues,
alone (``pct_probe_wgmma_rate``): groups of 12 ``wgmma`` m64n64k8 with A
from registers (as K4), m64n128k8 likewise, and m64n64k8 from shared
memory, one and two warpgroups an SM.

``--out`` writes every reading as JSON too.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import shutil
import subprocess
from pathlib import Path

import torch

from ..kernels import build
from ..ops import filip

D = 128
SHAPES = ((4, 256, 128, 512), (1, 256, 128, 512), (64, 1024, 256, 256))
ITERS = (50, 50, 5)
TOOLS = Path(__file__).resolve().parent
PROBE_DIR = build.BUILD_ROOT / "probe"
SHIPPED = "shipped"
# The ring filled by cp.async: a stage's full barrier takes the 32 lanes'
# copies and one arrival that publishes its header.
PUSH_TMA = """    __syncwarp();  // the header and masks before lane 0's (releasing) arrival
    if (lane == 0) {
      if (hdr.x == kEnd) {
        mbar_arrive(bar);
      } else {
        mbar_arrive_expect(bar, kChunkBytes);
        tma_load_3d(dst, map, kc * kChunk, t0, row, bar);
      }
    }
"""
PUSH_CP_ASYNC = """    if (hdr.x != kEnd) {
      const bool is_b = hdr.x == kB;
      const int T = is_b ? p.TB : p.TA;
      const float* src = (is_b ? p.hb : p.ha) + static_cast<int64_t>(row) * T * p.D;
      // 512 chunks of 16 bytes: row r's chunk q at q ^ (r % 8)
#pragma unroll 4
      for (int c = lane; c < kTile * 8; c += 32) {
        const int r = c >> 3, q = c & 7;
        const int d = kc * kChunk + 4 * q;
        const bool ok = t0 + r < T && d < p.D;
        cp_async16(dst + r * 128 + ((q ^ (r & 7)) << 4),
                   ok ? src + static_cast<int64_t>(t0 + r) * p.D + d : src, ok);
      }
    }
    cp_async_arrive(bar);  // 32 arrivals when the copies land
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);  // and one that publishes the header
"""
GRID = "  kernel<<<Bb, threads_of(kWgs), L.bytes, stream>>>(tma, tmb, p);"
# name: [(csrc/filip_maxsim.cu's text, patched text)], or ([header], text, patched
# text) for a shared header of csrc/
PARTS = {
    "cp.async": [(PUSH_TMA, PUSH_CP_ASYNC),
                 ("      mbar_init(full + 8 * s, 1);", "      mbar_init(full + 8 * s, 33);"),
                 ("    fence_proxy_async();  // generic reads before the next TMA write\n", ""),
                 ("  if (!(token_map(&tma, ha, Ba, TA, D) && token_map(&tmb, hb, Bb, TB, D))) {",
                  "  if (false) {")],
    "one warpgroup": [("  if (D <= 4 * kChunk) return launch<2>(", "  if (false) return launch<2>(")],
    "several j": [("    pr.run(blockIdx.x, &tma, &tmb);",
                   "    for (int j = blockIdx.x; j < p.Bb; j += gridDim.x) pr.run(j, &tma, &tmb);"),
                  ("  c.run(blockIdx.x);",
                   "  for (int j = blockIdx.x; j < p.Bb; j += gridDim.x) c.run(j);"),
                  (GRID, "  int sms = 132;\n"
                         "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);\n"
                   + GRID.replace("<<<Bb,", "<<<Bb < sms ? Bb : sms,"))],
    "truncated hi": [("hopper.cuh",
                      "  hi = tf32_rna(x);\n  lo = tf32_rna(x - __uint_as_float(hi));\n",
                      "  hi = __float_as_uint(x);\n"
                      "  lo = tf32_rna(x - __uint_as_float(hi & 0xffffe000u));\n")],
    "no b split": [("        st_shared16(hi0 + off, hi[0], hi[1], hi[2], hi[3]);\n"
                    "        st_shared16(lo0 + off, lo[0], lo[1], lo[2], lo[3]);\n", "")],
    # the accumulator still read (a max of its values), so that no product is dead code
    "no epilogue": [("    if (sa >= w0 && sa < w0 + p.window) {",
                     "    float keep = acc[0];\n#pragma unroll\n"
                     "    for (int k = 1; k < 32; ++k) keep = fmaxf(keep, acc[k]);\n"
                     "    if (keep == 1234.5f) rowmax[0] = keep;\n    if (false) {"),
                    ("    if (cols) {\n      // Butterfly", "    if (false) {\n      // Butterfly")],
    "one product": [("constexpr int kProducts = 3;", "constexpr int kProducts = 1;")],
    "no products": [("      wgmma_tf32(acc, hi[ks], dh[ks], kc > 0 || ks > 0);\n", ""),
                    ("        wgmma_tf32(acc, hi[ks], dl[ks], 1);\n", ""),
                    ("        wgmma_tf32(acc, lo[ks], dh[ks], 1);\n", "")],
}
RATE_MODES = ("RS m64n64k8", "RS m64n128k8", "SS m64n64k8")


def inputs(Ba: int, Bb: int, TA: int, TB: int, gen: torch.Generator):
    def tokens(B, T):
        return torch.nn.functional.normalize(
            torch.randn(B, T, D, device="cuda", generator=gen), dim=-1)

    def mask(B, T):
        lengths = torch.randint(max(1, T // 4), T + 1, (B, 1), device="cuda", generator=gen)
        return (torch.arange(T, device="cuda")[None, :] < lengths).to(torch.int32)

    return tokens(Ba, TA), tokens(Bb, TB), mask(Ba, TA), mask(Bb, TB)


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


def build_all() -> tuple[ctypes.CDLL, dict]:
    """The probe library and every kernel timed (the FFMA baseline, the
    shipped kernel and the PARTS builds, each a patched copy of csrc/),
    all compiled at once."""
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR)]
    jobs = [(cmd, TOOLS / "probe_maxsim.cu", PROBE_DIR / "libprobe_maxsim.so"),
            (cmd, TOOLS / "probe_maxsim_ffma.cu", PROBE_DIR / "libprobe_maxsim_ffma.so"),
            (cmd, build.CSRC_DIR / "filip_maxsim.cu", PROBE_DIR / "libfilip_maxsim.so")]
    for name, patches in PARTS.items():
        src = PROBE_DIR / name.replace(" ", "_").replace(".", "_") / "csrc"
        shutil.rmtree(src.parent, ignore_errors=True)
        shutil.copytree(build.CSRC_DIR, src)
        for patch in patches:
            target = src / (patch[0] if len(patch) == 3 else "filip_maxsim.cu")
            line, patched = patch[-2:]
            text = target.read_text()
            if text.count(line) != 1:
                raise RuntimeError(f"part {name}: its text is not in csrc/{target.name} once")
            target.write_text(text.replace(line, patched))
        jobs.append(([build._nvcc(), *build.NVCC_FLAGS, "-I", str(src)], src / "filip_maxsim.cu",
                     src.parent / "libfilip_maxsim.so"))
    for _, _, lib in jobs:
        lib.unlink(missing_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        reports = list(pool.map(lambda job: build.compile_library(*job), jobs))
    for (_, src, lib), report in zip(jobs, reports):
        regs = [ln.strip() for ln in report.splitlines() if "registers" in ln or "spill" in ln]
        print(f"[build] {lib.parent.name}/{lib.name}: {' | '.join(regs)}", flush=True)
    probe, ffma, shipped = (ctypes.CDLL(str(lib)) for _, _, lib in jobs[:3])
    probe.pct_probe_encode_us.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
    probe.pct_probe_encode_us.restype = ctypes.c_double
    probe.pct_probe_wgmma_rate.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    probe.pct_probe_wgmma_rate.restype = ctypes.c_double
    fn = ffma.pct_probe_maxsim_ffma   # the same arguments as pct_filip_maxsim
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    kernels = {"ffma": fn, SHIPPED: filip.bind(shipped)}
    for name, (_, _, lib) in zip(PARTS, jobs[3:]):
        kernels[name] = filip.bind(ctypes.CDLL(str(lib)))
    return probe, kernels


def launcher(fn, name: str, ptrs: list, shape: tuple):
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = fn(*ptrs, *shape, D, stream)
        if err:
            raise RuntimeError(f"{name}: cudaError_t {err}")
    return launch


def readings(kernels: dict, gen: torch.Generator, gpu: str) -> list:
    """Every kernel at every shape: its times (in order, then reversed), its
    largest gap from the plain version and whether it equals shipped's
    outputs to the bit."""
    rows = []
    for (Ba, Bb, TA, TB), iters in zip(SHAPES, ITERS):
        ha, hb, ma, mb = inputs(Ba, Bb, TA, TB, gen)
        oa = torch.empty(Ba, Bb, device="cuda")
        ob = torch.empty_like(oa)
        ptrs = [x.data_ptr() for x in (ha, hb, ma, mb, oa, ob)]
        want = filip.maxsim_reference(ha, hb, ma, mb)
        names = list(kernels)
        launchers, outs, gap = {}, {}, {}
        for name in names:
            launchers[name] = launcher(kernels[name], name, ptrs, (Ba, Bb, TA, TB))
            launchers[name]()
            torch.cuda.synchronize()
            outs[name] = (oa.clone(), ob.clone())
            gap[name] = max(float((g - w).abs().max()) for g, w in zip(outs[name], want))
        ms = {name: [] for name in names}
        for name in names + names[::-1]:
            ms[name].append(events_ms(launchers[name], iters))
        for name in names:
            equal = all(torch.equal(a, b) for a, b in zip(outs[name], outs[SHIPPED]))
            print(f"[probe] (Ba, Bb, TA, TB)=({Ba}, {Bb}, {TA}, {TB}) D={D} {name}: "
                  f"{', '.join(f'{v:.6f}' for v in ms[name])} ms; max|err| {gap[name]:.3g}; "
                  f"bit-equal to {SHIPPED}: {equal} | {gpu}", flush=True)
            rows.append({"shape": [Ba, Bb, TA, TB, D], "kernel": name, "ms": ms[name],
                         "max_abs_err": gap[name], "bit_equal_to_shipped": equal})
    return rows


def encode_reading(probe: ctypes.CDLL, gen: torch.Generator, gpu: str) -> dict:
    Ba, Bb, TA, TB = SHAPES[1]
    ha, hb, _, _ = inputs(Ba, Bb, TA, TB, gen)
    us = probe.pct_probe_encode_us(ha.data_ptr(), hb.data_ptr(), Ba, Bb, TA, TB, D, 10_000)
    print(f"[probe] encoding K4's two tensor maps: {us:.3f} us of host time | {gpu}", flush=True)
    return {"shape": [Ba, Bb, TA, TB, D], "encode_2_maps_us": us}


def wave_readings(kernels: dict, gen: torch.Generator, gpu: str) -> list:
    """shipped at the /topk shape with Bb = SMs, 256 and 2 SMs + 2 blocks."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    Ba, _, TA, TB = SHAPES[1]
    rows = []
    for Bb in (sms, 256, 2 * sms + 2):
        ha, hb, ma, mb = inputs(Ba, Bb, TA, TB, gen)
        oa = torch.empty(Ba, Bb, device="cuda")
        ob = torch.empty_like(oa)
        ptrs = [x.data_ptr() for x in (ha, hb, ma, mb, oa, ob)]
        ms = events_ms(launcher(kernels[SHIPPED], SHIPPED, ptrs, (Ba, Bb, TA, TB)), 100)
        print(f"[waves] (Ba, Bb, TA, TB)=({Ba}, {Bb}, {TA}, {TB}) D={D} {SHIPPED}: {ms:.6f} ms "
              f"({Bb / sms:.3f} blocks an SM) | {gpu}", flush=True)
        rows.append({"shape": [Ba, Bb, TA, TB, D], "blocks_per_sm": Bb / sms, "ms": ms})
    return rows


def rate_readings(probe: ctypes.CDLL, gpu: str) -> list:
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(2 * sms * 128, device="cuda")
    rows = []
    for mode, name in enumerate(RATE_MODES):
        for per_sm in (1, 2):
            tflops = probe.pct_probe_wgmma_rate(mode, per_sm * sms, 4000, out.data_ptr())
            if tflops < 0:
                raise RuntimeError(f"wgmma rate {name}: CUDA error")
            print(f"[rate] TF32 wgmma {name}, {per_sm} warpgroup(s) an SM: {tflops:.1f} TFLOP/s "
                  f"| {gpu}", flush=True)
            rows.append({"mode": name, "warpgroups_per_sm": per_sm, "tflops": tflops})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, help="write the readings as JSON here too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full f32
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(gpu, flush=True)
    probe, kernels = build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"gpu": gpu, "readings": readings(kernels, gen, gpu),
           "encode": encode_reading(probe, gen, gpu), "waves": wave_readings(kernels, gen, gpu),
           "rates": rate_readings(probe, gpu)}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
