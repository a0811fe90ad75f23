"""K1 and K5 of this checkout against another tree's, in one process.

    python -m protein_clip_tpu_torch.tools.ab_attention --base DIR [--out FILE]

``DIR`` is another tree of the repository, for example the parent commit
unpacked into a directory that ``.gitignore`` lists (``_parent/``)::

    mkdir -p _parent && git archive HEAD | tar -x -C _parent

Both trees' ``csrc/attention_fwd.cu`` and ``csrc/attention_bwd.cu`` are
built at once under ``_build/ab/`` (the base's C entry points may lack the
head-dim argument: they took head dim 32 alone before the kernels took
every ESM-2 head dim). Prints the card's name and power limit first, then
ptxas's registers and spills of each build's head-dim-32 kernels, then at
head dim 32 (t30_150M's NH 20), on four input sets that successive calls
cycle through so that they miss the 50 MB L2, in the order base, change,
change, base, base, change:

- K1 as serving calls it (no statistics) and with its statistics, and K5
  fed K1's statistics, each by ``timing.kernel_times`` over 200 calls
  (device time from ``torch.profiler``'s records, the records kept a call,
  CUDA events and the SM clock);

at (16, 512) padded and dense and at the finetune chunks' (16, 192) and
(16, 32) padded; and whether the two builds' outputs (K1's and its
statistics, K5's dq, dk, dv) are equal to the bit. ``--out`` writes every
reading as JSON too.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import itertools
import json
import subprocess
from pathlib import Path

import torch

from ..kernels import build
from ..ops import attention
from .probe_attention import inputs
from .timing import kernel_times

NH, DH = 20, 32
AB_DIR = build.BUILD_ROOT / "ab"
SHAPES = ((16, 512, "padded"), (16, 512, "dense"), (16, 192, "padded"), (16, 32, "padded"))
ORDER = ("base", "change", "change", "base", "base", "change")
KERNELS = ("attention_fwd", "attention_bwd")


def build_both(base: Path) -> dict:
    """{"base": {kernel: lib}, "change": {...}}, built at once."""
    jobs, libs = [], {}
    for name, csrc in (("base", base / "protein_clip_tpu_torch" / "csrc"),
                       ("change", build.CSRC_DIR)):
        for kernel in KERNELS:
            lib = AB_DIR / name / f"lib{kernel}.so"
            lib.unlink(missing_ok=True)
            libs.setdefault(name, {})[kernel] = lib
            jobs.append(([build._nvcc(), *build.NVCC_FLAGS, "-I", str(csrc)],
                         csrc / f"{kernel}.cu", lib))
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        reports = list(pool.map(lambda job: build.compile_library(*job), jobs))
    for (_, _, lib), report in zip(jobs, reports):
        print(f"[build] {lib.parent.name}/{lib.name}: {' | '.join(head_dim_32(report))}",
              flush=True)
    return libs


def head_dim_32(report: str) -> list[str]:
    """ptxas's registers and spills of the kernels built for head dim 32:
    the instantiations at 32, or every kernel of a build without templates."""
    out, keep = [], False
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            keep = "ILi32E" in name or "ILi" not in name
            out += [name] if keep else []
        elif keep and ("registers" in line or "spill" in line):
            out.append(line.replace("ptxas info    :", "").strip())
    return out


def takes_head_dim(csrc: Path) -> bool:
    """Whether K1's C entry point in this tree takes the head dim."""
    text = (csrc / "attention_fwd.cu").read_text()
    return "int head_dim" in text[text.index("pct_attention_fwd"):]


def bound(libs: dict, with_head_dim: bool) -> dict:
    """ops.attention's launchers for these libraries: the wrapper passes the
    head dim before the stream, which an entry point without it drops."""
    out = {}
    for kernel, lib in libs.items():
        fn = getattr(ctypes.CDLL(str(lib)), f"pct_{kernel}")
        ints = 4 if with_head_dim else 3
        fn.argtypes = ([ctypes.c_void_p] * attention._POINTERS[kernel] + [ctypes.c_int] * ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        out[kernel] = fn if with_head_dim else (lambda f: lambda *a: f(*a[:-2], a[-1]))(fn)
    return out


@contextlib.contextmanager
def launching(launchers: dict):
    saved = attention._launcher
    attention._launcher = lambda name: launchers[name]
    try:
        yield
    finally:
        attention._launcher = saved


def fmt(values: list[float]) -> str:
    return ", ".join(f"{v:.6f}" for v in values)


def readings(launchers: dict, gen: torch.Generator, gpu: str) -> list[dict]:
    rows = []
    for B, T, kind in SHAPES:
        sets = [inputs(B, T, kind, gen) for _ in range(4)]
        x = sets[0]
        outs, times = {}, {name: {"k1": [], "k1_lse": [], "k5": []} for name in launchers}
        for name in ORDER:
            with launching(launchers[name]):
                cycle = itertools.cycle(sets)

                def k1():
                    y = next(cycle)
                    attention.fused_attention(y["q"], y["k"], y["v"], y["seg"])

                def k1_lse():
                    y = next(cycle)
                    attention._forward(y["q"], y["k"], y["v"], y["seg"], with_lse=True)

                def k5():
                    y = next(cycle)
                    attention.fused_attention_bwd(y["q"], y["k"], y["v"], y["seg"], y["do"],
                                                  y["lse"])

                outs[name] = (attention._forward(x["q"], x["k"], x["v"], x["seg"], with_lse=True)
                              + attention.fused_attention_bwd(x["q"], x["k"], x["v"], x["seg"],
                                                              x["do"], x["lse"]))
                for key, fn in (("k1", k1), ("k1_lse", k1_lse), ("k5", k5)):
                    times[name][key].append(kernel_times(fn, 200))
        equal = all(torch.equal(a, b) for a, b in zip(outs["base"], outs["change"]))
        for name, t in times.items():
            k1, k1_lse, k5 = ({key: [r[key] for r in t[part]] for key in t[part][0]}
                              for part in ("k1", "k1_lse", "k5"))
            print(f"[ab] {name} B={B} T={T} NH={NH} DH={DH} {kind}, device time: K1 "
                  f"{fmt(k1['device_ms'])} ms (CUDA events {fmt(k1['events_ms'])}; with "
                  f"statistics {fmt(k1_lse['device_ms'])}); K5 {fmt(k5['device_ms'])} ms (CUDA "
                  f"events {fmt(k5['events_ms'])}); kernel records kept a call: K1 "
                  f"{k1['records']}, K5 {k5['records']}; SM clock {k5['clock_mhz']} MHz; outputs "
                  f"equal to the base's bit for bit: {equal} | {gpu}", flush=True)
            rows.append({"build": name, "shape": [B, T, NH, DH], "segments": kind, **t,
                         "bit_equal": equal})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path, required=True, help="another tree of the repository")
    ap.add_argument("--out", type=Path, help="write the readings as JSON here too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device")
        return 1
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(gpu, flush=True)
    libs = build_both(args.base.resolve())
    launchers = {"base": bound(libs["base"], takes_head_dim(args.base.resolve()
                                                            / "protein_clip_tpu_torch" / "csrc")),
                 "change": bound(libs["change"], True)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"gpu": gpu, "readings": readings(launchers, gen, gpu)}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
