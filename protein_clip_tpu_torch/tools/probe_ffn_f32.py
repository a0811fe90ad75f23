"""Readings of K6-f32's design on the card, in one process.

    python -m protein_clip_tpu_torch.tools.probe_ffn_f32 [--base DIR] [--out FILE]

Builds at once, under ``_build/probe_ffn_f32/``: the shipped K6-f32
(``csrc/ffn_gelu_f32.cu``: 3xTF32 on wgmma), the FFMA kernel it replaced
(``probe_ffn_f32_ffma.cu`` beside this file) and patched copies of
``csrc/`` (``VARIANTS``: the 64 x 64 tile in place of 64 x 32 below
``kLargeMinBlocks``; either tile at every shape; and three that show what
the time is made of: one TF32 product a k-step, wrong by design (the
error columns show it); the k-tiles' products accumulated in the wgmma
accumulator itself, with no f32 promotion; a partial promoted every k-step
or every two; W loaded 64 floats a thread ahead at every tile, or one
k-tile ahead at every tile). Prints the card's
name and power limit first, then ptxas's registers and spills of each
build, then, all f32 with TF32 off, at t30_150M's wi for 32 sequences
(10240, 640, 2560), at 128 tokens through t30_150M's three layer shapes
and at each ESM-2 family's wi for 3072 tokens:

- each build's device time (``timing.kernel_times``; four input sets that
  successive calls cycle through, so that calls miss the 50 MB L2) beside
  ``torch.addmm`` + gelu (two calls: no single PyTorch call computes the
  function) and the 3xTF32 bound (495 TFLOP/s, 3.35 TB/s);
- each build's largest error against the plain version in rms(ref) units,
  and its ratio to chip_smoke.py's limit (2^-12 rms(ref) + 2^-12 |ref|).

With ``--base DIR`` (another tree of the repository, for example the
parent commit unpacked into ``_parent/``: ``mkdir -p _parent && git
archive HEAD | tar -x -C _parent``), also P1 (``dense_mm``: s8 and bf16)
and bf16 K6 (``ffn_gelu``) of both trees, timed in the order base,
change, change, base at (10240, 640, 2560) and (128, 640, 2560), with
whether the two builds' outputs are equal to the bit. ``--out`` writes
every reading as JSON too.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import itertools
import json
import shutil
import subprocess
from pathlib import Path

import torch

from ..kernels import build
from ..ops import dense_mm, ffn
from .timing import kernel_times

TOOLS = Path(__file__).resolve().parent
PROBE_DIR = build.BUILD_ROOT / "probe_ffn_f32"
H100_TF32_FLOPS, H100_BYTES_PER_S = 495e12, 3.35e12
LIMIT = 2 ** -12   # chip_smoke.F32_ATOL_RMS and F32_RTOL
AHEAD = "  static constexpr int kAhead = BN == 128 ? 1 : 256 / BN;"
# (patched file, line, patched line) of each variant build of csrc/
VARIANTS = {
    "small_64x64": [("mma_gemm.cuh", "  using S = Config<32, 1>;", "  using S = Config<64, 1>;")],
    "large_always": [("mma_gemm.cuh", "  if (large_blocks < kLargeMinBlocks) {",
                      "  if (large_blocks < 0) {")],
    "small_always": [("mma_gemm.cuh", "  if (large_blocks < kLargeMinBlocks) {", "  if (true) {")],
    "one_product": [("mma_gemm.cuh", "constexpr int kProducts = 3;", "constexpr int kProducts = 1;")],
    "no_promotion": [
        ("mma_gemm.cuh", "        wgmma_tf32_n(part, hi[ks], dh[ks], kProducts > 1 || ks > k0);",
         "        wgmma_tf32_n(acc, hi[ks], dh[ks], 1);"),
        ("mma_gemm.cuh", "          wgmma_tf32_n(part, hi[ks], dl[ks], ks > k0);",
         "          wgmma_tf32_n(acc, hi[ks], dl[ks], 1);"),
        ("mma_gemm.cuh", "          wgmma_tf32_n(part, lo[ks], dh[ks], 1);",
         "          wgmma_tf32_n(acc, lo[ks], dh[ks], 1);"),
        ("mma_gemm.cuh", "      for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];",
         "      for (int i = 0; i < 0; ++i) acc[i] += part[i];"),
        ("mma_gemm.cuh", "      fence_operands(part);\n      wgmma_fence();",
         "      fence_operands(acc);\n      wgmma_fence();")],
    "promote_1": [("mma_gemm.cuh", "constexpr int kPromote = 4;", "constexpr int kPromote = 1;")],
    "promote_2": [("mma_gemm.cuh", "constexpr int kPromote = 4;", "constexpr int kPromote = 2;")],
    "hi_hi_first": [
        ("mma_gemm.cuh", "          wgmma_tf32_n(part, hi[ks], dl[ks], ks > k0);",
         "          wgmma_tf32_n(part, hi[ks], dl[ks], 1);"),
        ("mma_gemm.cuh", "      for (int ks = k0; ks < k0 + kPromote; ++ks) {\n        if (kProducts",
         "      for (int ks = k0; ks < 0; ++ks) {\n        if (kProducts"),
        ("mma_gemm.cuh", "        wgmma_tf32_n(part, hi[ks], dh[ks], kProducts > 1 || ks > k0);",
         "        wgmma_tf32_n(part, hi[ks], dh[ks], ks > k0);\n        if (kProducts > 1) {\n"
         "          wgmma_tf32_n(part, hi[ks], dl[ks], 1);\n"
         "          wgmma_tf32_n(part, lo[ks], dh[ks], 1);\n        }")],
    "ahead_64_floats": [("mma_gemm.cuh", AHEAD, "  static constexpr int kAhead = 256 / BN;")],
    "ahead_1": [("mma_gemm.cuh", AHEAD, "  static constexpr int kAhead = 1;")],
}
SHIPPED = "shipped"
WI = (10240, 640, 2560)
SHORT = tuple((128, k, m) for k, m in ((640, 640), (640, 2560), (2560, 640)))
FAMILY_WI = tuple((3072, h, 4 * h) for h in (320, 480, 640, 1280, 2560, 5120))
AB_SHAPES = ((10240, 640, 2560), (128, 640, 2560))
AB_ORDER = ("base", "change", "change", "base")


def gpu_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def compile_all(jobs: list) -> None:
    """Compile (cmd, src, lib) jobs at once, afresh; print each build's
    registers and spills."""
    for _, _, lib in jobs:
        lib.unlink(missing_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        reports = list(pool.map(lambda job: build.compile_library(*job), jobs))
    for (_, _, lib), report in zip(jobs, reports):
        regs = [ln.replace("ptxas info    :", "").strip() for ln in report.splitlines()
                if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        print(f"[build] {lib.parent.name}/{lib.name}: {' | '.join(regs)}", flush=True)


def patched_csrc(name: str, patches: list, root: Path = PROBE_DIR) -> Path:
    """A copy of csrc/ under root/name/ with each (file, line, patched line)
    of ``patches`` applied; a line not in its file once raises."""
    src = root / name / "csrc"
    shutil.rmtree(src.parent, ignore_errors=True)
    shutil.copytree(build.CSRC_DIR, src)
    for file, line, patched in patches:
        text = (src / file).read_text()
        if text.count(line) != 1:
            raise RuntimeError(f"variant {name}: its line is not in csrc/{file} once")
        (src / file).write_text(text.replace(line, patched))
    return src


def k6_f32_builds() -> tuple[list, dict]:
    """The jobs and, once built, {name: (library path, entry point name)}."""
    jobs, libs = [], {}
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR)]
    for name, src, entry in ((SHIPPED, build.CSRC_DIR / "ffn_gelu_f32.cu", "pct_ffn_gelu_f32"),
                             ("ffma", TOOLS / "probe_ffn_f32_ffma.cu",
                              "pct_probe_ffn_gelu_f32_ffma")):
        lib = PROBE_DIR / name / f"lib{src.stem}.so"
        jobs.append((cmd, src, lib))
        libs[name] = (lib, entry)
    for name, patches in VARIANTS.items():
        src = patched_csrc(name, patches)
        lib = src.parent / "libffn_gelu_f32.so"
        jobs.append(([build._nvcc(), *build.NVCC_FLAGS, "-I", str(src)], src / "ffn_gelu_f32.cu",
                     lib))
        libs[name] = (lib, "pct_ffn_gelu_f32")
    return jobs, libs


def bind(lib: Path, entry: str):
    fn = getattr(ctypes.CDLL(str(lib)), entry)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def call(fn, x, w, b, mode: int = 0) -> torch.Tensor:
    out = torch.empty(x.shape[0], w.shape[1], dtype=x.dtype, device=x.device)
    err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
             w.shape[1], mode, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: cudaError_t {err}")
    return out


def f32_inputs(N: int, H: int, M: int, gen: torch.Generator):
    """x, W at unit output scale, a bias of half that scale (as
    chip_smoke.ffn_f32_inputs)."""
    return (torch.randn(N, H, generator=gen, device="cuda"),
            torch.randn(H, M, generator=gen, device="cuda") / H ** 0.5,
            0.5 * torch.randn(M, generator=gen, device="cuda"))


def bound_ms(N: int, H: int, M: int) -> float:
    flops = 2 * N * H * M
    nbytes = 4 * (N * H + H * M + M + N * M)
    return 1e3 * max(3 * flops / H100_TF32_FLOPS, nbytes / H100_BYTES_PER_S)


def k6_f32_readings(kernels: dict, gen: torch.Generator, gpu: str) -> list[dict]:
    rows = []
    for N, H, M in (WI, *SHORT, *FAMILY_WI):
        sets = [f32_inputs(N, H, M, gen) for _ in range(4)]
        x, w, b = sets[0]
        ref = ffn.dense_gelu_reference(x, w, b, "erf")
        rms = float(ref.square().mean().sqrt())
        row = {"shape": [N, H, M], "bound_ms": bound_ms(N, H, M), "builds": {}}
        iters = 50 if N * H * M <= 1 << 30 else 20
        for name, fn in kernels.items():
            got = call(fn, x, w, b)
            err = (got - ref).abs()
            cycle = itertools.cycle(sets)
            t = kernel_times(lambda: call(fn, *next(cycle)), iters)
            row["builds"][name] = {
                "ms": t["device_ms"], "events_ms": t["events_ms"], "clock_mhz": t["clock_mhz"],
                "rel_rms": float(err.max()) / rms,
                "ratio": float((err / (LIMIT * rms + LIMIT * ref.abs())).max())}
        cycle = itertools.cycle(sets)

        def two_calls():
            xx, ww, bb = next(cycle)
            torch.nn.functional.gelu(torch.addmm(bb, xx, ww))

        row["addmm_gelu_ms"] = kernel_times(two_calls, iters)["device_ms"]
        print(f"[k6_f32] {(N, H, M)} erf, device time | {gpu}: "
              + "; ".join(f"{name} {r['ms']:.6f} ms ({r['rel_rms']:.3g} rms(ref), "
                          f"{r['ratio']:.3g} x the limit)" for name, r in row["builds"].items())
              + f"; torch.addmm + gelu (f32, TF32 off) {row['addmm_gelu_ms']:.6f} ms; 3xTF32 "
              f"bound {row['bound_ms']:.6f} ms", flush=True)
        rows.append(row)
        del sets, x, w, b, ref
    return rows


def ab_builds(base: Path) -> tuple[list, dict]:
    jobs, libs = [], {}
    for name, csrc in (("base", base / "protein_clip_tpu_torch" / "csrc"),
                       ("change", build.CSRC_DIR)):
        for kernel in ("dense_mm", "ffn_gelu"):
            lib = PROBE_DIR / "ab" / name / f"lib{kernel}.so"
            jobs.append(([build._nvcc(), *build.NVCC_FLAGS, "-I", str(csrc)],
                         csrc / f"{kernel}.cu", lib))
            libs.setdefault(name, {})[kernel] = lib
    return jobs, libs


def ab_readings(libs: dict, gen: torch.Generator, gpu: str) -> list[dict]:
    """P1 (s8, bf16) and bf16 K6 of both trees, in AB_ORDER."""
    bound = {name: {"dense_mm": dense_mm.bind(ctypes.CDLL(str(lib["dense_mm"]))),
                    "ffn_gelu": ffn.bind(ctypes.CDLL(str(lib["ffn_gelu"])), "ffn_gelu")}
             for name, lib in libs.items()}
    rows = []
    for N, K, M in AB_SHAPES:
        s8 = [(torch.randint(-128, 128, (N, K), generator=gen, device="cuda", dtype=torch.int8),
               torch.randint(-128, 128, (K, M), generator=gen, device="cuda", dtype=torch.int8))
              for _ in range(4)]
        bf = [(torch.randn(N, K, generator=gen, device="cuda").bfloat16(),
               (torch.randn(K, M, generator=gen, device="cuda") / K ** 0.5).bfloat16(),
               (0.5 * torch.randn(M, generator=gen, device="cuda")).bfloat16()) for _ in range(4)]
        cases = {
            "dense_mm_s8": (s8, lambda fns, a: _mm(fns["dense_mm"][torch.int8], *a,
                                                   torch.int32)),
            "dense_mm_bf16": (bf, lambda fns, a: _mm(fns["dense_mm"][torch.bfloat16], a[0],
                                                     a[1], torch.float32)),
            "ffn_gelu": (bf, lambda fns, a: call(fns["ffn_gelu"], *a)),
        }
        for key, (sets, run) in cases.items():
            times = {"base": [], "change": []}
            outs = {name: run(bound[name], sets[0]) for name in bound}
            for name in AB_ORDER:
                cycle = itertools.cycle(sets)
                times[name].append(kernel_times(lambda: run(bound[name], next(cycle)),
                                                50)["device_ms"])
            equal = torch.equal(outs["base"], outs["change"])
            mean = {name: sum(v) / len(v) for name, v in times.items()}
            print(f"[ab] {key} {(N, K, M)}, device time (base, change, change, base): "
                  f"base {', '.join(f'{v:.6f}' for v in times['base'])} ms, change "
                  f"{', '.join(f'{v:.6f}' for v in times['change'])} ms; change / base "
                  f"{mean['change'] / mean['base']:.4f}; outputs equal to the bit: {equal} | "
                  f"{gpu}", flush=True)
            rows.append({"kernel": key, "shape": [N, K, M], **times,
                         "change_over_base": mean["change"] / mean["base"], "bit_equal": equal})
    return rows


def _mm(fns: dict, x, w, out_dtype) -> torch.Tensor:
    out = torch.empty(x.shape[0], w.shape[1], dtype=out_dtype, device=x.device)
    err = fns(x.data_ptr(), w.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], w.shape[1],
              torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: cudaError_t {err}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path, help="another tree of the repository (A/B of P1, K6)")
    ap.add_argument("--out", type=Path, help="write the readings as JSON here too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = gpu_line()
    print(gpu, flush=True)
    jobs, libs = k6_f32_builds()
    ab_libs = {}
    if args.base:
        ab_jobs, ab_libs = ab_builds(args.base.resolve())
        jobs += ab_jobs
    compile_all(jobs)
    kernels = {name: bind(lib, entry) for name, (lib, entry) in libs.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"gpu": gpu, "k6_f32": k6_f32_readings(kernels, gen, gpu)}
    if ab_libs:
        out["ab"] = ab_readings(ab_libs, gen, gpu)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
