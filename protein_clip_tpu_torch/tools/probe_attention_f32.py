"""Readings of K1-f32's and K5-f32's design on the card, in one process.

    python -m protein_clip_tpu_torch.tools.probe_attention_f32 [--out FILE]

Run from the repository's root: it takes its shapes, segments and bounds
from ``chip_smoke.py`` (``path_segments`` writes the training fixtures
under ``_smoke_work/``, removed at the end). Builds at once, under
``_build/probe_attention_f32/``: the shipped K1-f32 and K5-f32
(``csrc/attention_fwd_f32.cu``, ``csrc/attention_bwd_f32.cu``: 3xTF32 on
wgmma), the FFMA kernels they replaced (``probe_attention_f32_ffma.cu``
beside this file), and patched copies of ``csrc/`` (``VARIANTS``): one
TF32 product a k-step (``kProducts`` 1: wrong by design, what the two
correction products cost); one consumer warpgroup a block at every shape
(``one_warpgroup``: what two give where the kernels take two); rings of at
most two or four stages in place of three (``two_stages``,
``four_stages``; a ring is as deep as fits beside the block's other shared
memory); and, wrong by design, builds that show what the time is made of
(``no_loads``, ``no_stores``, ``no_value_products``, ``no_score_products``
and ``fixed_work``, all three left out). Prints the card's name and power
limit first, then ptxas's registers and spills of each build, then, all
f32 with TF32 off, at t30_150M's (16, 512, NH 20, DH 32) padded and dense,
the finetune chunks' (16, 192) and (16, 32) padded, the packed paths'
(16, 256) and (28, 2048) chunks (``chip_smoke.path_segments``) and each
other family's attention shape padded (``chip_smoke.FAMILY_SHAPES``):

- each build's device time of K1-f32 (no statistics, as serving calls it)
  and of K5-f32 (fed the shipped K1-f32's output and statistics), by
  ``timing.kernel_times`` over two input sets that successive calls cycle
  through (each past the 50 MB L2 at (16, 512)), in the order shipped,
  ffma, the variants, shipped;
- ``scaled_dot_product_attention`` on the same f32 inputs and boolean mask,
  forward and backward (the library's time: no single call computes K5's
  function from K1's statistics, SDPA's backward recomputes its own);
- the bound on the run's segments (``chip_smoke.f32_attention_bound``:
  3xTF32 products of the allowed pairs at 495 TFLOP/s, bytes at 3.35 TB/s);
- each build's largest error against the plain versions in rms(ref) units
  (the least passing atol of chip_smoke.py's form, whose limit is 2^-12).

``--out`` writes every reading as JSON too.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import shutil
import sys
from pathlib import Path

import torch

from ..kernels import build
from ..ops import attention
from .ab_attention import launching
from .probe_ffn_f32 import compile_all, gpu_line, patched_csrc
from .timing import kernel_times

TOOLS = Path(__file__).resolve().parent
PROBE_DIR = build.BUILD_ROOT / "probe_attention_f32"
KERNELS = ("attention_fwd_f32", "attention_bwd_f32")
# (patched file, line, patched line) of each variant build of csrc/
VARIANTS = {
    "one_product": [("attention_f32.cuh", "constexpr int kProducts = 3;",
                     "constexpr int kProducts = 1;")],
    "one_warpgroup": [
        ("attention_fwd_f32.cu", "constexpr int kWGS = 2;", "constexpr int kWGS = 1;"),
        ("attention_bwd_f32.cu", "constexpr int kWGS = HD <= 32 ? 2 : 1;",
         "constexpr int kWGS = 1;")],
    "two_stages": [("attention_f32.cuh", "constexpr int kMaxStages = 3;",
                    "constexpr int kMaxStages = 2;")],
    "four_stages": [("attention_f32.cuh", "constexpr int kMaxStages = 3;",
                     "constexpr int kMaxStages = 4;")],
}
# Wrong by design, what the time is made of: the producer's global loads
# replaced by zeros; its split stores left out (and so its loads); the
# value products (O += P.V, dq, dk, dv) left out; the score products
# (S, dP and their transposes) replaced by zeros; all three: what is left
# is the blocks' fixed work and the elementwise work between the products.
NO_STORES = [("attention_f32.cuh",
               f"        if constexpr (St::{w}) {f}(s{t}[x], st + St::k{k}_, p);", "")
             for w, f, t, k in (("nat_a", "store_natural", "a", "NatA"),
                                ("trans_a", "store_transposed", "a", "TransA"),
                                ("nat_b", "store_natural", "b", "NatB"),
                                ("trans_b", "store_transposed", "b", "TransB"))]
NO_VALUE_PRODUCTS = [
    ("attention_fwd_f32.cu",
     "        accumulate<DW, KS>(acc, p, st + St::kTransB_);  // O += P . V", ""),
    ("attention_bwd_f32.cu",
     "        accumulate<DW, KS>(acc, dp, st + St::kTransA_);  // dq += dS . k", ""),
    ("attention_bwd_f32.cu",
     "        accumulate<DW, KS>(dv_acc, p, st + St::kTransB_);   // dv += P^T . dO", ""),
    ("attention_bwd_f32.cu",
     "        accumulate<DW, KS>(dk_acc, ds, st + St::kTransA_);  // dk += dS^T . q", "")]
NO_SCORE_PRODUCTS = [
    (file, f"        scores<DW, KS>({x}, {a}, st + St::k{b}_);{c}",
     f"        for (int i = 0; i < KS / 2; ++i) {x}[i] = 0.f;")
    for file, x, a, b, c in (
        ("attention_fwd_f32.cu", "p", "q_tile", "NatA", ""),
        ("attention_bwd_f32.cu", "s", "q_tile", "NatA", "    // q . k^T, as K1-f32 computes it"),
        ("attention_bwd_f32.cu", "dp", "do_tile", "NatB", "  // dO . v^T"),
        ("attention_bwd_f32.cu", "p", "k_tile", "NatA", "   // k . q^T"),
        ("attention_bwd_f32.cu", "ds", "v_tile", "NatB", "  // v . dO^T"))]
VARIANTS.update({
    "no_loads": [("attention_f32.cuh", "      s.v[i][e] = t0 + n < T && 4 * c < HD",
                  "      s.v[i][e] = t0 + n < 0 && 4 * c < HD")],
    "no_stores": NO_STORES, "no_value_products": NO_VALUE_PRODUCTS,
    "no_score_products": NO_SCORE_PRODUCTS,
    "fixed_work": NO_STORES + NO_VALUE_PRODUCTS + NO_SCORE_PRODUCTS})
ORDER = ("shipped", "ffma", *VARIANTS, "shipped")


def builds() -> tuple[list, dict]:
    """The compile jobs and {build: {kernel name: (library, entry point)}}."""
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR)]
    sources = [("shipped", build.CSRC_DIR)]
    sources += [(name, patched_csrc(name, patches, PROBE_DIR))
                for name, patches in VARIANTS.items()]
    jobs, libs = [], {name: {} for name in ("ffma", *dict(sources))}
    for name, csrc in sources:
        for kernel in KERNELS:
            lib = PROBE_DIR / name / f"lib{kernel}.so"
            jobs.append(([build._nvcc(), *build.NVCC_FLAGS, "-I", str(csrc)],
                         csrc / f"{kernel}.cu", lib))
            libs[name][kernel] = (lib, f"pct_{kernel}")
    lib = PROBE_DIR / "ffma" / "libprobe_attention_f32_ffma.so"
    jobs.append((cmd, TOOLS / "probe_attention_f32_ffma.cu", lib))
    libs["ffma"] = {kernel: (lib, f"pct_probe_{kernel}_ffma") for kernel in KERNELS}
    return jobs, libs


def launchers(libs: dict) -> dict:
    """{build: {kernel name: entry point}}, bound as ops.attention binds."""
    out = {}
    for name, by_kernel in libs.items():
        out[name] = {}
        for kernel, (lib, entry) in by_kernel.items():
            fn = getattr(ctypes.CDLL(str(lib)), entry)
            fn.argtypes = ([ctypes.c_void_p] * attention._POINTERS[kernel] + [ctypes.c_int] * 4
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            out[name][kernel] = fn
    return out


def shapes(cs) -> list[tuple[str, torch.Tensor, int, int]]:
    """(kind, segments, NH, DH) of every shape timed."""
    out = [("padded", cs.padded_segments(16, 512), cs.NH, cs.DH),
           ("dense", cs.dense_segments(16, 512), cs.NH, cs.DH),
           ("padded, finetune chunk", cs.padded_segments(16, 192), cs.NH, cs.DH),
           ("padded, finetune chunk", cs.padded_segments(16, 32), cs.NH, cs.DH)]
    out += [(kind, seg, cs.NH, cs.DH) for kind, _, seg in cs.path_segments()
            if tuple(seg.shape) in ((16, 256), (28, 2048))]
    out += [("padded", cs.padded_segments(B, T), nh, dh) for B, T, nh, dh in cs.FAMILY_SHAPES]
    return out


def readings(cs, fns: dict, gen: torch.Generator, gpu: str) -> list[dict]:
    rows = []
    for kind, seg, nh, dh in shapes(cs):
        B, T = seg.shape
        allowed = (seg[:, None, :, None] == seg[:, None, None, :]) & (seg[:, None, None, :] > 0)
        sets = []
        with launching(fns["shipped"]):
            for _ in range(2):
                q, k, v = cs.qkv(B, T, gen, nh, dh, torch.float32)
                do = torch.randn(B, T, nh, dh, device="cuda", generator=gen)
                out, lse = attention._forward(q, k, v, seg, with_lse=True)
                sets.append((q, k, v, do, out, lse))
        q, k, v, do = sets[0][:4]
        want_fwd = cs.by_rows(attention.attention_reference, q, k, v, seg)
        want_bwd = cs.by_rows(attention.attention_reference_bwd, q, k, v, seg, do)
        iters = 50 if B * T * T * nh <= 16 * 512 * 512 * 20 else 10
        row = {"shape": [B, T, nh, dh], "segments": kind, "builds": {}}
        for name in ORDER:
            with launching(fns[name]):
                got = attention._forward(q, k, v, seg)
                got_bwd = attention.fused_attention_bwd(q, k, v, seg, do, sets[0][5], sets[0][4])
                torch.cuda.synchronize()
                cycle = itertools.cycle(sets)
                fwd_t = kernel_times(lambda: attention._forward(*next(cycle)[:3], seg), iters)

                def k5():
                    x = next(cycle)
                    attention.fused_attention_bwd(x[0], x[1], x[2], seg, x[3], x[5], x[4])

                bwd_t = kernel_times(k5, iters)
            reading = {
                "fwd_ms": fwd_t["device_ms"], "fwd_events_ms": fwd_t["events_ms"],
                "bwd_ms": bwd_t["device_ms"], "bwd_events_ms": bwd_t["events_ms"],
                "records": [fwd_t["records"], bwd_t["records"]], "clock_mhz": bwd_t["clock_mhz"],
                "fwd_need": cs.least_atol(got, want_fwd, cs.F32_RTOL)[1],
                "bwd_need": max(cs.least_atol(g, w, cs.F32_RTOL)[1]
                                for g, w in zip(got_bwd, want_bwd)),
                "bwd_need_by_output": dict(zip(("dq", "dk", "dv"), (
                    cs.least_atol(g, w, cs.F32_RTOL)[1] for g, w in zip(got_bwd, want_bwd))))}
            row["builds"].setdefault(name, []).append(reading)
        cycle = itertools.cycle(sets)

        def sdpa():
            x = next(cycle)
            torch.nn.functional.scaled_dot_product_attention(
                *(t.transpose(1, 2) for t in x[:3]), attn_mask=allowed, scale=1.0)

        leaves = [tuple(t.transpose(1, 2).detach().requires_grad_(True) for t in x[:3])
                  for x in sets]
        outs = [torch.nn.functional.scaled_dot_product_attention(*lq, attn_mask=allowed,
                                                                 scale=1.0) for lq in leaves]
        graphs = itertools.cycle(list(zip(outs, leaves, (x[3].transpose(1, 2) for x in sets))))

        def sdpa_bwd():
            o, lq, g = next(graphs)
            torch.autograd.grad(o, lq, g, retain_graph=True)

        row["sdpa_ms"] = kernel_times(sdpa, iters)["device_ms"]
        row["sdpa_bwd_ms"] = kernel_times(sdpa_bwd, iters)["device_ms"]
        fwd_b, bwd_b = (cs.f32_attention_bound(seg, back, nh, dh) for back in (False, True))
        row["fwd_bound_ms"], row["bwd_bound_ms"] = fwd_b["bound_ms"], bwd_b["bound_ms"]
        row["bound_by"] = [fwd_b["bound_by"], bwd_b["bound_by"]]
        row["allowed_share"] = fwd_b["allowed_share"]
        for name, reads in row["builds"].items():
            print(f"[attention_f32] {name} B={B} T={T} NH={nh} DH={dh} {kind}: K1-f32 "
                  + ", ".join(f"{r['fwd_ms']:.6f}" for r in reads) + " ms, K5-f32 "
                  + ", ".join(f"{r['bwd_ms']:.6f}" for r in reads) + " ms (device time; "
                  f"records kept a call {reads[0]['records']}, SM clock "
                  f"{reads[0]['clock_mhz']} MHz); least passing atol K1 "
                  f"{reads[0]['fwd_need']:.4g}, K5 {reads[0]['bwd_need']:.4g} rms(ref) "
                  f"(dq, dk, dv: " + ", ".join(f"{v:.4g}" for v in
                                               reads[0]["bwd_need_by_output"].values())
                  + f"; limit {cs.F32_ATOL_RMS:g}) | {gpu}", flush=True)
        print(f"[attention_f32] B={B} T={T} NH={nh} DH={dh} {kind}: SDPA f32 (TF32 off) "
              f"{row['sdpa_ms']:.6f} ms forward, {row['sdpa_bwd_ms']:.6f} ms backward; bound "
              f"{row['fwd_bound_ms']:.6f} / {row['bwd_bound_ms']:.6f} ms ({row['bound_by']}; "
              f"allowed pairs {row['allowed_share']:.4f} of T^2) | {gpu}", flush=True)
        rows.append(row)
        del sets, want_fwd, want_bwd, leaves, outs, graphs
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None, help="write every reading as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_attention_f32 needs a CUDA card; none is visible", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs

    gpu = gpu_line()
    print(f"[probe] {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    jobs, libs = builds()
    compile_all(jobs)
    fns = launchers(libs)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    try:
        rows = readings(cs, fns, gen, gpu)
    finally:
        shutil.rmtree(cs.WORK, ignore_errors=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"gpu": gpu, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
