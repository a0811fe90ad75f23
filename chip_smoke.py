#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one GPU and
hold every hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, in order; a failure in any of them ends the run with a traceback
and a nonzero exit code, and no result line:

1. build        compile every kernel under protein_clip_tpu_torch/csrc/ with
                nvcc for sm_90a, one nvcc per source, all at once; print the
                card's name and power limit.
2. kernels      K1 (segment-masked attention forward) against
                ops.attention.attention_reference at the serving shapes
                (NH=20, dh=32, bf16), with padded rows (fully padded query
                rows included) and packed rows (several segments, gap
                zeros). K4 (FILIP masked max-sim) against
                ops.filip.maxsim_reference at the scorer's shapes (D=128,
                f32), with padded masks, an all-masked a-row and b-row, and
                token counts that are not multiples of 64. K2 and K3
                (InfoNCE, forward and backward through autograd) against
                ops.infonce.clip_infonce: unit rows scaled by exp(t/2) for
                t in {1, 4}, K2 at B in {16, 100, 256, 512}, K3 at B in
                {1000, 1024, 2048, 4096}, D=128, and each at D=64 once.
                K5 (segment-masked attention backward) against
                ops.attention.attention_reference_bwd at the finetune
                chunks' shapes (16 rows at the pep and rec buckets 32 and
                192), at K1's timing shape and at odd T, NH=20, bf16, with
                padded, fully padded and packed rows.
3. serve        ESM-2 t30_150M in bf16 with seeded random weights and CLIP
                heads, written as npz; an index of 256 synthetic sequences
                built with cli.embed; cli.serve's server on an ephemeral port
                answers /healthz, single-sequence /embed at the
                64/128/512/2048 buckets on both sides, a 32-sequence /embed,
                the binary wire, /topk and 16 concurrent clients. The K1
                launch count must be 30 per backbone forward.
4. e2e          the served embeddings against the same sequences encoded
                with attention_impl="eager": cosine >= 0.999 per row.
5. filip serve  FILIP heads (seeded, written as npz) over the same backbone:
                a ragged index of 256 sequences built with cli.embed --filip;
                cli.serve --filip answers /healthz, JSON and binary /embed
                (with its length prefix) and /topk, whose scores and order
                are held against the plain max-sim on the card;
                cli.retrieve --filip returns /topk's hits, and cli.retrieve
                in CLIP mode runs against phase 3's index. K4 launches once
                per (64-query, 1024-candidate) block of each scorer call; K1
                30 times per backbone forward.
6. filip e2e    the served token embeddings against the same sequences
                encoded with attention_impl="eager": cosine >= 0.99 for
                every valid token.
7. train        cli.main twice on one synthetic fixture of 3000 families
                (written and clustered once), t30_150M bf16 with seeded
                random weights, one epoch: the defaults (16 x 16 = global
                batch 256 in 4 length groups, 16 chunks: K2) and
                --batch-size 64 (global batch 1024: K3). Each run must write
                losses_per_epoch.txt (finite), metrics.jsonl and
                best_model.npz; K1 launches 30 times per backbone forward
                (32 forwards per step, 8 per eval batch); K2 and K3 once
                forward and once backward per step and once forward per eval
                batch, each on its own pools. cli.embed then embeds with run
                1's best_model.npz. Then the unfrozen modes on the same
                fixture: cli.main --finetune and cli.main --lora-rank 8 at
                the defaults (global batch 256 in one pad bucket, 16 chunks,
                remat, two learning rates), one epoch each, with the same
                artifact checks; per step K1 launches 30 times per pass-1
                forward and 60 per pass-2 chunk (forward and remat
                recompute), K5 30 times per pass-2 chunk, K2 once forward and
                once backward; per eval batch K1 60 times and K2 once.
                cli.embed embeds with each run's best_model.npz (the
                finetuned backbone; the adapters merged into the base).
8. step check   one default train step with K2 and one with the plain loss
                from the same heads and batch (dropout 0, Adam lr 1e-3), at
                256 and, with K3, at 1024: loss within 1e-5 relative,
                gradients within 1e-5 of each leaf's largest, parameters
                within the bound Adam's first update puts on them. One
                finetune step at 256 (dropout 0) from the same weights and
                batch through K1/K5, through their plain versions in the
                same autograd Function, through each kernel with the other's
                plain version, through a K5 that drops the last query tile
                of its dk/dv loop (a planted fault), and with
                attention_impl="eager" in bf16 and f32. Every leaf of the
                K1/K5 step within FT_K5_TOL of its largest entry of the
                step through K1 and K5's plain version, the loss within
                FT_LOSS_TOL, and the planted fault past that; against the
                eager step, per leaf within
                twice the eager step's distance from the f32 step plus 1e-2
                of the leaf's largest entry (check_finetune_step says why).
9. times        K1, its plain version and torch's
                scaled_dot_product_attention at B=16, T=512, NH=20 beside
                K1's bound; K4 and its plain version at the /topk and full
                scorer-block shapes beside K4's bound; /embed p50 for one
                sequence, and the same encode called without HTTP; seqs/s
                at batch 32; FILIP /topk p50 for one query, and its parts
                called without HTTP. K2 forward+backward at (256, 128), K3
                at (1024, 128) and (4096, 128), and their plain versions,
                beside the bound; K2 and K3 side by side at B in {16, 128,
                256, 384, 512, 1024, 2048}, the readings behind the dispatch rule; the
                train step in pairs/s at global batch 256 (median over the
                steps after the first of run 1, by CUDA events recorded
                after each step, with no sync inside the epoch), and the same
                for the finetune and LoRA runs. K5, its plain version and the
                backward of torch's scaled_dot_product_attention at B=16,
                T=512, NH=20 and at the finetune chunks' shapes, beside K5's
                bound.

The last three lines of standard output are the card's name and power
limit, the kernels line (one JSON object per hand-written kernel) and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import itertools
import json
import math
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

from protein_clip_tpu_torch.cli import common, embed, main as train_cli, retrieve, serve
from protein_clip_tpu_torch.data import dataset
from protein_clip_tpu_torch.data.fasta import sequences_only
from protein_clip_tpu_torch.data.synthetic import write_fixture
from protein_clip_tpu_torch.eval import retrieval
from protein_clip_tpu_torch.kernels import build
from protein_clip_tpu_torch.models import clip, esm2, filip
from protein_clip_tpu_torch.ops import attention, infonce
from protein_clip_tpu_torch.ops import filip as maxsim
from protein_clip_tpu_torch.train import checkpoint, clip_engine, finetune, lora, optimizer
from protein_clip_tpu_torch.train.checkpoint import export_npz

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "_smoke_work"
SEED = 0
NH, DH = 20, 32                       # t30_150M attention
KERNEL_SHAPES = ((1, 64), (16, 128), (16, 512), (4, 2048))
# K1 vs its plain version, both bf16 out: |err| <= ATOL_RMS * rms(ref) +
# RTOL * |ref|. The kernel normalises after P.V and the plain version before
# the bf16 cast of P, so they differ by bf16 rounding of P (the absolute
# term, which shrinks with the output's scale as T grows) and of the output
# (a bf16 ulp is 2^-7 relative, within RTOL). Emulating the kernel's
# rounding on the CPU at these shapes needs an absolute term of 0.016-0.019
# rms(ref); a kernel that drops the last key tile needs 2.4 rms(ref) or more.
ATOL_RMS, RTOL = 2 ** -5, 2e-2
COSINE_MIN = 0.999
# K4 against its plain version, both f32: the same products summed in
# another order, in means of maxima of unit-vector dot products (|x| <= 1).
K4_ATOL = 2e-5
K4_SHAPES = ((1, 256, 128, 512), (4, 256, 320, 512), (16, 64, 32, 2048),
             (64, 1024, 256, 192), (5, 300, 77, 333))    # (Ba, Bb, TA, TB)
K4_TIME_SHAPES = ((4, 256, 128, 512), (64, 1024, 256, 256))
FILIP_D = 128
FILIP_COSINE_MIN = 0.99
H100_BF16_FLOPS = 989e12              # dense tensor-core peak, SXM, 700 W
H100_F32_FLOPS = 67e12                # f32 on the CUDA cores (no tensor cores), SXM
H100_BYTES_PER_S = 3.35e12
KERNELS = ("attention_fwd", "attention_bwd", "filip_maxsim", "infonce")
# K2/K3 against their plain version, both f32 (FFMA against cuBLAS f32 and
# logsumexp: the same sums in another order, over up to 4096 terms):
# |loss - ref| <= 1e-5 max(1, |ref|), |grad - ref| <= 1e-5 max|ref|.
INFONCE_RTOL = 1e-5
K2_POOLS, K3_POOLS = (16, 100, 256, 512), (1000, 1024, 2048, 4096)
DISPATCH_POOLS = (16, 128, 256, 384, 512, 1024, 2048)    # K2 and K3 timed side by side
FIXTURE_FAMILIES = 3000
TRAIN_LR = 1e-3
LORA_RANK = 8
# K5 at (B, T): the finetune chunks at the fixture's pep and rec buckets, K1's
# timing shape, odd T and a long row
K5_SHAPES = ((16, 32), (16, 192), (16, 512), (1, 1), (3, 63), (2, 200), (1, 2048))
K5_TIME_SHAPES = ((16, 512), (16, 192), (16, 32))
# The finetune step through K1/K5 against the same step through K1 and K5's
# plain version: per leaf max|g_kernel - g_plain| <= FT_K5_TOL max|g_plain|,
# the loss within FT_LOSS_TOL relative. Every backbone gradient passes
# through bf16 at each layer, so K5's sum order shows as bf16 rounding
# flips: one bf16 ulp (2^-8) in L2 at the median leaf, 2.6 ulps of the
# leaf's largest entry at the key bias, whose gradient nearly cancels
# (softmax ignores a per-query constant; RoPE leaves a remainder). The
# limit is four ulps; a K5 whose dk/dv loop drops the last query tile
# moves that leaf by 59 times it and every attention leaf by 34 or more.
FT_LOSS_TOL, FT_K5_TOL = 1e-6, 2 ** -6
# The same step against eager autograd, both bf16: per leaf |g_kernel -
# g_eager| <= 2 |g_eager - g_f32| + FT_GRAD_FLOOR max|g_f32| (and the loss
# alike, with FT_LOSS_FLOOR |loss_f32|, 1/40 of a bf16 ulp), with the eager
# step in f32 as the reference.
FT_LOSS_FLOOR, FT_GRAD_FLOOR = 1e-4, 1e-2
AAS = "LAGVSERTIDPKQNFYMHWC"


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over iters calls, by CUDA events."""
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


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def qkv(B: int, T: int, gen: torch.Generator):
    def r(scale):
        return (scale * torch.randn(B, T, NH, DH, device="cuda", generator=gen)).bfloat16()
    return r(DH ** -0.5), r(1.0), r(1.0)


def padded_segments(B: int, T: int) -> torch.Tensor:
    """0/1 masks with true lengths spread over (0, T]; every row but the
    longest ends in pad positions, whose query rows are fully masked."""
    lengths = np.linspace(max(1, T // 8), T, B).astype(int) if B > 1 else [T - T // 4]
    seg = torch.zeros(B, T, dtype=torch.int32)
    for b, n in enumerate(lengths):
        seg[b, :n] = 1
    return seg.cuda()


def packed_segments(B: int, T: int) -> torch.Tensor:
    """Packed rows: segments 1, 2, 3, ... of varied length with gap zeros."""
    rng = np.random.default_rng(SEED)
    seg = torch.zeros(B, T, dtype=torch.int32)
    for b in range(B):
        pos, sid = 0, 1
        while pos < T - 8:
            n = int(rng.integers(8, max(9, T // 3)))
            seg[b, pos:min(T, pos + n)] = sid
            pos += n + int(rng.integers(0, 5))   # gap of 0-4 zeros
            sid += 1
    return seg.cuda()


def check_attention(gen: torch.Generator) -> float:
    worst = 0.0
    cases = [(B, T, "padded", padded_segments(B, T)) for B, T in KERNEL_SHAPES]
    cases += [(4, 512, "packed", packed_segments(4, 512)),
              (1, 2048, "packed", packed_segments(1, 2048))]
    for B, T, kind, seg in cases:
        q, k, v = qkv(B, T, gen)
        got = attention.fused_attention(q, k, v, seg)
        torch.cuda.synchronize()
        ref = attention.attention_reference(q, k, v, seg).float()
        err = (got.float() - ref).abs()
        rms = ref.square().mean().sqrt().item()
        atol = ATOL_RMS * rms
        need = (err - RTOL * ref.abs()).max().item()  # the least atol that passes
        ok = bool(torch.isfinite(got).all()) and need <= atol
        worst = max(worst, err.max().item())
        log(f"[kernels] attention_fwd B={B} T={T} NH={NH} {kind}: max|err| "
            f"{err.max().item():.6g}; tolerance {ATOL_RMS:g}*rms(ref) + {RTOL}*|ref| "
            f"with rms(ref) {rms:.6g}, so atol {atol:.6g}; least passing atol "
            f"{need:.6g} = {need / rms:.6g} rms(ref) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"attention_fwd disagrees with its plain version "
                                 f"at B={B} T={T} ({kind})")
    return worst


def bwd_cases(gen: torch.Generator):
    """(B, T, kind, q, k, v, dO, segments) for K5: padded rows everywhere
    (with one row of no valid token where B > 1, whose queries are all
    uniform), packed rows at three shapes."""
    for B, T in K5_SHAPES:
        kinds = ["padded"] + (["packed"] if T in (192, 200, 2048) else [])
        for kind in kinds:
            if kind == "packed":
                seg = packed_segments(B, T)
            else:
                seg = padded_segments(B, T)
                if B > 1:
                    seg[B // 2] = 0
                    kind = "padded, one row fully padded"
            q, k, v = qkv(B, T, gen)
            do = torch.randn(B, T, NH, DH, device="cuda", generator=gen).bfloat16()
            yield B, T, kind, q, k, v, do, seg


def check_attention_bwd(gen: torch.Generator) -> float:
    """K5 against attention_reference_bwd, each of dq, dk, dv held to K1's
    form |err| <= ATOL_RMS * rms(ref) + RTOL * |ref|: both round P and dS to
    bf16 for the products, from f32 values that differ by the order of
    their sums (K5's online max and 64-key tiles against one softmax), and
    round the outputs to bf16 (2^-8 relative, within RTOL)."""
    worst = 0.0
    for B, T, kind, q, k, v, do, seg in bwd_cases(gen):
        got = attention.fused_attention_bwd(q, k, v, seg, do)
        torch.cuda.synchronize()
        want = attention.attention_reference_bwd(q, k, v, seg, do)
        needs = []
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            w = w.float()
            err = (g.float() - w).abs()
            rms = w.square().mean().sqrt().item()
            need = (err - RTOL * w.abs()).max().item() / max(rms, 1e-30)
            if not (bool(torch.isfinite(g).all()) and need <= ATOL_RMS):
                raise AssertionError(f"attention_bwd {name} disagrees with its plain version "
                                     f"at B={B} T={T} ({kind}): least passing atol "
                                     f"{need:.6g} rms(ref)")
            worst = max(worst, err.max().item())
            needs.append(f"{name} {err.max().item():.6g} (least passing atol {need:.6g} rms)")
        log(f"[kernels] attention_bwd B={B} T={T} NH={NH} {kind}: max|err| " + ", ".join(needs)
            + f"; tolerance {ATOL_RMS:g}*rms(ref) + {RTOL}*|ref| ok")
    return worst


def maxsim_inputs(Ba: int, Bb: int, TA: int, TB: int, gen: torch.Generator):
    """Unit-norm f32 tokens and padded 0/1 masks (true lengths over
    [T/4, T]); when Ba > 1 one a-row, and always one b-row, has no valid
    token (the clamp path)."""
    def tokens(B, T):
        x = torch.randn(B, T, FILIP_D, device="cuda", generator=gen)
        return torch.nn.functional.normalize(x, dim=-1)

    def mask(B, T):
        lengths = torch.randint(max(1, T // 4), T + 1, (B, 1), device="cuda", generator=gen)
        return (torch.arange(T, device="cuda")[None, :] < lengths).to(torch.int32)

    ma, mb = mask(Ba, TA), mask(Bb, TB)
    if Ba > 1:
        ma[Ba // 2] = 0
    mb[Bb // 2] = 0
    return tokens(Ba, TA), tokens(Bb, TB), ma, mb


def check_maxsim(gen: torch.Generator) -> float:
    worst = 0.0
    for Ba, Bb, TA, TB in K4_SHAPES:
        ha, hb, ma, mb = maxsim_inputs(Ba, Bb, TA, TB, gen)
        got = maxsim.filip_similarity_fused(ha, hb, ma, mb, 1.0)
        torch.cuda.synchronize()
        want = maxsim.maxsim_reference(ha, hb, ma, mb)
        errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
        ok = all(bool(torch.isfinite(g).all()) for g in got) and max(errs) <= K4_ATOL
        empty_ok = bool((got[1][:, Bb // 2] == 0).all()) and (
            Ba == 1 or bool((got[0][Ba // 2] == 0).all()))
        worst = max(worst, *errs)
        log(f"[kernels] filip_maxsim (Ba, Bb, TA, TB)=({Ba}, {Bb}, {TA}, {TB}) D={FILIP_D}: "
            f"max|err| oa {errs[0]:.6g}, ob {errs[1]:.6g} (tolerance {K4_ATOL:g}); "
            f"empty rows score 0: {empty_ok} {'ok' if ok and empty_ok else 'FAIL'}")
        if not (ok and empty_ok):
            raise AssertionError(f"filip_maxsim disagrees with its plain version at "
                                 f"({Ba}, {Bb}, {TA}, {TB})")
    return worst


def unit_rows(B: int, D: int, t: float, gen: torch.Generator):
    """(B, D) f32 x, y: unit rows scaled by exp(t/2), as the heads give them."""
    def rows():
        x = torch.randn(B, D, device="cuda", generator=gen)
        return (torch.nn.functional.normalize(x, dim=-1) * math.exp(t / 2)).contiguous()
    return rows(), rows()


def value_and_grads(fn, x, y):
    xr, yr = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
    loss = fn(xr, yr)
    loss.backward()
    torch.cuda.synchronize()
    return loss.detach(), xr.grad, yr.grad


def check_infonce(gen: torch.Generator) -> dict:
    """K2 and K3, forward and backward, against the plain clip_infonce;
    returns the largest absolute error of each (loss and gradients)."""
    cases = [("infonce", B, 128, t) for B in K2_POOLS for t in (1.0, 4.0)]
    cases += [("infonce_tiled", B, 128, t) for B in K3_POOLS for t in (1.0, 4.0)]
    cases += [("infonce", 256, 64, 1.0), ("infonce_tiled", 1024, 64, 1.0)]
    worst = {"infonce": 0.0, "infonce_tiled": 0.0}
    for name, B, D, t in cases:
        fn = infonce.fused_infonce if name == "infonce" else infonce.fused_infonce_tiled
        x, y = unit_rows(B, D, t, gen)
        got = value_and_grads(fn, x, y)
        want = value_and_grads(infonce.clip_infonce, x, y)
        loss_err = abs(float(got[0] - want[0]))
        loss_tol = INFONCE_RTOL * max(1.0, abs(float(want[0])))
        errs = [float((g - w).abs().max()) for g, w in zip(got[1:], want[1:])]
        tols = [INFONCE_RTOL * float(w.abs().max()) for w in want[1:]]
        ok = (all(bool(torch.isfinite(v).all()) for v in got) and loss_err <= loss_tol
              and all(e <= tol for e, tol in zip(errs, tols)))
        worst[name] = max(worst[name], loss_err, *errs)
        log(f"[kernels] {name} B={B} D={D} t={t:g}: loss {float(got[0]):.6f}, |err| "
            f"{loss_err:.3g} (tolerance {loss_tol:.3g}); max|err| dX {errs[0]:.3g}, dY "
            f"{errs[1]:.3g} (tolerance {tols[0]:.3g}, {tols[1]:.3g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version at B={B} D={D} t={t}")
    return worst


# ---------------------------------------------------------------------------
# Phase 3: the serving path
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def counted_forwards():
    """Record the shape of every backbone forward while the block runs."""
    forwards = []
    plain_forward = esm2.forward

    def counted_forward(params, ids, mask, c, **kw):
        forwards.append(tuple(ids.shape))
        return plain_forward(params, ids, mask, c, **kw)

    esm2.forward = counted_forward
    try:
        yield forwards
    finally:
        esm2.forward = plain_forward


def reset_counts() -> None:
    attention.fused_attention.launches = 0
    attention.fused_attention_bwd.launches = 0
    maxsim.filip_similarity_fused.launches = 0
    for fn in (infonce.fused_infonce, infonce.fused_infonce_tiled):
        fn.launches = fn.bwd_launches = 0


def infonce_counts() -> dict:
    return {name: (fn.launches, fn.bwd_launches) for name, fn in
            (("infonce", infonce.fused_infonce), ("infonce_tiled", infonce.fused_infonce_tiled))}


def synthetic_seqs(rng: np.random.Generator, lengths) -> list[str]:
    return ["".join(rng.choice(list(AAS), int(n))) for n in lengths]


def call(base: str, path: str, payload=None, headers=None):
    req = urllib.request.Request(
        base + path, data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.headers, r.read()


def post_json(base: str, path: str, payload) -> dict:
    return json.loads(call(base, path, payload)[1])


def embed_json(base: str, seqs: list[str], side: str) -> np.ndarray:
    emb = np.asarray(post_json(base, "/embed", {"sequences": seqs, "side": side})
                     ["embeddings"], np.float32)
    if emb.shape != (len(seqs), 128) or not np.isfinite(emb).all():
        raise AssertionError(f"/embed returned shape {emb.shape} or non-finite values")
    return emb


def concurrent_burst(base: str, n_clients: int = 16, n_reqs: int = 4) -> dict:
    """Closed-loop clients released together; returns the /metrics delta."""
    before = json.loads(call(base, "/metrics")[1])
    barrier = threading.Barrier(n_clients)
    errors: list[BaseException] = []

    def client(i: int):
        crng = np.random.default_rng(1000 + i)
        try:
            barrier.wait(timeout=120)
            for _ in range(n_reqs):
                embed_json(base, synthetic_seqs(crng, [crng.integers(8, 40)]), "pep")
        except BaseException as e:  # noqa: BLE001 — re-raised in the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"concurrent clients failed: {errors[:1]}")
    after = json.loads(call(base, "/metrics")[1])
    return {k: after[k] - before[k] for k in ("requests", "sequences", "device_batches")}


def run_serve_phase(rng: np.random.Generator) -> dict:
    """The main path, start to end; returns what phases 4 and 5 need."""
    if WORK.exists():
        shutil.rmtree(WORK)
    WORK.mkdir()
    cfg = common.esm_config("t30_150M", "bfloat16")
    assert cfg.attention_impl == "fused", cfg
    mcfg = clip.CLIPConfig(input_dim=cfg.hidden_size, esm=cfg)
    t0 = time.perf_counter()
    esm_params = esm2.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                                  dtype=torch.bfloat16, device="cuda")
    heads = clip.init_params(mcfg, torch.Generator().manual_seed(SEED), device="cuda")
    export_npz(WORK / "esm_t30_150M.npz", esm_params)
    export_npz(WORK / "best_model.npz", heads)
    fasta = WORK / "corpus.fasta"
    corpus = synthetic_seqs(rng, rng.integers(30, 500, 256))
    fasta.write_text("".join(f">seq{i}\n{s}\n" for i, s in enumerate(corpus)))
    log(f"[serve] t30_150M bf16 random weights (seed {SEED}) and heads written in "
        f"{time.perf_counter() - t0:.1f} s")
    model_args = ["--checkpoint", str(WORK / "best_model.npz"),
                  "--esm-weights", str(WORK / "esm_t30_150M.npz"), "--batch-size", "32"]

    # Count backbone forwards beside the kernels' launches.
    with counted_forwards() as forwards:
        reset_counts()
        embed.main(model_args + ["--fasta", str(fasta), "--side", "rec",
                                 "--out", str(WORK / "index.npz")])
        args = serve.build_argparser().parse_args(
            model_args + ["--index", str(WORK / "index.npz"), "--port", "0"])
        server = serve.make_server(args)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        out: dict = {"base": base, "server": server, "thread": thread, "mcfg": mcfg,
                     "esm_params": esm_params, "heads": heads, "model_args": model_args}

        health = json.loads(call(base, "/healthz")[1])
        if not (health["status"] == "ok" and health["index_size"] == 256
                and health["filip"] is False):
            raise AssertionError(f"/healthz {health}")
        log(f"[serve] /healthz {health}")

        singles = {}  # (side, bucket) -> (seq, embedding)
        for bucket, n in ((64, 40), (128, 100), (512, 400), (2048, 1800)):
            seq = synthetic_seqs(rng, [n])[0]
            for side in ("pep", "rec"):
                singles[(side, bucket)] = (seq, embed_json(base, [seq], side)[0])
        log(f"[serve] single-sequence /embed at buckets 64/128/512/2048, both sides: ok")

        batch32 = synthetic_seqs(rng, rng.integers(50, 300, 32))
        emb32 = embed_json(base, batch32, "rec")
        headers, body = call(base, "/embed", {"sequences": batch32, "side": "rec"},
                             {"Accept": "application/octet-stream"})
        shape = tuple(int(d) for d in headers["X-Shape"].split(","))
        wire = np.frombuffer(body, "<f4").reshape(shape)
        if shape != emb32.shape or not np.array_equal(wire, emb32):
            raise AssertionError("binary /embed differs from the JSON path")
        log(f"[serve] 32-sequence /embed {emb32.shape}, binary wire bit-equal to JSON")

        queries = batch32[:4]
        hits = post_json(base, "/topk", {"queries": queries, "side": "pep", "k": 10})["hits"]
        qemb = embed_json(base, queries, "pep")
        with np.load(WORK / "index.npz") as index:
            ids, corpus = index["ids"], index["embeddings"]
        want = np.argsort(-(qemb @ corpus.T), axis=1)[:, :10]
        for q, row in enumerate(hits):
            got_ids = [h["id"] for h in row]
            if [h["rank"] for h in row] != list(range(1, 11)) or got_ids != [
                    str(ids[i]) for i in want[q]]:
                raise AssertionError(f"/topk order wrong for query {q}")
            if not all(np.isfinite(h["score"]) for h in row):
                raise AssertionError("/topk returned a non-finite score")
        log(f"[serve] /topk k=10 over the 256-sequence index: order ok")

        for attempt in range(3):
            delta = concurrent_burst(base)
            log(f"[serve] 16 concurrent clients x 4 requests: {delta}")
            if delta["requests"] != 64 or delta["sequences"] != 64:
                raise AssertionError(f"/metrics lost requests: {delta}")
            if delta["device_batches"] < delta["requests"]:
                break
        else:
            raise AssertionError("no coalescing in 3 bursts of 16 concurrent clients")
        metrics = json.loads(call(base, "/metrics")[1])
        log(f"[serve] /metrics {metrics}")

        launches = attention.fused_attention.launches
        k4_launches = maxsim.filip_similarity_fused.launches
    if not forwards or launches != cfg.num_layers * len(forwards):
        raise AssertionError(f"attention_fwd launched {launches} times for "
                             f"{len(forwards)} backbone forwards; want "
                             f"{cfg.num_layers} per forward")
    log(f"[serve] {len(forwards)} backbone forwards, attention_fwd launches {launches} "
        f"= {cfg.num_layers} per forward; filip_maxsim launches {k4_launches}")
    out.update(launches={"attention_fwd": launches, "filip_maxsim": k4_launches},
               singles=singles, batch32=batch32, emb32=emb32)
    return out


# ---------------------------------------------------------------------------
# Phase 4: end to end against the plain attention
# ---------------------------------------------------------------------------

def check_end_to_end(ctx: dict) -> float:
    mcfg = ctx["mcfg"]
    eager = dataclasses.replace(mcfg, esm=dataclasses.replace(mcfg.esm, attention_impl="eager"))
    tok = common.make_tokenizer()

    def plain(seqs, side):
        return embed.embed_sequences(ctx["heads"], ctx["esm_params"], seqs, side, eager,
                                     tok, torch.device("cuda"), batch_size=32,
                                     pad_batch=True)

    def cosines(a, b):
        return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))

    cos = list(cosines(ctx["emb32"], plain(ctx["batch32"], "rec")))
    for (side, _), (seq, emb) in ctx["singles"].items():
        cos += list(cosines(emb[None], plain([seq], side)))
    worst = float(min(cos))
    log(f"[e2e] served (kernel) vs eager attention, {len(cos)} rows: min cosine "
        f"{worst:.6f} (need >= {COSINE_MIN})")
    if not worst >= COSINE_MIN:
        raise AssertionError(f"kernel path drifts from the eager path: cosine {worst}")
    return worst


# ---------------------------------------------------------------------------
# Phase 5: the FILIP serving path
# ---------------------------------------------------------------------------

def scorer_blocks(n_queries: int, n_index: int) -> int:
    """Kernel launches of one ragged scorer call: one per (64-query,
    1024-candidate) block."""
    return math.ceil(n_queries / 64) * math.ceil(n_index / 1024)


def plain_filip_scores(q_tokens: np.ndarray, q_lengths, index_path: Path,
                       temperature) -> tuple[np.ndarray, np.ndarray]:
    """(Q, N) direction-averaged scores of the queries against the whole
    ragged index by the plain max-sim on the card, and the index ids."""
    with np.load(index_path) as index:
        ids, flat, lengths = index["ids"], index["tokens"], index["lengths"]
    tb = 64 * math.ceil(int(lengths.max()) / 64)
    hb = np.zeros((len(ids), tb, flat.shape[1]), np.float32)
    for r, (start, n) in enumerate(zip(np.cumsum(lengths) - lengths, lengths)):
        hb[r, :n] = flat[start:start + n]
    mb = (np.arange(tb)[None, :] < lengths[:, None]).astype(np.int32)
    qm = (np.arange(q_tokens.shape[1])[None, :] < np.asarray(q_lengths)[:, None]).astype(np.int32)
    sa, sb = maxsim.maxsim_reference(*(torch.from_numpy(a).cuda()
                                       for a in (q_tokens, hb, qm, mb)))
    t = maxsim.clamped_temperature(temperature)
    return ((sa + sb) / 2 / t).cpu().numpy(), ids


def check_hits(name: str, got_ids: list[str], got_scores, plain_row: np.ndarray,
               ids: np.ndarray) -> float:
    """Each hit's plain score equals its returned score and the plain top-k
    score at its rank, within K4_ATOL (near-ties may swap, nothing else);
    returns the largest score difference."""
    pos = {str(x): i for i, x in enumerate(ids)}
    top = np.sort(plain_row)[::-1]
    worst = 0.0
    if len(set(got_ids)) != len(got_ids):
        raise AssertionError(f"{name}: repeated ids {got_ids}")
    for r, (hid, score) in enumerate(zip(got_ids, got_scores)):
        plain = float(plain_row[pos[hid]])
        worst = max(worst, abs(score - plain), abs(plain - float(top[r])))
    if not worst <= K4_ATOL:
        raise AssertionError(f"{name}: hits disagree with the plain scores by {worst:g}")
    return worst


def read_tsv(path: Path, k: int) -> list[list[tuple[str, float]]]:
    lines = path.read_text().splitlines()
    if lines[0] != "query_id\trank\thit_id\tscore":
        raise AssertionError(f"{path.name}: header {lines[0]!r}")
    rows = [ln.split("\t") for ln in lines[1:]]
    return [[(h, float(sc)) for _, _, h, sc in rows[q * k:(q + 1) * k]]
            for q in range(len(rows) // k)]


def run_filip_phase(ctx: dict, rng: np.random.Generator) -> dict:
    """FILIP heads over the same backbone: embed --filip, serve --filip,
    retrieve (both modes)."""
    cfg = ctx["mcfg"].esm
    fcfg = filip.FILIPConfig(input_dim=cfg.hidden_size, embedding_dim=FILIP_D, esm=cfg)
    fheads = filip.init_params(fcfg, torch.Generator().manual_seed(SEED + 1), device="cuda")
    export_npz(WORK / "filip_heads.npz", fheads)
    corpus = synthetic_seqs(rng, rng.integers(30, 500, 256))
    (WORK / "filip_corpus.fasta").write_text(
        "".join(f">f{i}\n{s}\n" for i, s in enumerate(corpus)))
    queries = synthetic_seqs(rng, [24, 100, 300, 450])       # buckets 32 to 512
    (WORK / "queries.fasta").write_text("".join(f">q{i}\n{s}\n" for i, s in enumerate(queries)))
    model_args = ["--checkpoint", str(WORK / "filip_heads.npz"),
                  "--esm-weights", str(WORK / "esm_t30_150M.npz"), "--batch-size", "32"]
    index_path = WORK / "filip_index.npz"
    k, n_index = 10, len(corpus)
    blocks = scorer_blocks(len(queries), n_index)

    def k4_calls(what: str, before: int) -> None:
        got = maxsim.filip_similarity_fused.launches - before
        if got != blocks:
            raise AssertionError(f"{what}: filip_maxsim launched {got} times, want {blocks}")

    with counted_forwards() as forwards:
        reset_counts()
        embed.main(model_args + ["--filip", "--fasta", str(WORK / "filip_corpus.fasta"),
                                 "--side", "rec", "--out", str(index_path)])
        with np.load(index_path) as index:
            lengths = index["lengths"]
            if index["tokens"].shape != (int(lengths.sum()), FILIP_D) or len(lengths) != 256:
                raise AssertionError("embed --filip wrote a malformed index")
        log(f"[filip] embed --filip: ragged index of {len(lengths)} sequences, "
            f"{int(lengths.sum())} tokens, lengths {int(lengths.min())}-{int(lengths.max())}")
        args = serve.build_argparser().parse_args(
            model_args + ["--index", str(index_path), "--port", "0", "--filip"])
        server = serve.make_server(args)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        out: dict = {"base": base, "server": server, "thread": thread, "fcfg": fcfg,
                     "fheads": fheads, "queries": queries, "index_path": index_path,
                     "corpus": corpus}
        health = json.loads(call(base, "/healthz")[1])
        if not (health["filip"] is True and health["index_size"] == 256):
            raise AssertionError(f"/healthz {health}")
        log(f"[filip] /healthz {health}")

        js = post_json(base, "/embed", {"sequences": queries, "side": "pep"})
        q_tokens = np.asarray(js["tokens"], np.float32)
        headers, body = call(base, "/embed", {"sequences": queries, "side": "pep"},
                             {"Accept": "application/octet-stream"})
        n_pre = int(headers["X-Prefix-Len"])
        prefix = np.frombuffer(body[:4 * n_pre], "<i4").tolist()
        shape = tuple(int(d) for d in headers["X-Shape"].split(","))
        wire = np.frombuffer(body[4 * n_pre:], "<f4").reshape(shape)
        true_lengths = [len(q) + 2 for q in queries]
        if not (np.isfinite(q_tokens).all() and q_tokens.shape == (4, 512, FILIP_D)):
            raise AssertionError(f"/embed tokens {q_tokens.shape} or non-finite")
        if not (np.array_equal(wire, q_tokens) and prefix == js["lengths"] == true_lengths):
            raise AssertionError("binary /embed or its length prefix differs from JSON")
        log(f"[filip] /embed JSON {q_tokens.shape}; binary bit-equal, prefix {prefix} "
            f"= true lengths")

        before = maxsim.filip_similarity_fused.launches
        hits = post_json(base, "/topk", {"queries": queries, "side": "pep", "k": k})["hits"]
        k4_calls("/topk", before)
        plain, ids = plain_filip_scores(q_tokens, prefix, index_path, fheads["temperature"])
        worst = 0.0
        for q, row in enumerate(hits):
            if [h["rank"] for h in row] != list(range(1, k + 1)):
                raise AssertionError(f"/topk ranks {row}")
            worst = max(worst, check_hits(f"/topk query {q}", [h["id"] for h in row],
                                          [h["score"] for h in row], plain[q], ids))
        log(f"[filip] /topk k={k}, {len(queries)} queries over {n_index}: {blocks} "
            f"filip_maxsim launch(es); scores and order within {worst:.3g} of the plain "
            f"max-sim")

        before = maxsim.filip_similarity_fused.launches
        retrieve.main(model_args + ["--filip", "--index", str(index_path), "--queries",
                                    str(WORK / "queries.fasta"), "--side", "pep", "--k",
                                    str(k), "--out", str(WORK / "filip_hits.tsv")])
        k4_calls("retrieve --filip", before)
        tsv = read_tsv(WORK / "filip_hits.tsv", k)
        for q, row in enumerate(tsv):
            check_hits(f"retrieve --filip query {q}", [h for h, _ in row],
                       [sc for _, sc in row], plain[q], ids)
        same = sum([h for h, _ in row] == [x["id"] for x in hits_row]
                   for row, hits_row in zip(tsv, hits))
        log(f"[filip] retrieve --filip: {len(tsv)} queries, {same} with /topk's ids in "
            f"/topk's order, all within {K4_ATOL:g} of the plain scores at each rank")

        retrieve.main(ctx["model_args"] + ["--index", str(WORK / "index.npz"), "--queries",
                                           str(WORK / "queries.fasta"), "--side", "pep",
                                           "--k", str(k), "--out", str(WORK / "clip_hits.tsv")])
        qemb = embed.embed_sequences(ctx["heads"], ctx["esm_params"], queries, "pep",
                                     ctx["mcfg"], common.make_tokenizer(),
                                     torch.device("cuda"), batch_size=32)
        with np.load(WORK / "index.npz") as index:
            clip_ids, clip_emb = index["ids"], index["embeddings"]
        clip_scores = qemb @ clip_emb.T
        for q, row in enumerate(read_tsv(WORK / "clip_hits.tsv", k)):
            check_hits(f"retrieve (CLIP) query {q}", [h for h, _ in row],
                       [sc for _, sc in row], clip_scores[q], clip_ids)
        log(f"[filip] retrieve (CLIP mode) against the 256-sequence CLIP index: ok")

        k1 = attention.fused_attention.launches
        k4 = maxsim.filip_similarity_fused.launches
    if not forwards or k1 != cfg.num_layers * len(forwards):
        raise AssertionError(f"attention_fwd launched {k1} times for {len(forwards)} "
                             f"backbone forwards; want {cfg.num_layers} per forward")
    if k4 != 2 * blocks:
        raise AssertionError(f"filip_maxsim launched {k4} times; want {2 * blocks}")
    log(f"[filip] {len(forwards)} backbone forwards, attention_fwd launches {k1} = "
        f"{cfg.num_layers} per forward; filip_maxsim launches {k4}")
    out.update(launches={"attention_fwd": k1, "filip_maxsim": k4}, q_tokens=q_tokens,
               q_lengths=prefix)
    return out


# ---------------------------------------------------------------------------
# Phase 6: FILIP tokens end to end against the plain attention
# ---------------------------------------------------------------------------

def check_filip_end_to_end(ctx: dict, fctx: dict) -> float:
    eager = dataclasses.replace(fctx["fcfg"], esm=dataclasses.replace(
        fctx["fcfg"].esm, attention_impl="eager"))
    toks, mask = embed.embed_sequences_tokens(fctx["fheads"], ctx["esm_params"],
                                              fctx["queries"], "pep", eager,
                                              common.make_tokenizer(), torch.device("cuda"),
                                              batch_size=32, pad_batch=True)
    served = fctx["q_tokens"]
    valid = mask.astype(bool)
    if toks.shape != served.shape or valid.sum(1).tolist() != fctx["q_lengths"]:
        raise AssertionError(f"eager tokens {toks.shape} vs served {served.shape}")
    a, b = served[valid], toks[valid]
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    log(f"[filip e2e] served (kernel) vs eager attention, {len(cos)} valid tokens: "
        f"min cosine {cos.min():.6f}, median {np.median(cos):.6f} "
        f"(need min >= {FILIP_COSINE_MIN})")
    if not cos.min() >= FILIP_COSINE_MIN:
        raise AssertionError(f"FILIP tokens drift from the eager path: cosine {cos.min()}")
    return float(cos.min())


# ---------------------------------------------------------------------------
# Phase 7: the training path
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def timed_steps(engine=clip_engine):
    """Record a CUDA event on the current stream after every train step of
    ``engine`` while the block runs. Nothing syncs: the steps overlap the
    host and the card as train_gc runs them, and the events are read after
    the epoch."""
    ends: list[torch.cuda.Event] = []
    plain_make = engine.make_train_step

    def make(cfg, loss_fn=None):
        step = plain_make(cfg, loss_fn)

        def timed(*args):
            out = step(*args)
            ends.append(torch.cuda.Event(enable_timing=True))
            ends[-1].record()
            return out
        return timed

    engine.make_train_step = make
    try:
        yield ends
    finally:
        engine.make_train_step = plain_make


def check_run_dir(runs: Path) -> Path:
    (run,) = list(runs.iterdir())
    names = sorted(p.name for p in run.iterdir())
    if names != ["best_model.npz", "losses_per_epoch.txt", "metrics.jsonl"]:
        raise AssertionError(f"{run}: artifacts {names}")
    rows = (run / "losses_per_epoch.txt").read_text().splitlines()
    if rows[0] != "Epoch,Train Loss,Validation Loss" or len(rows) != 2:
        raise AssertionError(f"losses_per_epoch.txt: {rows}")
    values = [float(v) for v in rows[1].split(",")[1:]]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"non-finite losses {rows[1]}")
    return run


def loss_kernel(pool: int) -> str:
    """The InfoNCE kernel the train and eval steps run on a pool."""
    return "infonce" if clip_engine.fused_infonce_fits(pool) else "infonce_tiled"


def run_train(name: str, data_dir: Path, batch_size: int) -> dict:
    """cli.main for one epoch at --batch-size batch_size x 16; checks the
    artifacts and every kernel's launch count against the loaders."""
    runs = WORK / f"runs_{name}"
    t0 = time.perf_counter()
    with counted_forwards() as forwards, timed_steps() as ends:
        reset_counts()
        train_cli.main(["--synthetic-fixture", "--data-dir", str(data_dir), "--fixture-families",
                        str(FIXTURE_FAMILIES), "--epochs", "1", "--runs-dir", str(runs),
                        "--batch-size", str(batch_size), "--accumulated-batches", "16"])
        k1 = attention.fused_attention.launches
        counts = infonce_counts()
    wall = time.perf_counter() - t0
    run = check_run_dir(runs)
    train_ds, val_ds, test_ds = dataset.generate_datasets(data_dir, seed=42)
    steps = len(train_ds) // batch_size // 16
    evals = len(val_ds) // batch_size + len(test_ds) // batch_size
    want_forwards = 32 * steps + 8 * evals     # 4 groups x 2 sides x (4 chunks | 1)
    want = {"infonce": [0, 0], "infonce_tiled": [0, 0]}
    want[loss_kernel(16 * batch_size)][0] += steps
    want[loss_kernel(16 * batch_size)][1] += steps
    want[loss_kernel(batch_size)][0] += evals
    want = {k: tuple(v) for k, v in want.items()}
    if len(ends) != steps or len(forwards) != want_forwards or k1 != 30 * want_forwards:
        raise AssertionError(f"{name}: {len(ends)} steps (want {steps}), {len(forwards)} "
                             f"forwards (want {want_forwards}), {k1} attention_fwd launches")
    if counts != want:
        raise AssertionError(f"{name}: InfoNCE (forward, backward) calls {counts}, want {want}")
    metrics = json.loads((run / "metrics.jsonl").read_text().splitlines()[0])
    log(f"[train] {name}: global batch {16 * batch_size}, {steps} steps, {evals} eval batches "
        f"of {batch_size}; train loss {metrics['train_loss']:.6f}, val loss "
        f"{metrics['val_loss']:.6f}; {len(forwards)} backbone forwards, attention_fwd "
        f"{k1} = 30 per forward; InfoNCE (forward, backward) calls {counts}; epoch "
        f"{metrics['seconds']:.2f} s, cli.main {wall:.2f} s")
    return {"run": run, "steps": steps, "ends": ends, "launches": {
        "attention_fwd": k1, "filip_maxsim": maxsim.filip_similarity_fused.launches,
        **{k: v[0] for k, v in counts.items()}}, "bwd": {k: v[1] for k, v in counts.items()}}


def run_unfrozen(name: str, data_dir: Path, mode_args: list[str], engine) -> dict:
    """cli.main --finetune or --lora-rank for one epoch at the defaults
    (global batch 256 in one pad bucket, 16 chunks, remat); checks the
    artifacts and every kernel's launch count against the loaders."""
    runs = WORK / f"runs_{name}"
    t0 = time.perf_counter()
    with counted_forwards() as forwards, timed_steps(engine) as ends:
        reset_counts()
        train_cli.main(["--synthetic-fixture", "--data-dir", str(data_dir), "--fixture-families",
                        str(FIXTURE_FAMILIES), "--epochs", "1", "--runs-dir", str(runs)]
                       + mode_args)
        k1 = attention.fused_attention.launches
        k5 = attention.fused_attention_bwd.launches
        counts = infonce_counts()
    wall = time.perf_counter() - t0
    run = check_run_dir(runs)
    train_ds, val_ds, test_ds = dataset.generate_datasets(data_dir, seed=42)
    steps = len(train_ds) // 16 // 16
    evals = len(val_ds) // 16 + len(test_ds) // 16
    chunks = 2 * 16                          # per step: 16 chunks of 16 pairs per side
    want_forwards = 2 * chunks * steps + 2 * evals       # pass 1 and pass 2; 2 per eval
    want_k1 = (30 * chunks + 60 * chunks) * steps + 60 * evals
    want_k5 = 30 * chunks * steps
    want = {"infonce": (steps + evals, steps), "infonce_tiled": (0, 0)}
    if (len(ends), len(forwards), k1, k5) != (steps, want_forwards, want_k1, want_k5):
        raise AssertionError(f"{name}: {len(ends)} steps (want {steps}), {len(forwards)} "
                             f"forwards (want {want_forwards}), attention_fwd {k1} (want "
                             f"{want_k1}), attention_bwd {k5} (want {want_k5})")
    if counts != want:
        raise AssertionError(f"{name}: InfoNCE (forward, backward) calls {counts}, want {want}")
    metrics = json.loads((run / "metrics.jsonl").read_text().splitlines()[0])
    log(f"[train] {name}: global batch 256 in one pad bucket, {steps} steps, {evals} eval "
        f"batches of 16; train loss {metrics['train_loss']:.6f}, val loss "
        f"{metrics['val_loss']:.6f}; {len(forwards)} backbone forwards; attention_fwd {k1} "
        f"(30 per pass-1 forward, 60 per pass-2 chunk, 60 per eval batch), attention_bwd "
        f"{k5} (30 per pass-2 chunk); InfoNCE (forward, backward) calls {counts}; epoch "
        f"{metrics['seconds']:.2f} s, cli.main {wall:.2f} s")
    return {"run": run, "steps": steps, "ends": ends, "launches": {
        "attention_fwd": k1, "attention_bwd": k5,
        "filip_maxsim": maxsim.filip_similarity_fused.launches,
        **{k: v[0] for k, v in counts.items()}}}


def embed_check(path: Path, recs: list[str], what: str) -> None:
    fasta = WORK / "train_embed.fasta"
    fasta.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(recs[:8])))
    embed.main(["--checkpoint", str(path), "--fasta", str(fasta),
                "--side", "rec", "--out", str(WORK / "train_embed.npz")])
    with np.load(WORK / "train_embed.npz") as index:
        emb = index["embeddings"]
    if emb.shape != (8, 128) or not np.isfinite(emb).all():
        raise AssertionError(f"cli.embed with {what} gave {emb.shape}")
    log(f"[train] cli.embed with {what}: {emb.shape}, finite")


def run_train_phase() -> dict:
    data_dir = WORK / "train_data"
    out = {"k2": run_train("train_256", data_dir, 16),
           "k3": run_train("train_1024", data_dir, 64)}
    peps = sequences_only(data_dir / "peptide.fasta")
    recs = sequences_only(data_dir / "receptor.fasta")
    out["profile"] = (f"{len(recs)} pairs, receptors {min(map(len, recs))}-"
                      f"{max(map(len, recs))} aa, peptides {min(map(len, peps))}-"
                      f"{max(map(len, peps))} aa")
    log(f"[train] fixture: {FIXTURE_FAMILIES} families, {out['profile']}")
    embed_check(out["k2"]["run"] / "best_model.npz", recs, "run 1's best_model.npz")
    out["finetune"] = run_unfrozen("train_finetune", data_dir, ["--finetune"], finetune)
    embed_check(out["finetune"]["run"] / "best_model.npz", recs,
                "the finetune run's best_model.npz (its own backbone)")
    out["lora"] = run_unfrozen("train_lora", data_dir, ["--lora-rank", str(LORA_RANK)], lora)
    embed_check(out["lora"]["run"] / "best_model.npz", recs,
                "the LoRA run's best_model.npz (adapters merged into the base)")
    return out


# ---------------------------------------------------------------------------
# Phase 8: one train step through K2 / K3 against the plain loss
# ---------------------------------------------------------------------------

def capturing(state, params):
    """Make ``state.apply`` keep, by leaf name, the gradients it applies."""
    named = checkpoint._flatten(params)
    apply = state.apply

    def capture():
        state.grads = {k: t.grad.detach().clone() for k, t in named.items()}
        apply()

    state.apply = capture
    return state


def clone_tree(tree):
    return {k: clone_tree(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.clone()


def check_step(pool: int) -> dict:
    """The loss within 1e-5 relative and the gradients within 1e-5 of each
    leaf's largest. Adam's first update is lr g / (|g| + eps): when g moves
    by dg it moves by at most 2 lr |dg| / (max|g| + eps), which near g = 0
    turns f32 noise into up to lr; each updated parameter is held to that
    bound plus 1e-6, and the count beyond a flat 1e-5 is printed."""
    cfg_esm = common.esm_config("t30_150M", "bfloat16")
    mcfg = clip.CLIPConfig(input_dim=cfg_esm.hidden_size, dropout=0.0, esm=cfg_esm)
    cfg = clip_engine.EngineConfig(model=mcfg, batch_size=pool // 16, accumulated_batches=16,
                                   length_groups=4)
    esm_params = esm2.init_params(cfg_esm, torch.Generator(device="cuda").manual_seed(0),
                                  dtype=torch.bfloat16, device="cuda")
    train_ds, _, _ = dataset.generate_datasets(WORK / "train_data", seed=42)
    loader = dataset.PairLoader(train_ds, pool // 16, seed=SEED)
    peps, recs = next(clip_engine._accumulate(loader, 16))
    batch = tuple({k: v.cuda() for k, v in b.items()} for b in clip_engine.tokenize_grouped(
        common.make_tokenizer(), peps, recs, 4))
    heads0 = clip.init_params(mcfg, torch.Generator().manual_seed(SEED), device="cuda")
    kernel = loss_kernel(pool)
    kernel_fn = getattr(infonce, "fused_infonce" if kernel == "infonce"
                        else "fused_infonce_tiled")
    out = {}
    for name, loss_fn in (("kernel", None), ("plain", infonce.clip_infonce)):
        params = clone_tree(heads0)
        state = capturing(optimizer.adam(TRAIN_LR).init(params), params)
        before = (kernel_fn.launches, kernel_fn.bwd_launches)
        _, _, loss = clip_engine.make_train_step(cfg, loss_fn)(params, state, esm_params, batch,
                                                                None)
        torch.cuda.synchronize()
        calls = (kernel_fn.launches - before[0], kernel_fn.bwd_launches - before[1])
        if calls != ((1, 1) if name == "kernel" else (0, 0)):
            raise AssertionError(f"step check {pool}: {kernel} calls {calls} ({name})")
        out[name] = (float(loss), list(state.grads.values()), [t.detach() for t in state.leaves])
    (lk, gk, pk), (lp, gp, pp) = out["kernel"], out["plain"]
    loss_err = abs(lk - lp) / abs(lp)
    grad_err = max(float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(gk, gp))
    param_err, over_bound, over_flat, n = 0.0, 0, 0, 0
    for a, b, ga, gb in zip(pk, pp, gk, gp):
        d = (a - b).abs()
        bound = 1e-6 + 2 * TRAIN_LR * (ga - gb).abs() / (torch.maximum(ga.abs(), gb.abs()) + 1e-8)
        param_err = max(param_err, float(d.max()))
        over_bound += int((d > bound).sum())
        over_flat += int((d > 1e-5).sum())
        n += d.numel()
    ok = loss_err <= 1e-5 and grad_err <= 1e-5 and over_bound == 0
    log(f"[step] global batch {pool} through {kernel} vs the plain loss (dropout 0, Adam "
        f"lr {TRAIN_LR:g}): loss {lk:.6f} vs {lp:.6f}, relative |err| {loss_err:.3g} (tolerance "
        f"1e-5); gradients max |err| / leaf max {grad_err:.3g} (tolerance 1e-5); updated "
        f"params max |err| {param_err:.3g}, {over_bound} of {n} past Adam's bound, {over_flat} "
        f"past a flat 1e-5 {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the train step through {kernel} disagrees with the plain loss")
    return {"loss_rel_err": loss_err, "grad_rel_err": grad_err, "param_max_abs_err": param_err}


def drop_last_query_tile(bwd):
    """K5 with the planted fault the step check must catch: its dk/dv loop
    drops the last 64-query tile. Zeroing dO on those queries removes
    exactly their terms from dk and dv (their dS and P.dO vanish); dq comes
    from the whole call. Two K5 calls per backward."""
    def fault(q, k, v, segments, do):
        cut = do.clone()
        cut[:, (q.shape[1] - 1) // 64 * 64:] = 0
        return (bwd(q, k, v, segments, do)[0], *bwd(q, k, v, segments, cut)[1:])
    return fault


@contextlib.contextmanager
def attention_function(forward, backward):
    """The fused attention Function with another forward (K1's place) and
    backward (K5's place) while the block runs. K5 counts its launches on
    the module's name fused_attention_bwd, so the stand-in there carries
    the count meanwhile and hands it back."""
    saved = attention._forward, attention.fused_attention_bwd

    def stand_in(*args):
        return backward(*args)

    stand_in.launches = saved[1].launches
    attention._forward, attention.fused_attention_bwd = forward, stand_in
    try:
        yield
    finally:
        attention._forward, attention.fused_attention_bwd = saved
        saved[1].launches = stand_in.launches


def finetune_step_runs() -> dict:
    """One finetune step at global batch 256 (one pad bucket, 16 chunks,
    remat, dropout 0, the two-group Adam) from the same f32 master weights
    and batch, once per attention path: {name: (loss, {leaf: gradient})}.
    "kernel" runs K1 and K5; "k1_plain_bwd" K1 and K5's plain version;
    "plain_fwd_k5" K1's plain version and K5; "plain" both plain versions
    (the TPU kernels' semantics, rounding where they round); "fault" K1
    and drop_last_query_tile(K5); "eager" and "eager_f32"
    attention_impl="eager" (plain attention through autograd) with a bf16
    and an f32 backbone."""
    base = common.esm_config("t30_150M", "bfloat16")
    esm0 = esm2.init_params(base, torch.Generator(device="cuda").manual_seed(0),
                            dtype=torch.bfloat16, device="cuda")
    data_dir = WORK / "train_data"
    if not (data_dir / "receptor.fasta").exists():
        write_fixture(data_dir, n_families=FIXTURE_FAMILIES, seed=42)
    train_ds, _, _ = dataset.generate_datasets(data_dir, seed=42)
    peps, recs = next(clip_engine._accumulate(dataset.PairLoader(train_ds, 16, seed=SEED), 16))
    batch = {k: v.cuda() for k, v in clip_engine.tokenize_pair_batch(
        common.make_tokenizer(), peps, recs).items()}
    heads0 = clip.init_params(clip.CLIPConfig(input_dim=base.hidden_size, esm=base),
                              torch.Generator().manual_seed(SEED), device="cuda")
    k1, k5 = attention._forward, attention.fused_attention_bwd
    plain_fwd, plain_bwd = attention.attention_reference, attention.attention_reference_bwd
    c = 2 * 16                                   # chunks per step
    runs = (("kernel", "fused", torch.bfloat16, k1, k5, (90 * c, 30 * c)),
            ("k1_plain_bwd", "fused", torch.bfloat16, k1, plain_bwd, (90 * c, 0)),
            ("plain_fwd_k5", "fused", torch.bfloat16, plain_fwd, k5, (0, 30 * c)),
            ("plain", "fused", torch.bfloat16, plain_fwd, plain_bwd, (0, 0)),
            ("fault", "fused", torch.bfloat16, k1, drop_last_query_tile(k5), (90 * c, 60 * c)),
            ("eager", "eager", torch.bfloat16, k1, k5, (0, 0)),
            ("eager_f32", "eager", torch.float32, k1, k5, (0, 0)))
    out = {"shapes": (tuple(batch["pep_ids"].shape), tuple(batch["rec_ids"].shape))}
    for name, impl, dtype, fwd, bwd, want in runs:
        esm_cfg = dataclasses.replace(base, attention_impl=impl, compute_dtype=dtype)
        cfg = clip_engine.EngineConfig(
            model=clip.CLIPConfig(input_dim=base.hidden_size, dropout=0.0, esm=esm_cfg))
        params = finetune.init_params(esm0, clone_tree(heads0))
        state = capturing(finetune.make_optimizer(cfg).init(params), params)
        before = (attention.fused_attention.launches, k5.launches)
        with attention_function(fwd, bwd):
            _, _, loss = finetune.make_train_step(cfg)(params, state, {}, batch, None)
        torch.cuda.synchronize()
        calls = (attention.fused_attention.launches - before[0], k5.launches - before[1])
        if calls != want:
            raise AssertionError(f"finetune step check ({name}): (attention_fwd, "
                                 f"attention_bwd) launches {calls}, want {want}")
        out[name] = (float(loss), state.grads)
        del params, state
    return out


def leaf_gaps(a: dict, b: dict) -> dict:
    """{leaf: (max|a - b| / max|b|, |a - b| / |b| in L2)} over b's leaves."""
    return {k: (float((a[k] - b[k]).abs().max()) / max(float(b[k].abs().max()), 1e-30),
                float((a[k] - b[k]).norm()) / max(float(b[k].norm()), 1e-30)) for k in b}


def gap_summary(gaps: dict) -> dict:
    """Per part (backbone "esm/", heads "heads/"): the leaf with the largest
    max-relative gap, and the median and largest L2-relative gap."""
    out = {}
    for part in ("esm/", "heads/"):
        leaves = {k: v for k, v in gaps.items() if k.startswith(part)}
        worst = max(leaves, key=lambda k: leaves[k][0])
        out[part[:-1]] = {"max_rel": leaves[worst][0], "leaf": worst,
                          "l2_median": statistics.median(v[1] for v in leaves.values()),
                          "l2_max": max(v[1] for v in leaves.values())}
    return out


def check_finetune_step() -> dict:
    """K5 inside the finetune step, and the port's attention against eager
    autograd (finetune_step_runs).

    1. K5 in the step: "kernel" against "k1_plain_bwd". Both run K1's
       forward, so the loss and the heads' gradients agree exactly, and the
       backbone's gradients differ only by K5 against its plain version:
       the order of f32 sums before P and dS are rounded to bf16. Every
       leaf within FT_K5_TOL of its largest entry (four bf16 ulps, see
       there), the loss within
       FT_LOSS_TOL relative. The planted fault (K5 dropping the last query
       tile of its dk/dv loop) must fail this; its largest ratio to the
       limit is printed.
    2. The port's attention against eager autograd, which rounds elsewhere
       (P to bf16 before P.V, and dP rather than dS to bf16 in the
       backward): per leaf |g_kernel - g_eager| <= 2 |g_eager - g_f32| +
       FT_GRAD_FLOOR max|g_f32|, the loss alike with FT_LOSS_FLOOR. With
       random weights the attention is near uniform, where bf16 rounds a
       row's probabilities alike, and a head bias whose gradient is small
       beside its sensitivity to the hidden states moves by a third of its
       largest entry between the bf16 and the f32 step: a check of the
       semantics, where 1 checks the kernel.
    Each path's distance from the f32 step (K1 or its plain version, K5
    or its plain version, eager) says which rounding point moves the
    gradients away from the eager step's."""
    out = finetune_step_runs()
    grads = {k: v[1] for k, v in out.items() if k != "shapes"}
    loss = {k: v[0] for k, v in out.items() if k != "shapes"}
    pairs = (("kernel", "k1_plain_bwd"), ("fault", "k1_plain_bwd"), ("kernel", "plain_fwd_k5"),
             ("kernel", "eager"), ("plain", "eager"), ("kernel", "eager_f32"),
             ("k1_plain_bwd", "eager_f32"), ("plain_fwd_k5", "eager_f32"),
             ("plain", "eager_f32"), ("eager", "eager_f32"))
    gaps = {f"{a}_vs_{b}": leaf_gaps(grads[a], grads[b]) for a, b in pairs}
    summary = {name: {"loss_rel": abs(loss[a] - loss[b]) / abs(loss[b]),
                      **gap_summary(gaps[name])}
               for name, (a, b) in zip(gaps, pairs)}
    for name, row in summary.items():
        log(f"[step] finetune {name}: loss relative {row['loss_rel']:.3g}; " + "; ".join(
            f"{part} max|err|/leaf max {row[part]['max_rel']:.4g} ({row[part]['leaf']}), L2 "
            f"relative median {row[part]['l2_median']:.4g}, largest {row[part]['l2_max']:.4g}"
            for part in ("esm", "heads")))
    # 1. K5 against its plain version inside the step, and the planted fault
    tight = {k: v[0] / FT_K5_TOL for k, v in gaps["kernel_vs_k1_plain_bwd"].items()}
    fault = {k: v[0] / FT_K5_TOL for k, v in gaps["fault_vs_k1_plain_bwd"].items()}
    worst, worst_fault = max(tight, key=tight.get), max(fault, key=fault.get)
    loss_k5 = summary["kernel_vs_k1_plain_bwd"]["loss_rel"]
    ok1 = tight[worst] <= 1.0 and loss_k5 <= FT_LOSS_TOL
    # 2. against eager autograd, per leaf, with the f32 step as the anchor
    (lk, gk), (le, ge), (lf, gf) = out["kernel"], out["eager"], out["eager_f32"]
    loss_allowed = 2 * abs(le - lf) + FT_LOSS_FLOOR * abs(lf)
    ratios = {}
    for key in gf:
        err = float((gk[key] - ge[key]).abs().max())
        allowed = (2 * float((ge[key] - gf[key]).abs().max())
                   + FT_GRAD_FLOOR * float(gf[key].abs().max()))
        ratios[key] = err / allowed if allowed > 0 else (0.0 if err == 0 else math.inf)
    worst_eager = max(ratios, key=ratios.get)
    ok2 = abs(lk - le) <= loss_allowed and ratios[worst_eager] <= 1.0
    pep, rec = out["shapes"]
    log(f"[step] finetune step at global batch 256 (pep {pep}, rec {rec}; dropout 0): loss "
        f"through K1/K5 {lk:.6f}, K1 and K5's plain version {loss['k1_plain_bwd']:.6f}, eager "
        f"{le:.6f}, eager f32 {lf:.6f}. K5 against its plain version in the step: loss "
        f"relative {loss_k5:.3g} (tolerance {FT_LOSS_TOL:g}), largest max|err|/leaf max over "
        f"the tolerance {FT_K5_TOL:g}: {tight[worst]:.4g} ({worst}); the planted fault (K5 "
        f"dropping the last query tile of dk/dv): {fault[worst_fault]:.4g} ({worst_fault}) "
        f"{'ok' if ok1 else 'FAIL'}. Against eager: |loss - eager| {abs(lk - le):.3g} "
        f"(allowed {loss_allowed:.3g}), largest gradient ratio to 2|eager - f32| + "
        f"{FT_GRAD_FLOOR:g} max|f32|: {ratios[worst_eager]:.4g} ({worst_eager}) "
        f"{'ok' if ok2 else 'FAIL'}")
    if not ok1:
        raise AssertionError("K5 in the finetune step disagrees with its plain version")
    if fault[worst_fault] <= 1.0:
        raise AssertionError("the finetune step check does not see a K5 that drops a query tile")
    if not ok2:
        raise AssertionError("the finetune step through K1/K5 disagrees with the eager step")
    return {"loss_rel_err": loss_k5, "grad_ratio": tight[worst], "grad_leaf": worst,
            "fault_ratio": fault[worst_fault], "fault_leaf": worst_fault,
            "eager_loss_abs_err": abs(lk - le), "eager_loss_allowed": loss_allowed,
            "eager_grad_ratio": ratios[worst_eager], "eager_grad_leaf": worst_eager,
            "gaps": summary}


# ---------------------------------------------------------------------------
# Phase 9: times
# ---------------------------------------------------------------------------

def time_attention(gen: torch.Generator, gpu: str) -> dict:
    B, T = 16, 512
    seg = padded_segments(B, T)
    # four input sets (4 x 42 MB) so that successive calls miss the 50 MB L2
    sets = [qkv(B, T, gen) for _ in range(4)]
    allowed = ((seg[:, None, :, None] == seg[:, None, None, :])
               & (seg[:, None, None, :] > 0))
    cycle = itertools.cycle(sets)

    def kernel():
        attention.fused_attention(*next(cycle), seg)

    def plain():
        attention.attention_reference(*next(cycle), seg)

    def library():
        q, k, v = (t.transpose(1, 2) for t in next(cycle))
        torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=allowed,
                                                         scale=1.0)

    ms = cuda_ms(kernel, 100)
    plain_ms = cuda_ms(plain, 10)
    library_ms = cuda_ms(library, 50)
    flops = 4 * B * NH * T * T * DH
    nbytes = 4 * B * T * NH * DH * 2 + B * T * 4     # q, k, v read, o written, segments
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    bound_ms = 1e3 * max(t_ops, t_bytes)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    log(f"[time] attention_fwd B={B} T={T} NH={NH}: kernel {ms:.6f} ms, plain "
        f"{plain_ms:.6f} ms, library (scaled_dot_product_attention) {library_ms:.6f} ms, "
        f"bound {bound_ms:.6f} ms ({bound_by}: {flops / 1e9:.4f} GFLOP, "
        f"{nbytes / 1e6:.4f} MB) | {gpu}")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def attention_bwd_bound(B: int, T: int) -> tuple[float, str, str]:
    """(bound ms, what bounds it, the counts): the five (T x T x 32)
    products per (row, head) of the backward (S, dP, dq, dk, dv) in bf16 on
    the tensor cores, against q, k, v, dO read and dq, dk, dv written once
    (bf16) and the segments read."""
    flops = 5 * 2 * B * NH * T * T * DH
    nbytes = 7 * B * T * NH * DH * 2 + B * T * 4
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else "operations",
            f"{flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.4f} MB")


def time_attention_bwd(gen: torch.Generator, gpu: str) -> list[dict]:
    """K5, its plain version, and the backward alone of torch's
    scaled_dot_product_attention with the same boolean mask (a yardstick:
    torch.autograd.grad on a saved graph), at K5_TIME_SHAPES, in device
    time summed by torch.profiler: at the chunk shapes the wrapper's host
    work (checks, allocations, ctypes) outlasts the kernels."""
    rows = []
    for B, T in K5_TIME_SHAPES:
        seg = padded_segments(B, T)
        allowed = ((seg[:, None, :, None] == seg[:, None, None, :])
                   & (seg[:, None, None, :] > 0))
        # four input sets so that successive calls miss the 50 MB L2
        sets = []
        for _ in range(4):
            q, k, v = qkv(B, T, gen)
            do = torch.randn(B, T, NH, DH, device="cuda", generator=gen).bfloat16()
            lq, lk, lv = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
            out = torch.nn.functional.scaled_dot_product_attention(lq, lk, lv, attn_mask=allowed,
                                                                   scale=1.0)
            sets.append((q, k, v, do, (out, (lq, lk, lv), do.transpose(1, 2))))
        cycle = itertools.cycle(sets)

        def kernel():
            q, k, v, do, _ = next(cycle)
            attention.fused_attention_bwd(q, k, v, seg, do)

        def plain():
            q, k, v, do, _ = next(cycle)
            attention.attention_reference_bwd(q, k, v, seg, do)

        def library():
            out, inputs, do = next(cycle)[4]
            torch.autograd.grad(out, inputs, do, retain_graph=True)

        row = {"shape": [B, T, NH, DH], "ms": device_ms(kernel, 100),
               "wall_ms": cuda_ms(kernel, 100), "plain_ms": device_ms(plain, 10),
               "library_ms": device_ms(library, 100)}
        row["bound_ms"], row["bound_by"], counts = attention_bwd_bound(B, T)
        log(f"[time] attention_bwd B={B} T={T} NH={NH}, device time: kernel {row['ms']:.6f} ms "
            f"({row['wall_ms']:.6f} ms per call with the host), plain {row['plain_ms']:.6f} ms, "
            f"library (scaled_dot_product_attention backward) {row['library_ms']:.6f} ms, bound "
            f"{row['bound_ms']:.6f} ms ({row['bound_by']}: {counts}) = "
            f"{100 * row['bound_ms'] / row['ms']:.2f}% of the bound | {gpu}")
        rows.append(row)
    return rows


def maxsim_bound(Ba: int, Bb: int, TA: int, TB: int, D: int) -> tuple[float, str, str]:
    """(bound ms, what bounds it, the counts): 2*Ba*Bb*TA*TB*D f32 FLOP on
    the CUDA cores against tokens, masks and outputs moved once."""
    flops = 2 * Ba * Bb * TA * TB * D
    nbytes = 4 * (Ba * TA * D + Bb * TB * D) + 4 * (Ba * TA + Bb * TB) + 8 * Ba * Bb
    t_ops, t_bytes = flops / H100_F32_FLOPS, nbytes / H100_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else "operations",
            f"{flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.4f} MB")


def time_maxsim(gen: torch.Generator, gpu: str) -> list[dict]:
    """K4 and its plain version at the /topk shape and one full block of the
    ragged scorer. No single PyTorch call computes masked max-sim, so there
    is no library time."""
    rows = []
    for (Ba, Bb, TA, TB), iters in zip(K4_TIME_SHAPES, (50, 5)):
        ha, hb, ma, mb = maxsim_inputs(Ba, Bb, TA, TB, gen)
        ms = cuda_ms(lambda: maxsim.filip_similarity_fused(ha, hb, ma, mb, 1.0), iters)
        plain_ms = cuda_ms(lambda: maxsim.maxsim_reference(ha, hb, ma, mb), 3, warmup=1)
        bound_ms, bound_by, counts = maxsim_bound(Ba, Bb, TA, TB, FILIP_D)
        log(f"[time] filip_maxsim (Ba, Bb, TA, TB)=({Ba}, {Bb}, {TA}, {TB}) D={FILIP_D}: "
            f"kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, library none, bound "
            f"{bound_ms:.6f} ms ({bound_by}: {counts}; f32 peak {H100_F32_FLOPS / 1e12:g} "
            f"TFLOP/s) = {100 * bound_ms / ms:.2f}% of the bound | {gpu}")
        rows.append({"shape": [Ba, Bb, TA, TB, FILIP_D], "ms": ms, "plain_ms": plain_ms,
                     "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by})
    return rows


def time_serving(ctx: dict, rng: np.random.Generator, gpu: str) -> None:
    base = ctx["base"]
    one = synthetic_seqs(rng, [100])
    for _ in range(3):
        embed_json(base, one, "rec")
    lat = []
    for _ in range(30):
        t0 = time.perf_counter()
        embed_json(base, one, "rec")
        lat.append(1e3 * (time.perf_counter() - t0))
    log(f"[time] /embed 1 sequence (100 aa, bucket 128): p50 {statistics.median(lat):.4f} ms "
        f"over 30 requests | {gpu}")
    # the same encode without HTTP and the coalescer: what those layers add
    tok = common.make_tokenizer()
    direct = []
    for _ in range(30):
        t0 = time.perf_counter()
        embed.embed_sequences(ctx["heads"], ctx["esm_params"], one, "rec", ctx["mcfg"], tok,
                              torch.device("cuda"), batch_size=32, pad_batch=True)
        direct.append(1e3 * (time.perf_counter() - t0))
    log(f"[time] embed_sequences 1 sequence without HTTP: p50 "
        f"{statistics.median(direct):.4f} ms over 30 calls | {gpu}")
    batch = ctx["batch32"]
    embed_json(base, batch, "rec")
    dts = []
    for _ in range(10):
        t0 = time.perf_counter()
        embed_json(base, batch, "rec")
        dts.append(time.perf_counter() - t0)
    log(f"[time] /embed batch 32 (50-299 aa): {32 / statistics.median(dts):.4f} seqs/s "
        f"(median of 10 requests) | {gpu}")


def time_filip_serving(ctx: dict, fctx: dict, rng: np.random.Generator, gpu: str) -> None:
    """/topk --filip for one query, and its parts called without HTTP: the
    token encode, the ragged scorer (host densify + copy + kernel), and the
    kernel alone at the scorer's shape."""
    base = fctx["base"]
    one = synthetic_seqs(rng, [100])
    before = maxsim.filip_similarity_fused.launches
    for _ in range(3):
        post_json(base, "/topk", {"queries": one, "side": "pep", "k": 10})
    lat = []
    for _ in range(30):
        t0 = time.perf_counter()
        post_json(base, "/topk", {"queries": one, "side": "pep", "k": 10})
        lat.append(1e3 * (time.perf_counter() - t0))
    launches = maxsim.filip_similarity_fused.launches - before
    log(f"[time] /topk --filip 1 query (100 aa, bucket 128) over 256 sequences, k=10: p50 "
        f"{statistics.median(lat):.4f} ms over 30 requests; {launches} filip_maxsim launches "
        f"in 33 requests | {gpu}")

    tok, dev = common.make_tokenizer(), torch.device("cuda")

    def p50(fn, n=30):
        dts = []
        for _ in range(n + 3):
            t0 = time.perf_counter()
            fn()
            dts.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(dts[3:])

    q_t, q_m = embed.embed_sequences_tokens(fctx["fheads"], ctx["esm_params"], one, "pep",
                                            fctx["fcfg"], tok, dev, batch_size=32,
                                            pad_batch=True)
    encode_ms = p50(lambda: embed.embed_sequences_tokens(
        fctx["fheads"], ctx["esm_params"], one, "pep", fctx["fcfg"], tok, dev,
        batch_size=32, pad_batch=True))
    with np.load(fctx["index_path"]) as index:
        flat, lengths = index["tokens"], index["lengths"]
    t = fctx["fheads"]["temperature"]
    scorer_ms = p50(lambda: retrieval.filip_score_matrix_ragged(q_t, q_m, flat, lengths, t,
                                                                device=dev))
    tb = 64 * math.ceil(int(lengths.max()) / 64)
    hb = torch.zeros(len(lengths), tb, FILIP_D, device=dev)
    mb = (torch.arange(tb, device=dev)[None, :]
          < torch.from_numpy(lengths).to(dev)[:, None]).to(torch.int32)
    qt, qm = torch.from_numpy(q_t).to(dev), torch.from_numpy(q_m).to(dev).to(torch.int32)
    kernel_ms = cuda_ms(lambda: maxsim.filip_similarity_fused(qt, hb, qm, mb, t), 50)
    log(f"[time] /topk --filip parts without HTTP, p50 of 30 calls: token encode "
        f"{encode_ms:.4f} ms; ragged scorer {scorer_ms:.4f} ms, of which the kernel at "
        f"(1, {len(lengths)}, {q_t.shape[1]}, {tb}) takes {kernel_ms:.6f} ms and the host "
        f"densify, copies and sync {scorer_ms - kernel_ms:.4f} ms | {gpu}")
    corpus = fctx["corpus"]
    dts = []
    for _ in range(3):
        t0 = time.perf_counter()
        embed.embed_sequences_tokens_ragged(fctx["fheads"], ctx["esm_params"], corpus, "rec",
                                            fctx["fcfg"], tok, dev, batch_size=32)
        dts.append(time.perf_counter() - t0)
    log(f"[time] embed --filip encode of the 256-sequence corpus (30-499 aa, batch 32, "
        f"ragged): {len(corpus) / statistics.median(dts):.4f} seqs/s (median of 3) | {gpu}")


def device_ms(fn, iters: int, warmup: int = 3) -> float:
    """Device time of fn() per call: the CUDA kernels' self time summed by
    torch.profiler over iters calls. Host work between launches (autograd,
    allocation, ctypes) is left out; cuda_ms includes it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages())
    if total_us <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    return total_us / 1e3 / iters


def infonce_bound(B: int, D: int) -> tuple[float, str, str]:
    """(bound ms, what bounds it, the counts) of forward plus backward: the
    logits, dX and dY, 6 B^2 D f32 FLOP on the CUDA cores, against x, y read
    and dX, dY, the loss written once."""
    flops = 6 * B * B * D
    nbytes = 16 * B * D + 4
    t_ops, t_bytes = flops / H100_F32_FLOPS, nbytes / H100_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else "operations",
            f"{flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.4f} MB")


def time_infonce(gen: torch.Generator, gpu: str) -> dict:
    """K2 at (256, 128), K3 at (1024, 128) and (4096, 128), forward plus
    backward through autograd, and the plain clip_infonce the same way. No
    single PyTorch call computes symmetric InfoNCE, so there is no library
    time."""
    rows = {}
    for name, B in (("infonce", 256), ("infonce_tiled", 1024), ("infonce_tiled", 4096)):
        fn = infonce.fused_infonce if name == "infonce" else infonce.fused_infonce_tiled
        x, y = (t.requires_grad_(True) for t in unit_rows(B, 128, 1.0, gen))

        def kernel():
            torch.autograd.grad(fn(x, y), (x, y))

        def plain():
            torch.autograd.grad(infonce.clip_infonce(x, y), (x, y))

        iters = 200 if B <= 1024 else 50
        row = {"shape": [B, 128], "ms": device_ms(kernel, iters),
               "wall_ms": cuda_ms(kernel, iters), "plain_ms": device_ms(plain, iters),
               "plain_wall_ms": cuda_ms(plain, iters), "library_ms": None}
        row["fwd_ms"] = device_ms(lambda: fn(x.detach(), y.detach()), iters)
        row["bound_ms"], row["bound_by"], counts = infonce_bound(B, 128)
        log(f"[time] {name} B={B} D=128 forward+backward: kernel {row['ms']:.6f} ms of device "
            f"time ({row['wall_ms']:.6f} ms per call with the host), forward alone "
            f"{row['fwd_ms']:.6f} ms; plain {row['plain_ms']:.6f} ms ({row['plain_wall_ms']:.6f} "
            f"ms with the host); library none; bound {row['bound_ms']:.6f} ms ({row['bound_by']}: "
            f"{counts}; f32 peak {H100_F32_FLOPS / 1e12:g} TFLOP/s) = "
            f"{100 * row['bound_ms'] / row['ms']:.2f}% of the bound | {gpu}")
        rows.setdefault(name, []).append(row)
    return rows


def time_dispatch(gen: torch.Generator, gpu: str) -> list[dict]:
    """K2 and K3 forward+backward on the same inputs at each pool of
    DISPATCH_POOLS: the readings that clip_engine.fused_infonce_fits' split
    rests on (the faster by device time, and what the rule picks)."""
    rows = []
    for B in DISPATCH_POOLS:
        x, y = (t.requires_grad_(True) for t in unit_rows(B, 128, 1.0, gen))
        row = {"pool": B, "picked": loss_kernel(B)}
        for name, fn in (("infonce", infonce.fused_infonce),
                         ("infonce_tiled", infonce.fused_infonce_tiled)):
            def run():
                torch.autograd.grad(fn(x, y), (x, y))
            row[name] = {"ms": device_ms(run, 100), "wall_ms": cuda_ms(run, 100)}
        row["faster"] = min(("infonce", "infonce_tiled"), key=lambda k: row[k]["ms"])
        log(f"[time] dispatch B={B} D=128 forward+backward: infonce {row['infonce']['ms']:.6f} "
            f"ms of device time ({row['infonce']['wall_ms']:.6f} ms with the host), "
            f"infonce_tiled {row['infonce_tiled']['ms']:.6f} ms "
            f"({row['infonce_tiled']['wall_ms']:.6f} ms); faster by device time "
            f"{row['faster']}, the rule picks {row['picked']} | {gpu}")
        rows.append(row)
    return rows


def time_train_steps(tctx: dict, run: str, what: str, gpu: str) -> float:
    """pairs/s of a global-batch-256 step over a run's steps after the
    first: the card's time between the events recorded after consecutive
    steps, with no sync inside the epoch."""
    torch.cuda.synchronize()
    ends = tctx[run]["ends"]
    dts = [a.elapsed_time(b) / 1e3 for a, b in zip(ends, ends[1:])]
    rate = 256 / statistics.median(dts)
    log(f"[time] {what} at global batch 256 (t30_150M bf16, 16 chunks): {rate:.4f} pairs/s, "
        f"median of {len(dts)} steps after the first ({1e3 * min(dts):.2f}-"
        f"{1e3 * max(dts):.2f} ms per step, by CUDA events); fixture {tctx['profile']} | {gpu}")
    return rate


def stop(server_ctx: dict) -> None:
    server_ctx["server"].shutdown()
    server_ctx["server"].server_close()
    server_ctx["thread"].join(timeout=60)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; none is visible", file=sys.stderr)
        return 1
    # the plain versions' f32 products run in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    gpu = gpu_line()
    log(f"[build] {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        reports = list(pool.map(build.build, KERNELS))
    for name, report in zip(KERNELS, reports):
        log(f"[build] {name}: {build.library_path(name)}\n{report.strip()}")
    log(f"[build] done in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    max_err = check_attention(gen)
    k4_err = check_maxsim(gen)
    nce_err = check_infonce(gen)
    k5_err = check_attention_bwd(gen)
    rng = np.random.default_rng(SEED)
    ctx = run_serve_phase(rng)
    try:
        check_end_to_end(ctx)
        fctx = run_filip_phase(ctx, rng)
        try:
            check_filip_end_to_end(ctx, fctx)
            tctx = run_train_phase()
            steps = {"k2": check_step(256), "k3": check_step(1024),
                     "finetune": check_finetune_step()}
            times = time_attention(gen, gpu)
            k5_times = time_attention_bwd(gen, gpu)
            k4_times = time_maxsim(gen, gpu)
            nce_times = time_infonce(gen, gpu)
            dispatch = time_dispatch(gen, gpu)
            time_serving(ctx, rng, gpu)
            time_filip_serving(ctx, fctx, rng, gpu)
            pairs_per_s = {run: time_train_steps(tctx, run, what, gpu) for run, what in (
                ("k2", "frozen train step (4 length groups)"),
                ("finetune", "finetune step (one pad bucket, remat)"),
                ("lora", f"LoRA step (rank {LORA_RANK}, one pad bucket, remat)"))}
        finally:
            stop(fctx)
    finally:
        stop(ctx)
        shutil.rmtree(WORK, ignore_errors=True)

    paths = {"serve": ctx["launches"], "filip_serve": fctx["launches"],
             "train_256": tctx["k2"]["launches"], "train_1024": tctx["k3"]["launches"],
             "train_finetune": tctx["finetune"]["launches"],
             "train_lora": tctx["lora"]["launches"]}
    by_path = {name: {path: counts.get(name, 0) for path, counts in paths.items()}
               for name in ("attention_fwd", "attention_bwd", "filip_maxsim", "infonce",
                            "infonce_tiled")}
    kernels = [{
        "name": "attention_fwd", "phase": "serve", "route": "cuda",
        "source": "protein_clip_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "protein_clip_tpu/ops/attention_pallas.py:105",
        "launches": ctx["launches"]["attention_fwd"],
        "launches_by_path": by_path["attention_fwd"], "max_abs_err": max_err, **times,
    }, {
        "name": "attention_bwd", "phase": "train_finetune", "route": "cuda",
        "source": "protein_clip_tpu_torch/csrc/attention_bwd.cu",
        "replaces": "protein_clip_tpu/ops/attention_pallas.py:287",
        "launches": tctx["finetune"]["launches"]["attention_bwd"],
        "launches_by_path": by_path["attention_bwd"], "max_abs_err": k5_err, **k5_times[0],
        "at_chunks": k5_times[1:], "step_check": steps["finetune"],
        "finetune_pairs_per_s": pairs_per_s["finetune"], "lora_pairs_per_s": pairs_per_s["lora"],
    }, {
        "name": "filip_maxsim", "phase": "filip_serve", "route": "cuda",
        "source": "protein_clip_tpu_torch/csrc/filip_maxsim.cu",
        "replaces": "protein_clip_tpu/ops/filip_pallas.py:33",
        "launches": fctx["launches"]["filip_maxsim"],
        "launches_by_path": by_path["filip_maxsim"], "max_abs_err": k4_err,
        **{key: k4_times[0][key] for key in ("shape", "ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")},
        "scorer_block": k4_times[1],
    }, {
        "name": "infonce", "phase": "train_256", "route": "cuda",
        "source": "protein_clip_tpu_torch/csrc/infonce.cu",
        "replaces": "protein_clip_tpu/ops/infonce_pallas.py:30",
        "launches": tctx["k2"]["launches"]["infonce"],
        "bwd_launches": tctx["k2"]["bwd"]["infonce"],
        "launches_by_path": by_path["infonce"], "max_abs_err": nce_err["infonce"],
        **nce_times["infonce"][0], "step_check": steps["k2"],
        "train_pairs_per_s": pairs_per_s["k2"], "dispatch": dispatch,
    }, {
        "name": "infonce_tiled", "phase": "train_1024", "route": "cuda",
        "source": "protein_clip_tpu_torch/csrc/infonce.cu",
        "replaces": "protein_clip_tpu/ops/infonce_pallas.py:128",
        "launches": tctx["k3"]["launches"]["infonce_tiled"],
        "bwd_launches": tctx["k3"]["bwd"]["infonce_tiled"],
        "launches_by_path": by_path["infonce_tiled"], "max_abs_err": nce_err["infonce_tiled"],
        **nce_times["infonce_tiled"][0], "at_4096": nce_times["infonce_tiled"][1],
        "step_check": steps["k3"],
    }]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(gpu_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
