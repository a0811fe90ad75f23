#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one GPU and hold every
hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, in order; a failure in any of them ends the run with a traceback
and a nonzero exit code, and no result line:

1. build    compile every kernel under protein_clip_tpu_torch/csrc/ with
            nvcc for sm_90a; print the card's name and power limit.
2. kernels  K1 (segment-masked attention forward) against
            ops.attention.attention_reference at the serving shapes
            (NH=20, dh=32, bf16), with padded rows (fully padded query rows
            included) and packed rows (several segments, gap zeros).
3. serve    ESM-2 t30_150M in bf16 with seeded random weights and CLIP
            heads, written as npz; an index of 256 synthetic sequences built
            with cli.embed; cli.serve's server on an ephemeral port answers
            /healthz, single-sequence /embed at the 64/128/512/2048 buckets
            on both sides, a 32-sequence /embed, the binary wire, /topk and
            16 concurrent clients. The K1 launch count must be 30 per
            backbone forward.
4. e2e      the served embeddings against the same sequences encoded with
            attention_impl="eager": cosine >= 0.999 per row.
5. times    K1, its plain version and torch's scaled_dot_product_attention
            at B=16, T=512, NH=20 beside K1's bound; /embed p50 for one
            sequence, and the same encode called without HTTP; seqs/s at
            batch 32.

The last two lines of standard output are the kernels line (one JSON
object per hand-written kernel) and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
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

from protein_clip_tpu_torch.cli import common, embed, serve
from protein_clip_tpu_torch.kernels import build
from protein_clip_tpu_torch.models import clip, esm2
from protein_clip_tpu_torch.ops import attention
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
H100_BF16_FLOPS = 989e12              # dense tensor-core peak, SXM, 700 W
H100_BYTES_PER_S = 3.35e12
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


# ---------------------------------------------------------------------------
# Phase 3: the serving path
# ---------------------------------------------------------------------------

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

    # Count backbone forwards beside the kernel's launches.
    forwards = []
    plain_forward = esm2.forward

    def counted_forward(params, ids, mask, c):
        forwards.append(tuple(ids.shape))
        return plain_forward(params, ids, mask, c)

    esm2.forward = counted_forward
    attention.fused_attention.launches = 0
    embed.main(model_args + ["--fasta", str(fasta), "--side", "rec",
                             "--out", str(WORK / "index.npz")])
    args = serve.build_argparser().parse_args(
        model_args + ["--index", str(WORK / "index.npz"), "--port", "0"])
    server = serve.make_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    out: dict = {"base": base, "server": server, "thread": thread, "mcfg": mcfg,
                 "esm_params": esm_params, "heads": heads}

    health = json.loads(call(base, "/healthz")[1])
    assert health["status"] == "ok" and health["index_size"] == 256, health
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

    esm2.forward = plain_forward
    launches = attention.fused_attention.launches
    if not forwards or launches != cfg.num_layers * len(forwards):
        raise AssertionError(f"attention_fwd launched {launches} times for "
                             f"{len(forwards)} backbone forwards; want "
                             f"{cfg.num_layers} per forward")
    log(f"[serve] {len(forwards)} backbone forwards, attention_fwd launches {launches} "
        f"= {cfg.num_layers} per forward")
    out.update(launches=launches, singles=singles, batch32=batch32, emb32=emb32)
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
# Phase 5: times
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; none is visible", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    gpu = gpu_line()
    log(f"[build] {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    report = build.build("attention_fwd")
    log(f"[build] attention_fwd: {build.library_path('attention_fwd')}\n{report.strip()}")
    log(f"[build] done in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    max_err = check_attention(gen)
    rng = np.random.default_rng(SEED)
    ctx = run_serve_phase(rng)
    try:
        check_end_to_end(ctx)
        times = time_attention(gen, gpu)
        time_serving(ctx, rng, gpu)
    finally:
        ctx["server"].shutdown()
        ctx["server"].server_close()
        ctx["thread"].join(timeout=60)
        shutil.rmtree(WORK, ignore_errors=True)

    kernels = [{
        "name": "attention_fwd", "phase": "serve", "route": "cuda",
        "source": "protein_clip_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "protein_clip_tpu/ops/attention_pallas.py:105",
        "launches": ctx["launches"], "max_abs_err": max_err, **times,
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
