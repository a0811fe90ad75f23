#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one GPU and
hold every hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, in order; a failure in any of them ends the run with a traceback
and a nonzero exit code, and no result line:

1. build        compile every kernel under protein_clip_tpu_torch/csrc/ with
                nvcc for sm_90a, one nvcc per source, all at once, and
                beside them the planted faults (FAULTS), each built from a
                patched copy under _build/fault/<name>/, never loaded by
                the package: dense_mm and ffn_gelu whose shared main loop
                drops its last k-tile; attention_fwd and attention_bwd whose
                swept loop (K1's keys, K5's dk/dv queries) drops its last
                tile; attention_fwd and attention_bwd whose skip predicate
                is off by one at a segment boundary; filip_maxsim whose
                b-tile skip predicate misses a tile's first token, and
                filip_maxsim in plain TF32 (the two correction products
                dropped); infonce in plain TF32, and infonce whose
                cross-block sums of the forward's partials drop the last,
                partial tile; print the card's name and power limit.
2. kernels      K1 (segment-masked attention forward) against
                ops.attention.attention_reference at the serving shapes
                and at T around a tile (65, 127, 128, 129) (NH=20, dh=32,
                bf16), with padded rows (fully padded query rows included)
                and packed rows (several segments, gap zeros), among them
                the packed paths' own chunks (path_segments): the last
                chunk of each side of cli.main --packed's first global
                batch on the fixture, (16, 128) and (16, 256) with their
                all-<pad> rows, the last pep chunk of cli.main --packed
                --finetune's, (48, 128), and a (16, 512) and a (28, 2048)
                receptor chunk of tools/bench_train's draws; its statistics
                against attention_reference_lse (LSE_ATOL). K4 (FILIP masked max-sim) against
                ops.filip.maxsim_reference at the scorer's shapes (D=128,
                f32), with padded masks, an all-masked a-row and b-row, a
                b-row whose second tile holds one valid token, token counts
                that are not multiples of 64, (K4_SHORT_SHAPES) tokens
                of norm 2 with 1-4 valid tokens a row, where plain TF32's
                error shows past K4_ATOL, and (K4_EMPTY_SHAPES) a query
                with no valid token at the /topk grid. K2 and K3
                (InfoNCE, forward and backward through autograd) against
                ops.infonce.clip_infonce: unit rows scaled by exp(t/2) for
                t in {1, 4}, K2 at B in {16, 100, 256, 512}, K3 at B in
                {1000, 1024, 2048, 4096}, D=128, and each at D=64 once;
                both planted InfoNCE faults must fail that check (the
                partial-tile fault every case at B = 100 and 1000).
                K5 (segment-masked attention backward) against
                ops.attention.attention_reference_bwd at the finetune
                chunks' shapes (16 rows at the pep and rec buckets 32 and
                192), at K1's timing shape and at odd T, NH=20, bf16, with
                padded, fully padded and packed rows, and on the packed
                unfrozen path's four chunks above, fed K1's statistics. P1 (dense_mm) s8 ->
                s32 against ops.dense_mm.mm_reference to the bit at the
                probe's (8192, 2560, 2560), at N in {1, 128, 1000, 3072,
                10240} tokens through t30_150M's three layer shapes, at the
                main loop's edges (EDGE_SHAPES: N around its 64- and
                256-row blocks, K below, at and past one ring stage, M = 8
                and M no multiple of its blocks' columns) and at the extreme
                values; bf16 -> f32 within MM_BF16_TOL of |x| @ |w| at the
                probe's shape, the three layer shapes at 128 and 10240
                tokens and the edges. K6 (ffn_gelu) against
                ops.ffn.dense_gelu_reference at N in {64, 128, 3072, 10240},
                H=640, M=2560, erf and tanh, and at the edges (erf):
                FFN_ULPS bf16 ulps per output and at most FFN_SHARE of them
                off; the plain version with either epilogue rounding skipped
                must fail that. Then each check against its planted faults,
                which must fail it (by how much is printed): P1 and K6
                against their main loop's, K1 and K5 against the swept-loop
                and the skip faults (the skip fault every packed case,
                both faults every chunk of the packed unfrozen path), K4
                against its skip fault (every case with the one-token tile)
                and its plain-TF32 fault, K2 and K3 against theirs.
3. serve        ESM-2 t30_150M in bf16 with seeded random weights and CLIP
                heads, written as npz; an index of 256 synthetic sequences
                built with cli.embed; cli.serve's server on an ephemeral port
                answers /healthz, single-sequence /embed at the
                64/128/512/2048 buckets on both sides, a 32-sequence /embed,
                the binary wire, /topk and 16 concurrent clients. The K1
                launch count must be 30 per backbone forward, and P1 and K6
                must not launch.
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
                batch, each on its own pools; P1 and K6 never. cli.embed then
                embeds with run 1's best_model.npz. Then the unfrozen modes
                on the same fixture: cli.main --finetune and cli.main
                --lora-rank 8 at the defaults (global batch 256 in one pad
                bucket, 16 chunks, remat, two learning rates), one epoch
                each, with the same artifact checks; per step K1 launches 30
                times per pass-1 forward and 60 per pass-2 chunk (forward and
                remat recompute), K5 30 times per pass-2 chunk, K2 once
                forward and once backward; per eval batch K1 60 times and K2
                once. cli.embed embeds with each run's best_model.npz (the
                finetuned backbone; the adapters merged into the base).
                Then cli.main --packed at the defaults (global batch 256,
                flat packing, chunks of 16 packed rows) for one epoch: the
                artifacts; the backbone's chunk forwards, and K1 30 times
                each, exactly as many as the loaders' batches take when
                packed again here (packed_epoch_chunks); K2 once forward
                and once backward per step and once forward per eval batch;
                cli.embed with its best_model.npz. The 256 pairs' pooled
                embeddings through embed_packed (K1 on packed segments)
                against the grouped path (K1 on padded rows): cosine >=
                COSINE_MIN per row; one packed step run twice from the same
                state and generator seed gives the same loss and heads to
                the bit; one packed and one grouped step under
                torch.profiler: kernel launches and device busy share.
                Then cli.main --packed --finetune and --packed --lora-rank
                8 at the defaults for one epoch each: the artifacts; the
                chunk forwards of each pass exactly as many as the loaders'
                batches take when packed again here by the unfrozen step's
                constant-token rule (unfrozen_chunks: 9 a pass on the
                fixture); per step K1 30 times per pass-1 chunk and 60 per
                pass-2 chunk, K5 30 per pass-2 chunk, K2 once forward and
                once backward; per eval batch K1 30 per chunk forward and
                K2 once; cli.embed with each run's best_model.npz; one
                packed finetune step under torch.profiler: launches, busy
                share and peak memory.
                Then FILIP training: cli.main_2protein_filip for one epoch
                on a fixture of 1100 families (protein1/protein2), at its
                defaults (batch 10, one pad bucket, 1 chunk) and at its
                documented scale-up with DCL (--batch-size 128 --num-chunks
                8 --length-groups 4 --use-dcl): the artifacts; K1 30 times
                per backbone forward (2 forwards a batch at 10, 16 at 128),
                K4 groups^2 times per step and per eval batch, no other
                kernel (FILIP's loss is plain PyTorch). K4 against its
                plain version on the path's own blocks (the first train
                batch encoded by each run's best heads: (10, 10, 32, 192)
                and the grouped run's 16 rectangular blocks), on the first
                and last of them with an emptied a-row and b-row, with tied
                tokens, with b-row 0 cut to 65 tokens and at norm 2 with
                1-4 valid tokens a row; both planted K4 faults must fail
                it (the skip fault every case with a one-token tile, plain
                TF32 every short case). The max-sim backward through the
                wrapper against autograd through maxsim_reference in
                float64 on the card, on those blocks with tokens rounded to
                1/16 and tied (exact scores, the same ties), with the
                path's masks and with emptied rows: MAXSIM_BWD_RTOL.
                cli.retrieve --filip with the batch-10 run's best_model.npz
                against the plain max-sim.
8. step check   one default train step with K2 and one with the plain loss
                from the same heads and batch (dropout 0, Adam lr 1e-3), at
                256 and, with K3, at 1024, and one packed step with K2 at
                256: loss within 1e-5 relative,
                gradients within 1e-5 of each leaf's largest, parameters
                within the bound Adam's first update puts on them. One
                finetune step at 256 (dropout 0) from the same weights and
                batch through K1/K5, through their plain versions in the
                same autograd Function, through each kernel with the other's
                plain version, through K5's swept-loop fault build (its
                dk/dv loop drops the last query tile), and with
                attention_impl="eager" in bf16 and f32. Every leaf of the
                K1/K5 step within FT_K5_TOL of its largest entry of the
                step through K1 and K5's plain version, the loss within
                FT_LOSS_TOL, and the planted fault past that; against the
                eager step, per leaf within
                twice the eager step's distance from the f32 step plus 1e-2
                of the leaf's largest entry (check_finetune_step says why).
                The same checks on the packed finetune step over the same
                256 pairs (9 chunks a pass), whose K1/K5 step, run twice,
                must give the same loss and gradients to the bit. One FILIP
                step of each FILIP run's configuration on its first batch
                (dropout 0.1 from a seeded generator) through K4 against the
                same step through K4's plain version in the same autograd
                Function: the loss within FILIP_STEP_TOL relative and each
                head gradient within FILIP_STEP_TOL of the step's largest
                entry; run again, equal to the bit; the same step through
                each planted K4 fault is printed.
9. int8 serve   cli.serve --esm-dtype int8 over phase 3's weights and index
                (the w8a8 backbone: every quantised linear layer runs P1):
                /healthz, phase 3's single sequences, its 32-sequence
                /embed and /topk. P1 launches 180 times per backbone forward
                (q, k, v, o, wi, wo in 30 layers) and K1 30; the served
                embeddings equal, to the bit, the same sequences encoded
                through P1's plain version on the card; per-row cosine
                against phase 3's bf16 embeddings >= INT8_COSINE_MIN.
10. int8 train  cli.main --esm-dtype int8 for one epoch on a fixture of
                1100 families: three frozen steps at global batch 256 and
                20 eval batches; finite losses, the run's artifacts; P1
                launches 180 times per backbone forward (32 forwards per
                step, 8 per eval batch), K1 30; K2 once forward and once
                backward per step.
11. K6 serve    phase 3's server and requests with PCT_FFN_PALLAS=1 set for
                the phase: K6 launches 30 times per backbone forward (every
                FFN's wi + gelu), and the embeddings reach cosine >= 0.999
                per row against the gate off.
12. times       K1 (with and without its statistics), its plain version
                and torch's scaled_dot_product_attention at B=16, T=512,
                NH=20, padded and dense (one segment), beside K1's bound on
                the run's segments and the exponential floor at the card's
                clocks.max.sm; K4 and its plain version at four queries,
                the /topk shape and a full scorer block, beside K4's bound
                on the run's masks (3xTF32 products of the allowed pairs);
                K2 forward+backward
                at (256, 128), K3 at (1024, 128) and (4096, 128), and their
                plain versions, beside the bound (3xTF32 products at the TF32
                peak), the old design's CUDA-core ceiling, the device kernels
                a call runs (torch.profiler) and the launch floor (those
                kernels times an empty kernel's device time), with the host
                (wall_ms) and without; K2 (up to its 512) and K3 side by
                side at B in {16, 128, 256, 384, 512, 1024, 2048}, the
                readings behind the dispatch rule; K5, its plain version and the
                backward of torch's scaled_dot_product_attention at B=16,
                T=512, NH=20 and at the finetune chunks' shapes, padded, and
                at (16, 512) dense, and on the packed unfrozen path's (16,
                256) and (28, 2048) chunks, beside K5's bound and
                exponential floor. P1 s8 at (8192, 2560, 2560) and (10240, 640, 2560)
                against torch._int_mm (W k-major), P1 bf16 at (8192, 2560, 2560)
                against torch.matmul, K6 at (10240, 640, 2560) against
                torch.addmm + gelu, each with its plain version and bound;
                P1 s8 and K6 at 128 tokens through the three layer shapes
                (device time by torch.profiler: a call there is shorter than
                its host side) beside the same library calls and bounds.
                /embed p50 for one sequence, the same encode called without
                HTTP, and seqs/s at batch 32, for bf16, int8 and
                PCT_FFN_PALLAS=1; FILIP /topk p50 for one query, and its
                parts called without HTTP. The train step in pairs/s at
                global batch 256 (median over the steps after the first of
                run 1, by CUDA events recorded after each step, with no sync
                inside the epoch), and the same for the packed, finetune,
                LoRA, packed finetune, packed LoRA and int8 runs. The FILIP
                runs' pairs/s (batch 10 and 128) by the same events; K4 on
                the first and last block of each FILIP step (call, device
                time, plain version, bound); the plain max-sim backward of
                one step's blocks by CUDA events and device time, and its
                share of the step; one FILIP step of each under
                torch.profiler: launches and busy share.

The last three lines of standard output are the card's name and power
limit, the kernels line (one JSON object per hand-written kernel) and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import dataclasses
import functools
import itertools
import json
import math
import os
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
from protein_clip_tpu_torch.cli import main_2protein_filip as filip_cli
from protein_clip_tpu_torch.data import dataset
from protein_clip_tpu_torch.data.fasta import sequences_only
from protein_clip_tpu_torch.data.prefetch import to_device
from protein_clip_tpu_torch.data.synthetic import write_fixture
from protein_clip_tpu_torch.eval import retrieval
from protein_clip_tpu_torch.kernels import build
from protein_clip_tpu_torch.models import clip, esm2, filip
from protein_clip_tpu_torch.ops import attention, dense_mm, ffn, infonce
from protein_clip_tpu_torch.ops import filip as maxsim
from protein_clip_tpu_torch.tools import bench_train
from protein_clip_tpu_torch.train import (checkpoint, clip_engine, filip_engine, finetune, lora,
                                          optimizer, packed_engine)
from protein_clip_tpu_torch.train.checkpoint import export_npz

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "_smoke_work"
SEED = 0
NH, DH = 20, 32                       # t30_150M attention
KERNEL_SHAPES = ((1, 64), (16, 128), (16, 512), (4, 2048), (3, 65), (3, 127), (3, 128), (3, 129))
# K1 vs its plain version, both bf16 out: |err| <= ATOL_RMS * rms(ref) +
# RTOL * |ref|. The kernel normalises after P.V and the plain version before
# the bf16 cast of P, so they differ by bf16 rounding of P (the absolute
# term, which shrinks with the output's scale as T grows) and of the output
# (a bf16 ulp is 2^-7 relative, within RTOL). Emulating the kernel's
# rounding on the CPU at these shapes needs an absolute term of 0.016-0.019
# rms(ref); a kernel that drops the last key tile needs 2.4 rms(ref) or more.
ATOL_RMS, RTOL = 2 ** -5, 2e-2
# K1's statistics (base-2 log-sum-exp of a query's masked scores, values of
# a few units) against attention_reference_lse: the kernel sums
# ex2.approx terms (2^-22 relative) over 64-key tiles, the plain version
# takes one f32 logsumexp; 1e-4 is some 100 f32 ulps at these values.
LSE_ATOL = 1e-4
COSINE_MIN = 0.999
# K4 (3xTF32 on the tensor cores) against its plain version (f32 products),
# in means of maxima of dot products of tokens of norm <= 2: 3xTF32 keeps
# about f32's accuracy (a numpy emulation of the kernel's split is within
# K4_ATOL / 10 of the JAX kernel, tests/test_torch_filip.py). Plain TF32
# (the planted fault maxsim_tf32) errs by 0.3-1.0 x K4_ATOL at unit norm
# over long masks, where the means average its error out, and by 12-16 x
# at norm 2 over 1-4 valid tokens a row (K4_SHORT_SHAPES), on an H100.
K4_ATOL = 2e-5
K4_SHAPES = ((1, 256, 128, 512), (4, 256, 320, 512), (16, 64, 32, 2048),
             (64, 1024, 256, 192), (5, 300, 77, 333))    # (Ba, Bb, TA, TB)
K4_SHORT_SHAPES = ((8, 256, 64, 192), (1, 256, 128, 512))
K4_SHORT_SCALE = 2.0
K4_EMPTY_SHAPES = ((1, 256, 128, 512),)  # a query with no valid token
# four queries, the /topk shape and one full block of the ragged scorer
K4_TIME_SHAPES = ((4, 256, 128, 512), (1, 256, 128, 512), (64, 1024, 256, 256))
FILIP_D = 128
FILIP_COSINE_MIN = 0.99
H100_BF16_FLOPS = 989e12              # dense tensor-core peak, SXM, 700 W
H100_F32_FLOPS = 67e12                # f32 on the CUDA cores (no tensor cores), SXM
H100_TF32_FLOPS = 495e12              # dense tensor-core peak, SXM, 700 W
H100_BYTES_PER_S = 3.35e12
H100_INT8_OPS = 1979e12               # dense tensor-core peak, SXM, 700 W
KERNELS = ("attention_fwd", "attention_bwd", "filip_maxsim", "infonce", "dense_mm", "ffn_gelu")
# K2/K3 against their plain version, both f32 (3xTF32 products on the
# tensor cores against cuBLAS f32 and logsumexp: the same sums in another
# order, over up to 4096 terms): |loss - ref| <= 1e-5 max(1, |ref|),
# |grad - ref| <= 1e-5 max|ref|. The planted faults (plain TF32; a
# cross-block sum that drops the last, partial tile) fail it.
INFONCE_RTOL = 1e-5
K2_POOLS, K3_POOLS = (16, 100, 256, 512), (1000, 1024, 2048, 4096)
DISPATCH_POOLS = (16, 128, 256, 384, 512, 1024, 2048)    # K2 and K3 timed side by side
FIXTURE_FAMILIES = 3000
TRAIN_LR = 1e-3
LORA_RANK = 8
# K5 at (B, T): the finetune chunks at the fixture's pep and rec buckets, K1's
# timing shape, odd T and a long row
K5_SHAPES = ((16, 32), (16, 192), (16, 512), (1, 1), (3, 63), (2, 200), (1, 2048), (3, 65),
             (3, 127), (3, 128), (3, 129))
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
# P1: the probe's shape and t30_150M's linear layers (K, M) = q/k/v/o, wi, wo
# at serving and training token counts. s8 -> s32 is exact: equal to its
# plain version to the bit. bf16 -> f32: the same f32 products summed in
# another order, |err| <= MM_BF16_TOL (|x| @ |w|), the scale of a sum's
# rounding error.
T30_LAYERS = ((640, 640), (640, 2560), (2560, 640))
P1_SHAPES = ((8192, 2560, 2560),) + tuple((n, k, m) for n in (1, 128, 1000, 3072, 10240)
                                          for k, m in T30_LAYERS)
P1_BF16_SHAPES = ((8192, 2560, 2560), (1000, 2560, 640), (1, 640, 640)) + tuple(
    (n, k, m) for n in (128, 10240) for k, m in T30_LAYERS)
# The main loop's edges (csrc/mma_gemm.cuh), as (N, K, M) for s8: N around
# its 64- and 256-row blocks; K below, at and past one 128-byte ring stage
# (32, 128, 160 s8); M = 8 and M no multiple of its blocks' 64 or 128
# columns. bf16 P1 and K6 take K // 2 (16, 64, 80).
EDGE_SHAPES = tuple((n, k, m) for n in (1, 127, 129) for k, m in ((32, 8), (128, 200), (160, 72)))
MM_BF16_TOL = 1e-5
# K6 against its plain version, both bf16 out, at t30_150M's wi (H = 640, M
# = 2560): every output within FFN_ULPS bf16 ulps of max(|x @ w|, |b|,
# |ref|), and at most FFN_SHARE of them differ at all. The kernel's f32 sums
# run in another order, which flips the bf16 rounding of x @ w in about 2e-5
# of the outputs (emulated on the CPU: by up to 3 such ulps where the bias
# nearly cancels); a kernel that skips the rounding before the bias, or adds
# the bias without rounding the sum, changes 23-26% of them.
K6_ROWS = (64, 128, 3072, 10240)
FFN_ULPS, FFN_SHARE = 4, 1e-3
# The planted faults, each a patched copy of csrc/ built under
# _build/fault/<name>/ and never loaded by the package: P1 and K6's shared
# main loop (csrc/mma_gemm.cuh) drops its last k-tile; K1's key loop and
# K5's dk/dv query loop (csrc/attention.cuh) drop their last tile; the
# attention kernels' skip predicate misses a pair of tiles whose segment
# ranges meet at one id (the query tile's smallest, the key tile's largest);
# K4's b-tile skip predicate (csrc/filip_maxsim.cu) misses the tile's first
# token, and K4 drops its two correction products (plain TF32); K2 and K3
# (csrc/infonce.cu) drop theirs, and their cross-block sums of the forward's
# partials leave out the last tile when it is partial (B / 64 tiles).
FAULT_LINE = "  const int n_tiles = (K * Op::kEltBytes + kTileBytes - 1) / kTileBytes;"
SWEEP_FAULT_LINE = "  return (T + kTile - 1) / kTile;"
SKIP_FAULT_LINE = "  return q.x <= k.y && k.x <= q.y;"
MAXSIM_SKIP_LINE = ("          if (!__any_sync(0xffffffffu, (mbv.x | mbv.y) != 0)) continue;  "
                    "// an empty b-tile")
MAXSIM_TF32_LINE = "constexpr int kProducts = 3;  // TF32 products per k-step: hi.hi, hi.lo, lo.hi"
INFONCE_PARTIAL_LINE = ("__device__ __forceinline__ int summed_tiles(int B) "
                        "{ return tiles_of(B); }")
FAULTS = {   # name: (header, line, patched line, kernels built)
    "main_loop": ("mma_gemm.cuh", FAULT_LINE, FAULT_LINE[:-1] + " - 1;", ("dense_mm", "ffn_gelu")),
    "swept_tiles": ("attention.cuh", SWEEP_FAULT_LINE, SWEEP_FAULT_LINE[:-1] + " - 1;",
                    ("attention_fwd", "attention_bwd")),
    "skip": ("attention.cuh", SKIP_FAULT_LINE, SKIP_FAULT_LINE.replace("q.x <=", "q.x <"),
             ("attention_fwd", "attention_bwd")),
    "maxsim_skip": ("filip_maxsim.cu", MAXSIM_SKIP_LINE,
                    MAXSIM_SKIP_LINE.replace("(mbv.x | mbv.y)", "((lane ? mbv.x : 0) | mbv.y)"),
                    ("filip_maxsim",)),
    "maxsim_tf32": ("filip_maxsim.cu", MAXSIM_TF32_LINE, MAXSIM_TF32_LINE.replace("3;", "1;"),
                    ("filip_maxsim",)),
    "infonce_tf32": ("infonce.cu", MAXSIM_TF32_LINE, MAXSIM_TF32_LINE.replace("3;", "1;"),
                     ("infonce",)),
    "infonce_partial": ("infonce.cu", INFONCE_PARTIAL_LINE,
                        INFONCE_PARTIAL_LINE.replace("tiles_of(B)", "B / kTile"), ("infonce",)),
}
FAULT_DIR = build.BUILD_ROOT / "fault"
# int8 training: a fixture of 1100 families gives 770 train pairs, three
# steps at global batch 256, and 20 eval batches of 16.
INT8_FIXTURE_FAMILIES = 1100
# int8 against bf16 served embeddings, per row (no JAX reading at t30_150M:
# the sandbox that holds JAX runs no full-size model).
INT8_COSINE_MIN = 0.99
# FILIP training: cli.main_2protein_filip at its defaults (batch 10, one pad
# bucket) and at its documented scale-up with DCL, on a fixture of 1100
# families (770 train pairs: 77 and 6 steps).
FILIP_FIXTURE_FAMILIES = 1100
FILIP_RUNS = (("filip_10", []),
              ("filip_128", ["--batch-size", "128", "--num-chunks", "8", "--length-groups", "4",
                             "--use-dcl"]))
# The max-sim backward (plain PyTorch in f32) against autograd through
# maxsim_reference in float64, on tokens whose scores are exact in both: the
# same ties, so the gap is the f32 sums' rounding, about 1e-7 of the largest
# entry (CPU rehearsal); a split that misses one tied token is off by a
# share of the largest.
MAXSIM_BWD_RTOL = 1e-5
# One FILIP step through K4 against the same step through its plain
# version: the loss within FILIP_STEP_TOL relative, each head gradient
# within FILIP_STEP_TOL of the step's largest gradient entry (K4's scores
# are within K4_ATOL of the plain ones, and the backward is the same code).
FILIP_STEP_TOL = 1e-5
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


def path_segments() -> list[tuple[str, bool, torch.Tensor]]:
    """(kind, on the packed unfrozen path, segment ids) of the chunks K1 and
    K5 take on the packed paths, as derive_segments gives them: the last
    chunk of each side of ``cli.main --packed``'s first global batch on the
    fixture (pep (16, 128), rec (16, 256): rows of 2-11 segments, each with
    one gap at its end, and the all-<pad> rows that _row_multiple_for adds,
    which these chunks hold; it raises if they do not); the last pep chunk
    of ``cli.main --packed --finetune``'s first batch ((48, 128): the
    unfrozen step's constant-token rule); and the last receptor chunk of
    tools/bench_train's first standard draw ((16, 512)) and of its second
    long-tail draw ((28, 2048)). The rec (16, 256) chunk is on both
    paths."""
    data_dir = WORK / "train_data"
    if not (data_dir / "receptor.fasta").exists():
        write_fixture(data_dir, n_families=FIXTURE_FAMILIES, seed=42)
    train, _, _ = epoch_loaders(data_dir)
    fixture = packed_engine.tokenize_packed(common.make_tokenizer(),
                                            *next(clip_engine._accumulate(train, 16)))
    draws = (("bench_train standard draw 1",
              bench_train.make_batches(np.random.default_rng(42), 1, "standard")[0]),
             ("bench_train long-tail draw 2",
              bench_train.make_batches(np.random.default_rng(42), 2, "longtail")[1]))
    out = []

    def last_chunk(what, path, batch, side, rows, pads_needed=False):
        seg = packed_engine.derive_segments(batch[f"{side}_ids"].cuda())[1]
        chunk = seg[-rows:].contiguous()
        pad_rows = int((chunk.amax(1) == 0).sum())
        if pads_needed and not pad_rows:
            raise AssertionError(f"the last {side} chunk {tuple(chunk.shape)} has no <pad> row")
        out.append((f"packed, {what} {side} chunk, {pad_rows} rows all <pad>", path, chunk))

    for side in ("pep", "rec"):
        last_chunk("cli.main --packed", side == "rec", fixture, side,
                   chunk_rows(fixture[f"{side}_ids"].shape[0]), pads_needed=True)
    last_chunk("cli.main --packed --finetune", True, fixture, "pep",
               unfrozen_chunk_shapes(fixture)[0][0])
    for what, batch in draws:
        last_chunk(what, True, batch, "rec", unfrozen_chunk_shapes(batch)[1][0])
    return out


def attention_cases(gen: torch.Generator, segments: list) -> list:
    """(B, T, kind, on the unfrozen path, q, k, v, segments) for K1: padded
    rows (fully padded query rows included) at KERNEL_SHAPES, synthetic
    packed rows at three shapes, and the packed paths' own ``segments``
    (path_segments)."""
    cases = [(B, T, "padded", False, padded_segments(B, T)) for B, T in KERNEL_SHAPES]
    cases += [(4, 512, "packed", False, packed_segments(4, 512)),
              (2, 129, "packed", False, packed_segments(2, 129)),
              (1, 2048, "packed", False, packed_segments(1, 2048))]
    cases += [(*seg.shape, kind, path, seg) for kind, path, seg in segments]
    return [(B, T, kind, path, *qkv(B, T, gen), seg) for B, T, kind, path, seg in cases]


def by_rows(fn, q, *tensors):
    """fn(q, *tensors) of an attention plain version, over slices of rows
    whose (rows, NH, T, T) f32 tensors hold at most 2^29 elements, the
    outputs concatenated: at (28, 2048) one such tensor is 9.4 GB."""
    T = q.shape[1]
    rows = max(1, 2 ** 29 // (q.shape[2] * T * T))
    if rows >= q.shape[0]:
        return fn(q, *tensors)
    parts = [fn(*(t[i:i + rows] for t in (q, *tensors))) for i in range(0, q.shape[0], rows)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p) for p in zip(*parts))
    return torch.cat(parts)


def least_atol(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max|err|, the least atol in units of rms(want) that passes
    |err| <= atol + RTOL |want|; inf where got is not finite)."""
    w = want.float()
    err = (got.float() - w).abs()
    rms = w.square().mean().sqrt().item()
    need = (err - RTOL * w.abs()).max().item() / max(rms, 1e-30)
    return err.max().item(), need if bool(torch.isfinite(got).all()) else math.inf


def k1_readings(cases: list) -> list[dict]:
    """K1 on each case against attention_reference: the least passing atol
    (rms units) of the output, and its statistics' largest gap from
    attention_reference_lse (inf where a pad query's -inf is not matched)."""
    rows = []
    for B, T, kind, path, q, k, v, seg in cases:
        out, lse = attention._forward(q, k, v, seg, with_lse=True)
        torch.cuda.synchronize()
        err, need = least_atol(out, by_rows(attention.attention_reference, q, k, v, seg))
        want = by_rows(attention.attention_reference_lse, q, k, seg)
        pad = torch.isinf(want)
        lse_err = (float((lse[~pad] - want[~pad]).abs().max()) if bool((~pad).any()) else 0.0)
        if not torch.equal(torch.isinf(lse), pad):
            lse_err = math.inf
        rows.append({"case": f"B={B} T={T} {kind}", "packed": kind.startswith("packed"),
                     "path": path, "max_abs_err": err, "need": need, "lse_err": lse_err})
    return rows


def check_attention(cases: list) -> float:
    """K1 against its plain version: every output within ATOL_RMS * rms(ref)
    + RTOL |ref|, its statistics within LSE_ATOL of attention_reference_lse
    (and -inf at the same pad queries)."""
    worst = 0.0
    for row in k1_readings(cases):
        ok = row["need"] <= ATOL_RMS and row["lse_err"] <= LSE_ATOL
        worst = max(worst, row["max_abs_err"])
        log(f"[kernels] attention_fwd {row['case']} NH={NH}: max|err| {row['max_abs_err']:.6g}; "
            f"least passing atol {row['need']:.6g} rms(ref) (tolerance {ATOL_RMS:g} rms(ref) + "
            f"{RTOL}*|ref|); lse max|err| {row['lse_err']:.3g} (tolerance {LSE_ATOL:g}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"attention_fwd disagrees with its plain version ({row['case']})")
    return worst


def bwd_cases(gen: torch.Generator, segments: list) -> list:
    """(B, T, kind, on the unfrozen path, q, k, v, dO, segments) for K5:
    padded rows everywhere (with one row of no valid token where B > 1,
    whose queries are all uniform), synthetic packed rows at three shapes,
    and the chunks of ``segments`` (path_segments) on the packed unfrozen
    path."""
    cases = []
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
            cases.append((B, T, kind, False, seg))
    cases += [(*seg.shape, kind, True, seg) for kind, path, seg in segments if path]
    out = []
    for B, T, kind, path, seg in cases:
        q, k, v = qkv(B, T, gen)
        do = torch.randn(B, T, NH, DH, device="cuda", generator=gen).bfloat16()
        out.append((B, T, kind, path, q, k, v, do, seg))
    return out


def k5_readings(cases: list) -> list[dict]:
    """K5, fed K1's statistics, on each case against
    attention_reference_bwd: the least passing atol (rms units) of dq, dk
    and dv."""
    rows = []
    for B, T, kind, path, q, k, v, do, seg in cases:
        lse = attention._forward(q, k, v, seg, with_lse=True)[1]
        got = attention.fused_attention_bwd(q, k, v, seg, do, lse)
        torch.cuda.synchronize()
        want = by_rows(attention.attention_reference_bwd, q, k, v, seg, do)
        errs = [least_atol(g, w) for g, w in zip(got, want)]
        rows.append({"case": f"B={B} T={T} {kind}", "packed": kind.startswith("packed"),
                     "path": path, "max_abs_err": max(e for e, _ in errs),
                     "needs": dict(zip(("dq", "dk", "dv"), (n for _, n in errs)))})
    return rows


def check_attention_bwd(cases: list) -> float:
    """K5 against attention_reference_bwd, each of dq, dk, dv held to K1's
    form |err| <= ATOL_RMS * rms(ref) + RTOL * |ref|: both round P and dS to
    bf16 for the products, from f32 values that differ by the order of
    their sums and by ex2.approx, and round the outputs to bf16 (2^-8
    relative, within RTOL)."""
    worst = 0.0
    for row in k5_readings(cases):
        ok = max(row["needs"].values()) <= ATOL_RMS
        worst = max(worst, row["max_abs_err"])
        log(f"[kernels] attention_bwd {row['case']} NH={NH}: max|err| {row['max_abs_err']:.6g}; "
            f"least passing atol " + ", ".join(f"{k} {v:.6g}" for k, v in row["needs"].items())
            + f" rms(ref) (tolerance {ATOL_RMS:g} rms(ref) + {RTOL}*|ref|) "
            + ("ok" if ok else "FAIL"))
        if not ok:
            raise AssertionError(f"attention_bwd disagrees with its plain version ({row['case']})")
    return worst


def maxsim_inputs(Ba: int, Bb: int, TA: int, TB: int, gen: torch.Generator,
                  scale: float = 1.0, short: bool = False, empty_a: bool = False):
    """f32 tokens of norm `scale` and padded 0/1 masks, true lengths over
    [T/4, T] (short: [1, 4]); when Ba > 1 one a-row (empty_a: every a-row),
    and always one b-row, has no valid token (the clamp path); when TB > 64,
    b-row 0 holds 65 valid tokens, so its second tile's only valid token is
    its first."""
    def tokens(B, T):
        x = torch.randn(B, T, FILIP_D, device="cuda", generator=gen)
        return scale * torch.nn.functional.normalize(x, dim=-1)

    def mask(B, T):
        lo, hi = (1, min(4, T)) if short else (max(1, T // 4), T)
        lengths = torch.randint(lo, hi + 1, (B, 1), device="cuda", generator=gen)
        return (torch.arange(T, device="cuda")[None, :] < lengths).to(torch.int32)

    ma, mb = mask(Ba, TA), mask(Bb, TB)
    if TB > 64 and Bb > 1:
        mb[0] = 0
        mb[0, :65] = 1
    if Ba > 1:
        ma[Ba // 2] = 0
    if empty_a:
        ma[:] = 0
    mb[Bb // 2] = 0
    return tokens(Ba, TA), tokens(Bb, TB), ma, mb


def maxsim_cases(gen: torch.Generator) -> list:
    """K4's check inputs: K4_SHAPES at unit norm, K4_SHORT_SHAPES short, and
    a query with no valid token at the /topk grid (K4_EMPTY_SHAPES)."""
    return ([(shape, maxsim_inputs(*shape, gen)) for shape in K4_SHAPES]
            + [(shape, maxsim_inputs(*shape, gen, K4_SHORT_SCALE, short=True))
               for shape in K4_SHORT_SHAPES]
            + [(shape, maxsim_inputs(*shape, gen, empty_a=True))
               for shape in K4_EMPTY_SHAPES])


def one_token_tile(ma: torch.Tensor, mb: torch.Tensor) -> bool:
    """Whether a b-row holds a 64-token tile whose only valid token is its
    first, against an a-row with a valid token: what the planted skip fault
    misses."""
    tiles = torch.nn.functional.pad(mb != 0, (0, -mb.shape[1] % 64)).view(mb.shape[0], -1, 64)
    return bool((ma != 0).any()) and bool(((tiles.sum(-1) == 1) & tiles[..., 0]).any())


def k4_readings(cases: list) -> list[dict]:
    """Per case ((Ba, Bb, TA, TB), inputs[, label]): K4's largest gap from
    maxsim_reference over oa and ob, whether the outputs are finite and
    whether the rows with no valid token (an a-row's or a b-row's) score 0
    on both outputs."""
    rows = []
    for (Ba, Bb, TA, TB), (ha, hb, ma, mb), *label in cases:
        got = maxsim.filip_similarity_fused(ha, hb, ma, mb, 1.0)
        torch.cuda.synchronize()
        want = maxsim.maxsim_reference(ha, hb, ma, mb)
        empty_a, empty_b = ma.sum(1) == 0, mb.sum(1) == 0
        empty_ok = all(bool((g[empty_a] == 0).all()) and bool((g[:, empty_b] == 0).all())
                       for g in got)
        rows.append({"shape": [Ba, Bb, TA, TB], "label": label[0] if label else "",
                     "short": 0 < int(ma.sum(1).max()) <= 4,
                     "empty_a": bool(empty_a.all()), "one_token_tile": one_token_tile(ma, mb),
                     "err": max(float((g - w).abs().max()) for g, w in zip(got, want)),
                     "finite": all(bool(torch.isfinite(g).all()) for g in got),
                     "empty_ok": empty_ok})
    return rows


def check_maxsim(cases: list) -> float:
    rows = k4_readings(cases)
    for r in rows:
        ok = r["finite"] and r["err"] <= K4_ATOL and r["empty_ok"]
        log(f"[kernels] filip_maxsim {r['label'] + ' ' if r['label'] else ''}"
            f"(Ba, Bb, TA, TB)={tuple(r['shape'])} D={FILIP_D}"
            f"{f' norm {K4_SHORT_SCALE:g}, 1-4 valid tokens a row' if r['short'] else ''}"
            f"{', no valid a-token' if r['empty_a'] else ''}: "
            f"max|err| {r['err']:.6g} (tolerance {K4_ATOL:g}); empty rows score 0: "
            f"{r['empty_ok']} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"filip_maxsim disagrees with its plain version at {r['shape']}")
    return max(r["err"] for r in rows)


@contextlib.contextmanager
def maxsim_kernel(lib: Path):
    """ops.filip launches the build ``lib`` while the block runs."""
    saved = maxsim._launcher
    faulty = maxsim.bind(ctypes.CDLL(str(lib)))
    maxsim._launcher = lambda: faulty
    try:
        yield
    finally:
        maxsim._launcher = saved


def check_maxsim_faults(libs: dict, cases: list) -> dict:
    """K4's check against its two planted faults, on the same inputs: the
    skip fault must fail every case with a one-token tile, the plain-TF32
    fault at least the short ones. Returns the worst ratio to K4_ATOL and the
    cases failed."""
    out = {}
    for name, what, must in (
            ("maxsim_skip", "b-tile skip predicate misses the tile's first token",
             lambda r: r["one_token_tile"]),
            ("maxsim_tf32", "plain TF32, the correction products dropped",
             lambda r: r["short"])):
        with maxsim_kernel(libs[name]["filip_maxsim"]):
            rows = k4_readings(cases)
        fails = [r["err"] > K4_ATOL or not r["empty_ok"] for r in rows]
        failed = [r for r, f in zip(rows, fails) if f]
        missed = [r["shape"] for r, f in zip(rows, fails) if must(r) and not f]
        out[name] = {"worst_ratio": max(r["err"] for r in rows) / K4_ATOL,
                     "cases_failed": len(failed), "cases": len(rows),
                     "ratios": [r["err"] / K4_ATOL for r in rows]}
        log(f"[kernels] planted fault {name} ({what}): filip_maxsim fails {len(failed)} of "
            f"{len(rows)} cases, at {', '.join(f'{x:.4g}' for x in out[name]['ratios'])} x "
            f"its tolerance; cases it should fail and passes: {missed or 'none'}")
        if missed:
            raise AssertionError(f"the filip_maxsim check does not see the planted fault {name}")
    return out


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


def infonce_cases(gen: torch.Generator) -> list:
    """(kernel, B, D, t, x, y) of the K2 and K3 checks: unit rows scaled by
    exp(t/2) at the pools of K2_POOLS and K3_POOLS, D = 128, and D = 64 once
    each."""
    cases = [("infonce", B, 128, t) for B in K2_POOLS for t in (1.0, 4.0)]
    cases += [("infonce_tiled", B, 128, t) for B in K3_POOLS for t in (1.0, 4.0)]
    cases += [("infonce", 256, 64, 1.0), ("infonce_tiled", 1024, 64, 1.0)]
    return [(name, B, D, t, *unit_rows(B, D, t, gen)) for name, B, D, t in cases]


def infonce_readings(cases: list) -> list[dict]:
    """Each case through its kernel and through clip_infonce, forward and
    backward: the errors (loss, dX, dY), their tolerances and the largest
    ratio of one to the other."""
    rows = []
    for name, B, D, t, x, y in cases:
        fn = infonce.fused_infonce if name == "infonce" else infonce.fused_infonce_tiled
        got = value_and_grads(fn, x, y)
        want = value_and_grads(infonce.clip_infonce, x, y)
        errs = [abs(float(got[0] - want[0]))]
        errs += [float((g - w).abs().max()) for g, w in zip(got[1:], want[1:])]
        tols = [INFONCE_RTOL * max(1.0, abs(float(want[0])))]
        tols += [INFONCE_RTOL * float(w.abs().max()) for w in want[1:]]
        finite = all(bool(torch.isfinite(v).all()) for v in got)
        ratio = max(e / tol for e, tol in zip(errs, tols)) if finite else math.inf
        rows.append({"name": name, "case": f"{name} B={B} D={D} t={t:g}", "B": B, "t": t,
                     "loss": float(got[0]), "errs": errs, "tols": tols, "ratio": ratio})
    return rows


def check_infonce(cases: list) -> dict:
    """K2 and K3, forward and backward, against the plain clip_infonce;
    returns the largest absolute error of each (loss and gradients)."""
    worst = {"infonce": 0.0, "infonce_tiled": 0.0}
    for r in infonce_readings(cases):
        ok = r["ratio"] <= 1
        worst[r["name"]] = max(worst[r["name"]], *r["errs"])
        log(f"[kernels] {r['case']}: loss {r['loss']:.6f}, |err| {r['errs'][0]:.3g} "
            f"(tolerance {r['tols'][0]:.3g}); max|err| dX {r['errs'][1]:.3g}, dY "
            f"{r['errs'][2]:.3g} (tolerance {r['tols'][1]:.3g}, {r['tols'][2]:.3g}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the kernel disagrees with its plain version: {r['case']}")
    return worst


@contextlib.contextmanager
def infonce_kernel(lib: Path):
    """ops.infonce launches the library at ``lib`` while the block runs."""
    saved = infonce._launchers
    faulty = infonce.bind(ctypes.CDLL(str(lib)))
    infonce._launchers = lambda: faulty
    try:
        yield
    finally:
        infonce._launchers = saved


def check_infonce_faults(libs: dict, cases: list) -> dict:
    """The K2 and K3 check against their two planted faults, on its own
    inputs: plain TF32 must fail every case at t = 4 (logits up to e^4,
    where TF32's three digits show; at t = 1 the kernels' centred products
    leave it near the tolerance), and the partial-tile fault every case
    whose pool is no multiple of 64 (B = 100, 1000). Returns the worst ratio
    to the tolerance, the cases failed and every case's ratio."""
    out = {}
    for name, what, must in (
            ("infonce_tf32", "plain TF32, the correction products dropped",
             lambda r: r["t"] == 4.0),
            ("infonce_partial", "the cross-block sums drop the last, partial tile",
             lambda r: r["B"] % 64 != 0)):
        with infonce_kernel(libs[name]["infonce"]):
            rows = infonce_readings(cases)
        ratios = {r["case"]: r["ratio"] for r in rows}
        failed = [c for c, x in ratios.items() if x > 1]
        missed = [r["case"] for r in rows if must(r) and r["ratio"] <= 1]
        out[name] = {"worst_ratio": max(ratios.values()), "cases_failed": len(failed),
                     "cases": len(rows), "ratios": ratios}
        log(f"[kernels] planted fault {name} ({what}): fails {len(failed)} of {len(rows)} "
            f"cases, at {', '.join(f'{c}: {x:.4g}' for c, x in ratios.items())} x its "
            f"tolerance; cases it should fail and passes: {missed or 'none'}")
        if missed:
            raise AssertionError(f"the infonce check does not see the planted fault {name}")
    return out


def s8_pair(N: int, K: int, M: int, gen: torch.Generator):
    return (torch.randint(-128, 128, (N, K), generator=gen, device="cuda", dtype=torch.int8),
            torch.randint(-128, 128, (K, M), generator=gen, device="cuda", dtype=torch.int8))


def bf16_pair(N: int, K: int, M: int, gen: torch.Generator):
    return (torch.randn(N, K, generator=gen, device="cuda").bfloat16(),
            (torch.randn(K, M, generator=gen, device="cuda") / K ** 0.5).bfloat16())


def mm_bf16_gap(x: torch.Tensor, w: torch.Tensor, got: torch.Tensor) -> float:
    """max |got - plain| / (|x| @ |w|): the bf16 form's error on the scale
    of an f32 sum's rounding error."""
    want = dense_mm.mm_reference(x, w, torch.float32)
    scale = torch.matmul(x.float().abs(), w.float().abs()).clamp(min=1e-30)
    return float(((got - want).abs() / scale).max())


def check_dense_mm(gen: torch.Generator) -> dict:
    """P1 s8 against mm_reference to the bit at P1_SHAPES and at the extreme
    values, and bf16 -> f32 within MM_BF16_TOL at P1_BF16_SHAPES."""
    for N, K, M in P1_SHAPES:
        x, w = s8_pair(N, K, M, gen)
        got = dense_mm.mm(x, w, torch.int32)
        torch.cuda.synchronize()
        if not torch.equal(got, dense_mm.mm_reference(x, w, torch.int32)):
            raise AssertionError(f"dense_mm s8 differs from its plain version at {(N, K, M)}")
    for N, K, M in EDGE_SHAPES:
        x, w = s8_pair(N, K, M, gen)
        if not torch.equal(dense_mm.mm(x, w, torch.int32),
                           dense_mm.mm_reference(x, w, torch.int32)):
            raise AssertionError(f"dense_mm s8 differs from its plain version at the edge "
                                 f"{(N, K, M)}")
    log(f"[kernels] dense_mm s8 -> s32 equals its plain version to the bit at "
        f"{len(P1_SHAPES)} shapes: {P1_SHAPES}, and at {len(EDGE_SHAPES)} edges: {EDGE_SHAPES}")
    for value in (127, -127, -128):
        for N, K, M in ((130, 2560, 640), (1000, 640, 2560)):
            x = torch.full((N, K), value, dtype=torch.int8, device="cuda")
            x[1::3] = -128
            w = torch.full((K, M), value, dtype=torch.int8, device="cuda")
            w[:, 1::2] = 127
            want = dense_mm.mm_reference(x, w, torch.int32)
            if not torch.equal(dense_mm.mm(x, w, torch.int32), want):
                raise AssertionError(f"dense_mm s8 differs at the extreme {value}, {(N, K, M)}")
    log(f"[kernels] dense_mm s8 at the extremes (+127, -127, -128; sums up to "
        f"{2560 * 128 * 128}) equal to the bit")
    worst = 0.0
    for N, K, M in P1_BF16_SHAPES + tuple((n, k // 2, m) for n, k, m in EDGE_SHAPES):
        x, w = bf16_pair(N, K, M, gen)
        got = dense_mm.mm(x, w, torch.float32)
        torch.cuda.synchronize()
        gap = mm_bf16_gap(x, w, got)
        worst = max(worst, gap)
        log(f"[kernels] dense_mm bf16 -> f32 {(N, K, M)}: max |err| / (|x| @ |w|) {gap:.3g} "
            f"(tolerance {MM_BF16_TOL:g}) {'ok' if gap <= MM_BF16_TOL else 'FAIL'}")
        if not gap <= MM_BF16_TOL:
            raise AssertionError(f"dense_mm bf16 disagrees with its plain version at {(N, K, M)}")
    return {"s8_max_abs_err": 0, "bf16_rel_err": worst}


def ffn_inputs(N: int, H: int, M: int, gen: torch.Generator):
    """bf16 x, W at unit output scale and a bias of half that scale, so that
    both roundings before the gelu matter."""
    return (torch.randn(N, H, generator=gen, device="cuda").bfloat16(),
            (torch.randn(H, M, generator=gen, device="cuda") / H ** 0.5).bfloat16(),
            (0.5 * torch.randn(M, generator=gen, device="cuda")).bfloat16())


def ffn_gap(x, w, b, got: torch.Tensor, mode: str) -> tuple[float, float, float]:
    """(largest error in bf16 ulps of max(|x @ w|, |b|, |ref|), share of the
    outputs that differ, largest absolute error) against the plain version."""
    ref = ffn.dense_gelu_reference(x, w, b, mode).float()
    scale = torch.maximum(torch.matmul(x.float(), w.float()).abs(), b.float().abs()[None])
    _, e = torch.frexp(torch.maximum(scale, ref.abs()))
    err = (got.float() - ref).abs()
    return (float((err / torch.ldexp(torch.ones_like(ref), e - 8)).max()),
            float((err > 0).float().mean()), float(err.max()))


def check_ffn(gen: torch.Generator) -> float:
    """K6 against dense_gelu_reference, erf and tanh, at t30_150M's wi for
    K6_ROWS tokens, and erf at the main loop's edges; then the plain version
    with either epilogue rounding skipped must fail the share bound."""
    worst = 0.0
    cases = [(N, 640, 2560, mode) for N in K6_ROWS for mode in ("erf", "tanh")]
    cases += [(n, k // 2, m, "erf") for n, k, m in EDGE_SHAPES]
    for N, H, M, mode in cases:
        x, w, b = ffn_inputs(N, H, M, gen)
        got = ffn.dense_gelu(x, w, b, mode)
        torch.cuda.synchronize()
        ulps, share, err = ffn_gap(x, w, b, got, mode)
        ok = bool(torch.isfinite(got.float()).all()) and ulps <= FFN_ULPS \
            and share <= FFN_SHARE
        worst = max(worst, err)
        log(f"[kernels] ffn_gelu N={N} H={H} M={M} {mode}: max |err| {err:.6g} = "
            f"{ulps:g} bf16 ulps (tolerance {FFN_ULPS}), {share:.3g} of the outputs differ "
            f"(tolerance {FFN_SHARE:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"ffn_gelu disagrees with its plain version at "
                                 f"{(N, H, M)} {mode}")
    x, w, b = ffn_inputs(10240, 640, 2560, gen)
    acc = torch.matmul(x.float(), w.float())
    for what, z in (("the rounding before the bias", (acc + b.float()).bfloat16()),
                    ("the rounding of the biased sum", acc.bfloat16().float() + b.float())):
        share = ffn_gap(x, w, b, ffn._gelu_f32(z.float(), "erf").bfloat16(), "erf")[1]
        log(f"[kernels] ffn_gelu check against a plain version that skips {what}: {share:.3g} "
            f"of the outputs differ ({share / FFN_SHARE:.4g} x the tolerance)")
        if share <= FFN_SHARE:
            raise AssertionError(f"the ffn_gelu check does not see a skipped rounding ({what})")
    return worst


def build_faults(names=tuple(FAULTS)) -> dict:
    """The planted faults ``names`` of FAULTS, each kernel of one built from
    its own patched copy of csrc/ under _build/fault/<name>/: {name:
    {kernel: library path}}. All builds run at once."""
    jobs = []
    for name in names:
        header, line, patched, kernels = FAULTS[name]
        shutil.rmtree(FAULT_DIR / name, ignore_errors=True)
        src = FAULT_DIR / name / "csrc"
        shutil.copytree(build.CSRC_DIR, src)
        text = (src / header).read_text()
        if text.count(line) != 1:
            raise AssertionError(f"the planted fault's line ({name}) is not in csrc/{header} once")
        (src / header).write_text(text.replace(line, patched))
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(src)]
        jobs += [(name, kernel, cmd, src / f"{kernel}.cu",
                  FAULT_DIR / name / f"lib{kernel}_fault.so") for kernel in kernels]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda job: build.compile_library(*job[2:]), jobs))
    libs = {}
    for name, kernel, _, _, lib in jobs:
        libs.setdefault(name, {})[kernel] = lib
    return libs


@contextlib.contextmanager
def fault_kernels(libs: dict):
    """The wrappers launch the planted-fault builds while the block runs."""
    saved = dense_mm._launchers, ffn._launcher
    faulty_mm = dense_mm.bind(ctypes.CDLL(str(libs["dense_mm"])))
    faulty_ffn = ffn.bind(ctypes.CDLL(str(libs["ffn_gelu"])))
    dense_mm._launchers, ffn._launcher = (lambda: faulty_mm), (lambda: faulty_ffn)
    try:
        yield
    finally:
        dense_mm._launchers, ffn._launcher = saved


@contextlib.contextmanager
def attention_kernels(libs: dict, names=("attention_fwd", "attention_bwd")):
    """ops.attention launches the planted-fault builds of ``names`` while
    the block runs, and its own builds of the others."""
    saved = attention._launcher
    faulty = {name: attention.bind(ctypes.CDLL(str(libs[name])), name) for name in names}
    attention._launcher = lambda name: faulty[name] if name in faulty else saved(name)
    try:
        yield
    finally:
        attention._launcher = saved


def check_attention_faults(libs: dict, k1_cases: list, k5_cases: list) -> dict:
    """K1's and K5's checks against each attention fault, on the same
    inputs, each kernel's fault alone (K5 is fed the sound K1's
    statistics): each must fail the check, the skip fault every packed case
    of it, and both faults every case on the packed unfrozen path. Returns
    the worst ratio to the tolerance per check, how many cases failed and
    the least ratio on the packed unfrozen path."""
    out = {}
    for name in ("swept_tiles", "skip"):
        with attention_kernels(libs[name], ("attention_fwd",)):
            k1 = k1_readings(k1_cases)
        with attention_kernels(libs[name], ("attention_bwd",)):  # fed the sound K1's lse
            k5 = k5_readings(k5_cases)
        for kernel, rows, ratio in (
                ("attention_fwd", k1, lambda r: max(r["need"] / ATOL_RMS, r["lse_err"] / LSE_ATOL)),
                ("attention_bwd", k5, lambda r: max(r["needs"].values()) / ATOL_RMS)):
            ratios = [ratio(r) for r in rows]
            failed = [r["case"] for r, x in zip(rows, ratios) if x > 1]
            packed_missed = [r["case"] for r, x in zip(rows, ratios) if r["packed"] and x <= 1]
            path_missed = [r["case"] for r, x in zip(rows, ratios) if r["path"] and x <= 1]
            path = [x for r, x in zip(rows, ratios) if r["path"]]
            out[f"{kernel}_{name}"] = {"worst_ratio": max(ratios), "cases_failed": len(failed),
                                       "cases": len(rows), "least_ratio_unfrozen_path": min(path)}
            log(f"[kernels] planted fault {name} ({'last tile of the swept loop dropped' if name == 'swept_tiles' else 'skip predicate off by one at a segment boundary'}): "
                f"{kernel} fails {len(failed)} of {len(rows)} cases, worst at {max(ratios):.4g} x "
                f"its tolerance; on the packed unfrozen path's {len(path)} chunks at least "
                f"{min(path):.4g} x; packed cases it passes: {packed_missed or 'none'}")
            if not failed or path_missed or (name == "skip" and packed_missed):
                raise AssertionError(f"the {kernel} check does not see the planted fault {name}")
    return out


def check_faults(libs: dict, gen: torch.Generator) -> dict:
    """Each check above against the planted fault, in the large block and in
    the small one (128 tokens): it must fail every check, and by how much is
    returned (and goes to PERF.md)."""
    out = {}
    with fault_kernels(libs):
        for key, (N, K, M) in (("dense_mm_s8", (1000, 640, 2560)),
                               ("dense_mm_s8_small", (128, 2560, 640))):
            x, w = s8_pair(N, K, M, gen)
            got = dense_mm.mm(x, w, torch.int32)
            want = dense_mm.mm_reference(x, w, torch.int32)
            torch.cuda.synchronize()
            diff = (got.long() - want.long()).abs()
            out[key] = {"shape": [N, K, M], "share_differ": float((diff > 0).float().mean()),
                        "max_abs_diff": int(diff.max())}
        x, w = bf16_pair(8192, 2560, 2560, gen)
        out["dense_mm_bf16"] = {"shape": [8192, 2560, 2560],
                                "x_tolerance": mm_bf16_gap(x, w, dense_mm.mm(x, w, torch.float32))
                                / MM_BF16_TOL}
        for key, N in (("ffn_gelu", 3072), ("ffn_gelu_small", 128)):
            x, w, b = ffn_inputs(N, 640, 2560, gen)
            ulps, share, err = ffn_gap(x, w, b, ffn.dense_gelu(x, w, b, "erf"), "erf")
            out[key] = {"shape": [N, 640, 2560], "ulps_x_tolerance": ulps / FFN_ULPS,
                        "share_x_tolerance": share / FFN_SHARE, "max_abs_err": err}
    log(f"[kernels] planted fault (main loop drops its last k-tile): dense_mm s8 differs in "
        f"{out['dense_mm_s8']['share_differ']:.6g} of the outputs, by up to "
        f"{out['dense_mm_s8']['max_abs_diff']} (at 128 tokens in "
        f"{out['dense_mm_s8_small']['share_differ']:.6g}, by up to "
        f"{out['dense_mm_s8_small']['max_abs_diff']}); dense_mm bf16 at "
        f"{out['dense_mm_bf16']['x_tolerance']:.4g} x its tolerance; ffn_gelu at "
        f"{out['ffn_gelu']['ulps_x_tolerance']:.4g} x its ulp bound and "
        f"{out['ffn_gelu']['share_x_tolerance']:.4g} x its share bound (at 128 tokens "
        f"{out['ffn_gelu_small']['ulps_x_tolerance']:.4g} and "
        f"{out['ffn_gelu_small']['share_x_tolerance']:.4g})")
    if (min(out[k]["max_abs_diff"] for k in ("dense_mm_s8", "dense_mm_s8_small")) == 0
            or out["dense_mm_bf16"]["x_tolerance"] <= 1
            or min(out[k][b] for k in ("ffn_gelu", "ffn_gelu_small")
                   for b in ("ulps_x_tolerance", "share_x_tolerance")) <= 1):
        raise AssertionError("a check does not see the planted fault")
    return out


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
    dense_mm.mm.launches = 0
    ffn.dense_gelu.launches = 0


def check_default_path(what: str) -> None:
    """The default bf16 paths launch neither P1 nor K6."""
    if dense_mm.mm.launches or ffn.dense_gelu.launches:
        raise AssertionError(f"{what}: dense_mm launched {dense_mm.mm.launches} and ffn_gelu "
                             f"{ffn.dense_gelu.launches} times on the default path")


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
        check_default_path("serve")
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
        check_default_path(name)
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


def chunk_rows(R: int, rows_per_chunk: int = 16) -> int:
    """The rows of each backbone chunk of a pack of R rows: the most equal
    chunks, at most R // rows_per_chunk of them, that divide R."""
    return R // max([d for d in range(1, R // rows_per_chunk + 1) if R % d == 0], default=1)


def packed_chunks(batch: dict) -> list[tuple[int, int]]:
    """The (rows, L) of each backbone chunk a packed batch takes."""
    out = []
    for side in ("pep", "rec"):
        R, L = batch[f"{side}_ids"].shape
        out += [(chunk_rows(R), L)] * (R // chunk_rows(R))
    return out


def unfrozen_chunk_shapes(batch: dict) -> list[tuple[int, int]]:
    """(rows, L) of the pep and the rec chunks the packed unfrozen step
    takes: a side of width L runs 16 x (the widest side's width / L) rows a
    chunk (the same tokens a chunk on both sides), by chunk_rows' rule."""
    widths = [batch[f"{side}_ids"].shape[1] for side in ("pep", "rec")]
    return [(chunk_rows(batch[f"{side}_ids"].shape[0], 16 * (max(widths) // L)), L)
            for side, L in zip(("pep", "rec"), widths)]


def unfrozen_chunks(batch: dict) -> list[tuple[int, int]]:
    """The (rows, L) of each backbone chunk of one pass of the packed
    unfrozen step."""
    out = []
    for side, (rows, L) in zip(("pep", "rec"), unfrozen_chunk_shapes(batch)):
        out += [(rows, L)] * (batch[f"{side}_ids"].shape[0] // rows)
    return out


def epoch_loaders(data_dir: Path) -> tuple:
    """The train, val and test loaders of ``cli.main``'s first epoch at the
    defaults, as the run builds and reseeds them (the test loader keeps its
    first draws)."""
    train_ds, val_ds, test_ds = dataset.generate_datasets(data_dir, seed=42)
    train, val, test = (dataset.PairLoader(ds, 16, shuffle=ds is train_ds, seed=42)
                        for ds in (train_ds, val_ds, test_ds))
    train.reseed_epoch(0)
    val.reseed_epoch(0)
    return train, val, test


def packed_epoch_chunks(data_dir: Path, step_chunks=packed_chunks) -> tuple[list, list]:
    """The backbone chunks of each step (by ``step_chunks``: the frozen
    step's, or one pass of the unfrozen step's with unfrozen_chunks) and of
    each eval batch of ``cli.main --packed``'s first epoch at the
    defaults."""
    train, val, test = epoch_loaders(data_dir)
    tok = common.make_tokenizer()
    steps = [step_chunks(packed_engine.tokenize_packed(tok, p, r))
             for p, r in clip_engine._accumulate(train, 16)]
    evals = [packed_chunks(packed_engine.tokenize_packed(tok, p, r))
             for loader in (val, test) for p, r in loader]
    return steps, evals


def run_packed_train(data_dir: Path) -> dict:
    """cli.main --packed for one epoch at the defaults (global batch 256,
    flat packing, 16 rows a chunk); checks the artifacts and every kernel's
    launch count against the chunks the loaders' batches take."""
    runs = WORK / "runs_train_packed"
    t0 = time.perf_counter()
    with counted_forwards() as forwards, timed_steps() as ends:
        reset_counts()
        train_cli.main(["--synthetic-fixture", "--data-dir", str(data_dir), "--fixture-families",
                        str(FIXTURE_FAMILIES), "--epochs", "1", "--runs-dir", str(runs),
                        "--packed"])
        k1 = attention.fused_attention.launches
        counts = infonce_counts()
        check_default_path("train_packed")
    wall = time.perf_counter() - t0
    run = check_run_dir(runs)
    steps, evals = packed_epoch_chunks(data_dir)
    want_forwards = [c for chunks in steps + evals for c in chunks]
    want = {"infonce": (len(steps) + len(evals), len(steps)), "infonce_tiled": (0, 0)}
    if (len(ends), sorted(forwards), k1) != (len(steps), sorted(want_forwards),
                                             30 * len(want_forwards)):
        raise AssertionError(f"train_packed: {len(ends)} steps (want {len(steps)}), "
                             f"{len(forwards)} chunk forwards (want {len(want_forwards)}), "
                             f"attention_fwd {k1} (want {30 * len(want_forwards)})")
    if counts != want:
        raise AssertionError(f"train_packed: InfoNCE (forward, backward) calls {counts}, "
                             f"want {want}")
    metrics = json.loads((run / "metrics.jsonl").read_text().splitlines()[0])
    per_step = sum(map(len, steps)) / len(steps)
    log(f"[train] train_packed: global batch 256 packed, {len(steps)} steps, {len(evals)} eval "
        f"batches of 16; train loss {metrics['train_loss']:.6f}, val loss "
        f"{metrics['val_loss']:.6f}; chunk forwards (rows, L) of the first step {steps[0]}, "
        f"{per_step:.2f} a step (the grouped step: 32); attention_fwd {k1} = 30 per chunk "
        f"forward; InfoNCE (forward, backward) calls {counts}; epoch {metrics['seconds']:.2f} s, "
        f"cli.main {wall:.2f} s")
    return {"run": run, "steps": len(steps), "ends": ends, "chunks_per_step": per_step,
            "launches": {"attention_fwd": k1,
                         "filip_maxsim": maxsim.filip_similarity_fused.launches,
                         **{k: v[0] for k, v in counts.items()}},
            "bwd": {k: v[1] for k, v in counts.items()}}


def packed_setup(n: int = 256):
    """t30_150M bf16 with the seeded weights of the train runs, CLIP heads
    (seed SEED, dropout 0.1), and the first n training pairs of the fixture."""
    cfg_esm = common.esm_config("t30_150M", "bfloat16")
    mcfg = clip.CLIPConfig(input_dim=cfg_esm.hidden_size, esm=cfg_esm)
    esm_params = esm2.init_params(cfg_esm, torch.Generator(device="cuda").manual_seed(0),
                                  dtype=torch.bfloat16, device="cuda")
    heads0 = clip.init_params(mcfg, torch.Generator().manual_seed(SEED), device="cuda")
    train_ds, _, _ = dataset.generate_datasets(WORK / "train_data", seed=42)
    peps, recs = next(clip_engine._accumulate(dataset.PairLoader(train_ds, n // 16, seed=SEED),
                                              16))
    return mcfg, esm_params, heads0, peps, recs


def check_packed_paths() -> dict:
    """The 256 pairs' pooled embeddings in eval mode through the packed path
    (K1 on packed segments) against the grouped path (4 length groups, K1
    on padded rows): cosine >= COSINE_MIN per row on both sides. Then one
    packed train step (dropout 0.1) run twice from the same heads, Adam
    state and generator seed: the same loss and the same updated heads, to
    the bit."""
    mcfg, esm_params, heads0, peps, recs = packed_setup()
    tok = common.make_tokenizer()
    before = attention.fused_attention.launches
    packed = to_device(packed_engine.tokenize_packed(tok, peps, recs), "cuda")
    got = packed_engine.embed_packed(heads0, esm_params, packed, mcfg)
    k1_packed = attention.fused_attention.launches - before
    order = sorted(range(len(recs)), key=lambda i: len(recs[i]))   # tokenize_grouped's order
    with torch.inference_mode():
        pairs = [clip.forward(heads0, esm_params, clip_engine.expand_batch(to_device(b, "cuda")),
                              mcfg)
                 for b in clip_engine.tokenize_grouped(tok, peps, recs, 4)]
    inv = torch.argsort(torch.tensor(order, device="cuda"))
    cos = {side: row_cosines(g.cpu().numpy(),
                             torch.cat([p[j] for p in pairs])[inv].cpu().numpy())
           for j, (side, g) in enumerate(zip(("pep", "rec"), got))}
    cos_min = min(float(c.min()) for c in cos.values())
    log(f"[packed] embed_packed ({len(packed_chunks(packed))} chunk forwards, attention_fwd "
        f"{k1_packed}) against the grouped path on the same {len(recs)} pairs: cosine min pep "
        f"{float(cos['pep'].min()):.6f}, rec {float(cos['rec'].min()):.6f} (>= {COSINE_MIN})")
    if cos_min < COSINE_MIN or k1_packed != 30 * len(packed_chunks(packed)):
        raise AssertionError(f"packed embeddings: cosine {cos_min}, attention_fwd {k1_packed}")

    cfg = clip_engine.EngineConfig(model=mcfg, packed=True)
    runs = []
    for _ in range(2):
        params = clone_tree(heads0)
        state = optimizer.adam(TRAIN_LR).init(params)
        _, _, loss = clip_engine.make_train_step(cfg)(
            params, state, esm_params, packed, torch.Generator(device="cuda").manual_seed(1))
        runs.append((loss.cpu(), checkpoint._flatten(params)))
    (la, pa), (lb, pb) = runs
    same = bool(torch.equal(la, lb)) and all(torch.equal(pa[k], pb[k]) for k in pa)
    log(f"[packed] one packed train step twice from the same state (dropout 0.1, same "
        f"generator seed): losses {float(la):.9f}, {float(lb):.9f}; heads after the step "
        f"{'equal' if same else 'DIFFER'} to the bit")
    if not same:
        raise AssertionError("the packed train step is not deterministic")
    return {"cos_min": cos_min, "k1_embed": k1_packed, "deterministic": same}


def launches_per_step(packed: bool, engine=None) -> dict:
    """Kernel launches, device busy time and peak memory of one train step
    at global batch 256 under torch.profiler: frozen (packed, or 4 length
    groups), or with ``engine`` (finetune) the packed unfrozen step."""
    mcfg, esm_params, heads0, peps, recs = packed_setup()
    cfg = clip_engine.EngineConfig(model=mcfg, packed=packed, length_groups=4)
    batch = to_device(clip_engine._prepare(common.make_tokenizer(), cfg)(peps, recs), "cuda")
    if engine is finetune:
        params, esm_params = finetune.init_params(esm_params, clone_tree(heads0)), {}
        state = finetune.make_optimizer(cfg).init(params)
    else:
        params = clone_tree(heads0)
        state = optimizer.adam(TRAIN_LR).init(params)
    step = (engine or clip_engine).make_train_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    step(params, state, esm_params, batch, gen)                 # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, state, esm_params, batch, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    out = {"launches": sum(e.count for e in kernels), "busy_ms": busy_ms,
           "busy_share": busy_ms / (1e3 * wall),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    what = ("packed finetune" if engine is finetune else "packed" if packed else "grouped")
    log(f"[packed] one {what} step under torch.profiler: {out['launches']} kernel launches, "
        f"device busy {busy_ms:.4f} ms of {1e3 * wall:.4f} ms "
        f"({100 * out['busy_share']:.2f}%); peak memory {out['peak_memory_gb']:.4f} GB")
    return out


def run_packed_phase() -> dict:
    data_dir = WORK / "train_data"
    out = run_packed_train(data_dir)
    embed_check(out["run"] / "best_model.npz", sequences_only(data_dir / "receptor.fasta"),
                "the packed run's best_model.npz")
    out["paths"] = check_packed_paths()
    out["per_step"] = {"packed": launches_per_step(True), "grouped": launches_per_step(False)}
    return out


def run_packed_unfrozen(name: str, data_dir: Path, mode_args: list[str], engine) -> dict:
    """cli.main --packed --finetune or --lora-rank for one epoch at the
    defaults (global batch 256, flat packing, remat); checks the artifacts,
    the chunk forwards of each pass against those the loaders' batches take
    when packed again here by the unfrozen rule (unfrozen_chunks), and every
    kernel's launch count: per step K1 30 times per pass-1 chunk and 60 per
    pass-2 chunk (forward and remat recompute), K5 30 per pass-2 chunk, K2
    once forward and once backward; per eval batch K1 30 per chunk forward
    (the frozen rule) and K2 once."""
    runs = WORK / f"runs_{name}"
    t0 = time.perf_counter()
    with counted_forwards() as forwards, timed_steps(engine) as ends:
        reset_counts()
        train_cli.main(["--synthetic-fixture", "--data-dir", str(data_dir), "--fixture-families",
                        str(FIXTURE_FAMILIES), "--epochs", "1", "--runs-dir", str(runs),
                        "--packed"] + mode_args)
        k1 = attention.fused_attention.launches
        k5 = attention.fused_attention_bwd.launches
        counts = infonce_counts()
        check_default_path(name)
    wall = time.perf_counter() - t0
    run = check_run_dir(runs)
    steps, evals = packed_epoch_chunks(data_dir, unfrozen_chunks)
    step_chunks = [c for chunks in steps for c in chunks]
    eval_chunks = [c for chunks in evals for c in chunks]
    want_forwards = 2 * step_chunks + eval_chunks             # pass 1, pass 2, eval
    want_k1 = 90 * len(step_chunks) + 30 * len(eval_chunks)
    want_k5 = 30 * len(step_chunks)
    want = {"infonce": (len(steps) + len(evals), len(steps)), "infonce_tiled": (0, 0)}
    if (len(ends), sorted(forwards), k1, k5) != (len(steps), sorted(want_forwards), want_k1,
                                                 want_k5):
        raise AssertionError(f"{name}: {len(ends)} steps (want {len(steps)}), {len(forwards)} "
                             f"chunk forwards (want {len(want_forwards)}), attention_fwd {k1} "
                             f"(want {want_k1}), attention_bwd {k5} (want {want_k5})")
    if counts != want:
        raise AssertionError(f"{name}: InfoNCE (forward, backward) calls {counts}, want {want}")
    metrics = json.loads((run / "metrics.jsonl").read_text().splitlines()[0])
    per_pass = len(step_chunks) / len(steps)
    log(f"[train] {name}: global batch 256 packed, {len(steps)} steps, {len(evals)} eval "
        f"batches of 16; train loss {metrics['train_loss']:.6f}, val loss "
        f"{metrics['val_loss']:.6f}; chunk forwards (rows, L) of the first step's pass "
        f"{steps[0]}, {per_pass:.2f} a pass (the one-bucket step: 32); {len(forwards)} backbone "
        f"forwards; attention_fwd {k1} (30 per pass-1 chunk, 60 per pass-2 chunk, 30 per eval "
        f"chunk), attention_bwd {k5} (30 per pass-2 chunk); InfoNCE (forward, backward) calls "
        f"{counts}; epoch {metrics['seconds']:.2f} s, cli.main {wall:.2f} s")
    return {"run": run, "steps": len(steps), "ends": ends, "chunks_per_pass": per_pass,
            "launches": {"attention_fwd": k1, "attention_bwd": k5,
                         "filip_maxsim": maxsim.filip_similarity_fused.launches,
                         **{k: v[0] for k, v in counts.items()}}}


def run_packed_unfrozen_phase() -> dict:
    """cli.main --packed --finetune and --packed --lora-rank 8, each then
    embedding with its best_model.npz; one packed finetune step's launches,
    busy share and peak memory."""
    data_dir = WORK / "train_data"
    recs = sequences_only(data_dir / "receptor.fasta")
    out = {"finetune": run_packed_unfrozen("train_finetune_packed", data_dir, ["--finetune"],
                                           finetune)}
    embed_check(out["finetune"]["run"] / "best_model.npz", recs,
                "the packed finetune run's best_model.npz")
    out["lora"] = run_packed_unfrozen("train_lora_packed", data_dir,
                                      ["--lora-rank", str(LORA_RANK)], lora)
    embed_check(out["lora"]["run"] / "best_model.npz", recs,
                "the packed LoRA run's best_model.npz")
    out["per_step"] = launches_per_step(True, finetune)
    return out


# ---------------------------------------------------------------------------
# Phase 7, FILIP training: cli.main_2protein_filip, K4 on its blocks, its
# backward against float64 autograd, its step against the plain max-sim
# ---------------------------------------------------------------------------

def filip_data(data_dir: Path) -> tuple:
    return dataset.generate_datasets(data_dir, "protein1", "protein2", seed=42,
                                     max_sequence_length=2000)


def filip_forwards_per_batch(batch_size: int, groups: int, chunks: int) -> int:
    """Backbone forwards of one FILIP train or eval batch, both sides: one
    bucket in _snap_chunks(batch, chunks) microbatches, or each of the
    length groups (tokenize_grouped: the last takes the remainder) in
    _snap_chunks(rows, chunks // groups)."""
    if groups == 1:
        return 2 * filip_engine._snap_chunks(batch_size, chunks)
    g = batch_size // groups
    rows = [g] * (groups - 1) + [batch_size - g * (groups - 1)]
    return 2 * sum(filip_engine._snap_chunks(r, max(1, chunks // groups)) for r in rows)


def run_filip_train(name: str, data_dir: Path, extra: list[str]) -> dict:
    """cli.main_2protein_filip for one epoch: the artifacts, and every
    kernel's launch count against the loaders: K1 30 per backbone forward,
    K4 groups^2 per train step and per eval batch, no other kernel."""
    runs = WORK / f"runs_{name}"
    argv = ["--synthetic-fixture", "--data-dir", str(data_dir), "--fixture-families",
            str(FILIP_FIXTURE_FAMILIES), "--epochs", "1", "--runs-dir", str(runs)] + extra
    args = filip_cli.build_argparser().parse_args(argv)
    bs, groups = args.batch_size, args.length_groups
    t0 = time.perf_counter()
    with counted_forwards() as forwards, timed_steps(filip_engine) as ends:
        reset_counts()
        filip_cli.main(argv)
        k1 = attention.fused_attention.launches
        k4 = maxsim.filip_similarity_fused.launches
        k5 = attention.fused_attention_bwd.launches
        counts = infonce_counts()
        check_default_path(name)
    wall = time.perf_counter() - t0
    run = check_run_dir(runs)
    train_ds, val_ds, test_ds = filip_data(data_dir)
    steps = len(train_ds) // bs
    evals = len(val_ds) // bs + len(test_ds) // bs
    want_forwards = filip_forwards_per_batch(bs, groups, args.num_chunks) * (steps + evals)
    want_k4 = groups ** 2 * (steps + evals)
    got = (len(ends), len(forwards), k1, k4, k5)
    want = (steps, want_forwards, 30 * want_forwards, want_k4, 0)
    if got != want or any(v != (0, 0) for v in counts.values()):
        raise AssertionError(f"{name}: (steps, backbone forwards, attention_fwd, filip_maxsim, "
                             f"attention_bwd) {got}, want {want}; InfoNCE calls {counts} "
                             f"(FILIP's loss is plain PyTorch)")
    metrics = json.loads((run / "metrics.jsonl").read_text().splitlines()[0])
    log(f"[filip train] {name}: batch {bs} in {groups} length group(s), "
        f"{args.num_chunks} chunk(s){', DCL' if args.use_dcl else ''}; {steps} steps, {evals} "
        f"eval batches; train loss {metrics['train_loss']:.6f}, val loss "
        f"{metrics['val_loss']:.6f}; {len(forwards)} backbone forwards, attention_fwd {k1} = "
        f"30 per forward; filip_maxsim {k4} = {groups ** 2} per step and per eval batch; "
        f"epoch {metrics['seconds']:.2f} s, cli.main_2protein_filip {wall:.2f} s")
    return {"run": run, "args": args, "steps": steps, "evals": evals, "ends": ends,
            "launches": {"attention_fwd": k1, "filip_maxsim": k4}}


@functools.cache
def filip_setup() -> tuple:
    """(FILIP config, backbone) of the FILIP runs: t30_150M in bf16 with the
    CLIs' random init (seed 0), heads of dim FILIP_D."""
    cfg_esm = common.esm_config("t30_150M", "bfloat16")
    mcfg = filip.FILIPConfig(input_dim=cfg_esm.hidden_size, embedding_dim=FILIP_D, esm=cfg_esm)
    esm_params = esm2.init_params(cfg_esm, torch.Generator(device="cuda").manual_seed(0),
                                  dtype=torch.bfloat16, device="cuda")
    return mcfg, esm_params


def filip_first_batch(data_dir: Path, args) -> tuple:
    """(engine config, device batch) of a run's first train batch of epoch
    0, tokenized as the path tokenizes it (one bucket or length groups)."""
    mcfg, _ = filip_setup()
    cfg = clip_engine.EngineConfig(model=mcfg, batch_size=args.batch_size, accumulated_batches=1,
                                   num_chunks=args.num_chunks, length_groups=args.length_groups,
                                   filip_use_dcl=args.use_dcl)
    loader = dataset.PairLoader(filip_data(data_dir)[0], args.batch_size, seed=args.seed)
    loader.reseed_epoch(0)
    peps, recs = next(iter(loader))
    return cfg, to_device(clip_engine._prepare(common.make_tokenizer(), cfg)(peps, recs), "cuda")


def filip_path_blocks(run: dict, data_dir: Path) -> list[tuple]:
    """The K4 blocks of the run's first train batch, (ha, hb, mask_a,
    mask_b) for every (group, group) pair: the tokens of the run's
    best_model.npz heads in eval mode."""
    mcfg, esm_params = filip_setup()
    heads = checkpoint.load_npz(run["run"] / "best_model.npz",
                                filip.init_params(mcfg, torch.Generator(), device="meta"), "cuda")
    _, batch = filip_first_batch(data_dir, run["args"])
    groups = [clip_engine.expand_batch(b) for b in (batch if isinstance(batch, tuple)
                                                    else (batch,))]
    with torch.no_grad():
        sides = [(*filip.encode_batch_tokens(heads, esm_params, b, mcfg), b["pep_mask"],
                  b["rec_mask"]) for b in groups]
    return [(a[0], b[1], a[2], b[3]) for a in sides for b in sides]


def end_blocks(blocks: list) -> list:
    """The first block of a step and, when it has more, its last (the
    grouped step's widest rectangle)."""
    return blocks[:1] + blocks[1:][-1:]


def tied(h: torch.Tensor) -> torch.Tensor:
    """h with every odd token a copy of the even token before it: each
    max over those tokens ties exactly, in every arithmetic."""
    out = h.clone()
    out[:, 1::2] = h[:, 0::2][:, :out[:, 1::2].shape[1]]
    return out


def filip_path_cases(blocks: list[tuple], gen: torch.Generator) -> list:
    """K4's check inputs on the FILIP path's own blocks: every block as
    the step gives it; and from the first block and the last (the grouped
    run's widest rectangle) an a-row and a b-row with no valid token;
    forced ties (tied tokens); b-row 0 cut to 65 valid tokens (a tile whose
    only valid token is its first: the skip fault); tokens at norm
    K4_SHORT_SCALE with 1-4 valid tokens a row (plain TF32)."""
    def case(label, ha, hb, ma, mb):
        return (ha.shape[0], hb.shape[0], ha.shape[1], hb.shape[1]), (ha, hb, ma, mb), label

    def short(m):
        n = torch.randint(1, 5, (m.shape[0], 1), device="cuda", generator=gen)
        return (torch.arange(m.shape[1], device="cuda")[None] < n).to(torch.int32)

    cases = [case("path block", *blk) for blk in blocks]
    for ha, hb, ma, mb in end_blocks(blocks):
        empty_a, empty_b = ma.clone(), mb.clone()
        empty_a[ma.shape[0] // 2] = 0
        empty_b[mb.shape[0] // 2] = 0
        cases.append(case("path block, empty rows", ha, hb, empty_a, empty_b))
        cases.append(case("path block, tied tokens", tied(ha), tied(hb), ma, mb))
        if hb.shape[1] > 64:
            cut = mb.clone()
            cut[0] = 0
            cut[0, :65] = 1
            cases.append(case("path block, b-row 0 of 65 tokens", ha, hb, ma, cut))
        cases.append(case("path block, short", K4_SHORT_SCALE * ha, K4_SHORT_SCALE * hb,
                          short(ma), short(mb)))
    return cases


def check_filip_path_k4(blocks: dict, fault_libs: dict, gen: torch.Generator) -> dict:
    """K4 against its plain version on both runs' blocks (filip_path_cases),
    then against its two planted faults, which must fail: the skip fault
    every case with a one-token tile, plain TF32 every short case."""
    cases = [c for blks in blocks.values() for c in filip_path_cases(blks, gen)]
    err = check_maxsim(cases)
    faults = check_maxsim_faults(fault_libs, cases)
    return {"max_abs_err": err, "cases": len(cases),
            "shapes": sorted({tuple(c[0]) for c in cases if c[2] == "path block"}),
            "fault": {k: {"worst_ratio": v["worst_ratio"], "cases_failed": v["cases_failed"]}
                      for k, v in faults.items()}}


def check_filip_backward(blocks: dict, gen: torch.Generator) -> float:
    """The max-sim backward on the card (through the wrapper's autograd
    Function: K4 forward, ops.filip.maxsim_backward) against autograd
    through maxsim_reference in float64 on the card, for random cotangents,
    on the path's first block of each run and the grouped run's last:
    tokens rounded to multiples of 1/16 and tied (every score exact in f32
    and float64, so both see the same ties, which amax also splits
    evenly), with the path's masks and with an a-row and a b-row emptied.
    Per output max|err| <= MAXSIM_BWD_RTOL max|ref|."""
    worst = 0.0
    for ha, hb, ma, mb in [b for blks in blocks.values() for b in end_blocks(blks)]:
        qa, qb = (tied(torch.round(h * 16) / 16) for h in (ha, hb))
        empty_a, empty_b = ma.clone(), mb.clone()
        empty_a[0] = 0
        empty_b[-1] = 0
        for label, (m_a, m_b) in (("path masks", (ma, mb)), ("empty rows", (empty_a, empty_b))):
            ga = torch.randn(ha.shape[0], hb.shape[0], device="cuda", generator=gen)
            gb = torch.randn(ha.shape[0], hb.shape[0], device="cuda", generator=gen)
            xa, xb = qa.clone().requires_grad_(True), qb.clone().requires_grad_(True)
            torch.autograd.backward(maxsim.filip_similarity_fused(xa, xb, m_a, m_b, 1.0),
                                    (ga, gb))
            ra, rb = qa.double().requires_grad_(True), qb.double().requires_grad_(True)
            torch.autograd.backward(maxsim.maxsim_reference(ra, rb, m_a, m_b),
                                    (ga.double(), gb.double()))
            errs = [float((x.grad.double() - r.grad).abs().max() / r.grad.abs().max())
                    for x, r in ((xa, ra), (xb, rb))]
            s = torch.einsum("atd,jsd->ajts", qa, qb)
            valid = (m_a[:, None, :, None] * m_b[None, :, None, :]) > 0
            sm = torch.where(valid, s, maxsim._NEG)
            ties = int((((sm == sm.amax(3, keepdim=True)) & valid).sum(3) > 1).sum())
            ok = max(errs) <= MAXSIM_BWD_RTOL and ties > 0
            log(f"[filip train] max-sim backward (Ba, Bb, TA, TB)="
                f"{(ha.shape[0], hb.shape[0], ha.shape[1], hb.shape[1])}, {label}, {ties} tied "
                f"row maxima: max|err| / max|ref| dha {errs[0]:.4g}, dhb {errs[1]:.4g} against "
                f"float64 autograd (tolerance {MAXSIM_BWD_RTOL:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("the max-sim backward disagrees with float64 autograd")
            worst = max(worst, *errs)
    return worst


def check_filip_retrieve(run: dict, data_dir: Path) -> float:
    """embed --filip of 64 receptors with the run's best_model.npz, then
    retrieve --filip for 4 peptides: one K4 launch, hits against the plain
    max-sim at each rank."""
    mcfg, esm_params = filip_setup()
    ckpt = ["--checkpoint", str(run["run"] / "best_model.npz")]
    peps = sequences_only(data_dir / "protein1.fasta")[:4]
    recs = sequences_only(data_dir / "protein2.fasta")[:64]
    (WORK / "filip_train_index.fasta").write_text("".join(f">r{i}\n{s}\n"
                                                          for i, s in enumerate(recs)))
    (WORK / "filip_train_queries.fasta").write_text("".join(f">p{i}\n{s}\n"
                                                            for i, s in enumerate(peps)))
    index = WORK / "filip_train_index.npz"
    embed.main(ckpt + ["--filip", "--fasta", str(WORK / "filip_train_index.fasta"), "--side",
                       "rec", "--out", str(index)])
    before = maxsim.filip_similarity_fused.launches
    retrieve.main(ckpt + ["--filip", "--index", str(index), "--queries",
                          str(WORK / "filip_train_queries.fasta"), "--side", "pep", "--k", "10",
                          "--out", str(WORK / "filip_train_hits.tsv")])
    launched = maxsim.filip_similarity_fused.launches - before
    heads = checkpoint.load_npz(run["run"] / "best_model.npz",
                                filip.init_params(mcfg, torch.Generator(), device="meta"), "cuda")
    toks, mask = embed.embed_sequences_tokens(heads, esm_params, peps, "pep", mcfg,
                                              common.make_tokenizer(), torch.device("cuda"),
                                              batch_size=32, pad_batch=True)
    plain, ids = plain_filip_scores(toks, mask.sum(1), index, heads["temperature"])
    worst = max(check_hits(f"retrieve --filip (trained heads) query {q}", [h for h, _ in row],
                           [sc for _, sc in row], plain[q], ids)
                for q, row in enumerate(read_tsv(WORK / "filip_train_hits.tsv", 10)))
    if launched != scorer_blocks(len(peps), len(recs)):
        raise AssertionError(f"retrieve --filip launched filip_maxsim {launched} times")
    log(f"[filip train] retrieve --filip with the batch-10 run's best_model.npz: 4 queries over "
        f"64 receptors, {launched} filip_maxsim launch; hits within {worst:.3g} of the plain "
        f"max-sim at each rank")
    return worst


def run_filip_train_phase(fault_libs: dict, gen: torch.Generator) -> dict:
    data_dir = WORK / "filip_data"
    runs = {name: run_filip_train(name, data_dir, extra) for name, extra in FILIP_RUNS}
    recs = sequences_only(data_dir / "protein2.fasta")
    peps = sequences_only(data_dir / "protein1.fasta")
    profile = (f"{FILIP_FIXTURE_FAMILIES} families, {len(recs)} pairs, protein2 "
               f"{min(map(len, recs))}-{max(map(len, recs))} aa, protein1 "
               f"{min(map(len, peps))}-{max(map(len, peps))} aa")
    log(f"[filip train] fixture: {profile}")
    blocks = {name: filip_path_blocks(run, data_dir) for name, run in runs.items()}
    return {"runs": runs, "profile": profile, "blocks": blocks,
            "k4": check_filip_path_k4(blocks, fault_libs, gen),
            "backward_err": check_filip_backward(blocks, gen),
            "retrieve_err": check_filip_retrieve(runs["filip_10"], data_dir)}


@contextlib.contextmanager
def plain_maxsim():
    """The wrapper's autograd Function runs maxsim_reference in K4's place
    (its backward is the same) while the block runs."""
    saved = maxsim._raw_maxsim
    maxsim._raw_maxsim = maxsim.maxsim_reference
    try:
        yield
    finally:
        maxsim._raw_maxsim = saved


def filip_step(cfg, batch, heads0, maxsim_cm=contextlib.nullcontext) -> tuple:
    """One FILIP train step from heads0 (Adam lr TRAIN_LR, dropout 0.1 from
    a seeded generator): (loss, gradients by leaf, K4 launches)."""
    _, esm_params = filip_setup()
    params = clone_tree(heads0)
    state = capturing(optimizer.adam(TRAIN_LR).init(params), params)
    before = maxsim.filip_similarity_fused.launches
    with maxsim_cm():
        _, _, loss = filip_engine.make_train_step(cfg)(
            params, state, esm_params, batch, torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    return float(loss), state.grads, maxsim.filip_similarity_fused.launches - before


def check_filip_step(runs: dict, data_dir: Path, fault_libs: dict) -> dict:
    """For each FILIP run's configuration, one step on its first batch
    through K4 against the same step through K4's plain version in the same
    autograd Function: the loss within FILIP_STEP_TOL relative and every
    head gradient within FILIP_STEP_TOL of the step's largest gradient
    entry (the temperature's gradient sums terms of that scale that nearly
    cancel). The step through K4 run again equals itself to the bit. The
    same step through each planted K4 fault is read (not held)."""
    mcfg, _ = filip_setup()
    heads0 = filip.init_params(mcfg, torch.Generator().manual_seed(SEED), device="cuda")
    out = {}
    for name, run in runs.items():
        cfg, batch = filip_first_batch(data_dir, run["args"])
        blocks = cfg.length_groups ** 2
        lk, gk, nk = filip_step(cfg, batch, heads0)
        lp, gp, np_ = filip_step(cfg, batch, heads0, plain_maxsim)
        la, ga, na = filip_step(cfg, batch, heads0)
        if (nk, np_, na) != (blocks, 0, blocks):
            raise AssertionError(f"FILIP step check {name}: filip_maxsim launches {nk}, {np_}, "
                                 f"{na}; want {blocks}, 0, {blocks}")
        scale = max(float(g.abs().max()) for g in gp.values())
        gaps = {k: float((gk[k] - gp[k]).abs().max()) / scale for k in gp}
        loss_err = abs(lk - lp) / abs(lp)
        same = lk == la and all(torch.equal(gk[k], ga[k]) for k in gk)
        faults = {}
        for fault in ("maxsim_skip", "maxsim_tf32"):
            with maxsim_kernel(fault_libs[fault]["filip_maxsim"]):
                lf, gf, _ = filip_step(cfg, batch, heads0)
            faults[fault] = {"loss_ratio": abs(lf - lp) / abs(lp) / FILIP_STEP_TOL,
                             "grad_ratio": max(float((gf[k] - gp[k]).abs().max()) / scale
                                               for k in gp) / FILIP_STEP_TOL}
        ok = loss_err <= FILIP_STEP_TOL and max(gaps.values()) <= FILIP_STEP_TOL and same
        worst = max(gaps, key=gaps.get)
        log(f"[step] FILIP {name} ({cfg.length_groups} group(s), {blocks} K4 block(s), "
            f"{'DCL' if cfg.filip_use_dcl else 'no DCL'}) through filip_maxsim vs its plain "
            f"version: loss {lk:.7f} vs {lp:.7f}, relative |err| {loss_err:.3g}; gradients "
            f"max |err| / the step's largest entry {gaps[worst]:.3g} at {worst} (temperature "
            f"{gaps['temperature']:.3g}; tolerance {FILIP_STEP_TOL:g}); run again equal to the "
            f"bit: {same}; planted faults (x tolerance, loss / gradients): "
            + ", ".join(f"{k} {v['loss_ratio']:.4g} / {v['grad_ratio']:.4g}"
                        for k, v in faults.items()) + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the FILIP step through filip_maxsim ({name}) disagrees with "
                                 "the plain step or with itself")
        out[name] = {"loss_rel_err": loss_err, "grad_rel_err": gaps[worst],
                     "temperature_grad_rel_err": gaps["temperature"], "bitwise_equal": same,
                     "fault": faults}
    return out


def time_filip_train(ftctx: dict, data_dir: Path, gpu: str) -> dict:
    """Per FILIP run: pairs/s by CUDA events over the run's steps; K4 on the
    step's blocks (wrapper call by CUDA events, the kernel's device time,
    the plain version, the bound on the blocks' masks); the plain max-sim
    backward of one step's blocks (by CUDA events, host included, and its
    device time) and its share of the step; one step under
    torch.profiler: launches, K4 launches and the device's busy share."""
    out = {}
    for name, run in ftctx["runs"].items():
        a = run["args"]
        rate = time_train_steps({name: run, "profile": ftctx["profile"]}, name,
                                f"FILIP train step ({a.length_groups} length group(s), "
                                f"{a.num_chunks} chunk(s))", gpu, pairs=a.batch_size)
        step_ms = 1e3 * a.batch_size / rate
        blocks = ftctx["blocks"][name]
        rows = []
        for ha, hb, ma, mb in end_blocks(blocks):
            def call():
                return maxsim.filip_similarity_fused(ha, hb, ma, mb, 1.0)
            ms = cuda_ms(call, 50)
            kernel_ms = device_ms(call, 50, kernel="filip_maxsim_kernel")
            plain_ms = cuda_ms(lambda: maxsim.maxsim_reference(ha, hb, ma, mb), 5, warmup=1)
            bound_ms, bound_by, counts = maxsim_bound(ma, mb, FILIP_D)
            shape = [ha.shape[0], hb.shape[0], ha.shape[1], hb.shape[1], FILIP_D]
            log(f"[time] filip_maxsim on the FILIP {name} step's block {tuple(shape)}: call "
                f"{ms:.6f} ms (kernel's device time {kernel_ms:.6f}), plain {plain_ms:.6f} ms, "
                f"bound {bound_ms:.6f} ms ({bound_by}: {counts}) = {100 * bound_ms / ms:.2f}% "
                f"of the bound | {gpu}")
            rows.append({"shape": shape, "ms": ms, "device_ms": kernel_ms, "plain_ms": plain_ms,
                         "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by})
        cot = [(torch.randn(ha.shape[0], hb.shape[0], device="cuda"),
                torch.randn(ha.shape[0], hb.shape[0], device="cuda")) for ha, hb, _, _ in blocks]

        def backward():
            for (ha, hb, ma, mb), (ga, gb) in zip(blocks, cot):
                maxsim.maxsim_backward(ha, hb, ma, mb, ga, gb)
        bwd_ms = cuda_ms(backward, 10)
        bwd_device_ms = device_ms(backward, 10)
        per_step = filip_launches_per_step(run, data_dir)
        log(f"[time] the plain max-sim backward of one FILIP {name} step ({len(blocks)} "
            f"block(s)): {bwd_ms:.4f} ms by CUDA events ({bwd_device_ms:.4f} ms device time) "
            f"= {100 * bwd_ms / step_ms:.2f}% of the step's {step_ms:.4f} ms | {gpu}")
        out[name] = {"pairs_per_s": rate, "step_ms": step_ms, "k4_blocks": rows,
                     "backward_ms": bwd_ms, "backward_device_ms": bwd_device_ms,
                     "backward_share": bwd_ms / step_ms, "per_step": per_step}
    return out


def filip_launches_per_step(run: dict, data_dir: Path) -> dict:
    """Kernel launches and the device's busy share of one FILIP step (the
    run's configuration, its first batch) under torch.profiler."""
    mcfg, esm_params = filip_setup()
    cfg, batch = filip_first_batch(data_dir, run["args"])
    params = filip.init_params(mcfg, torch.Generator().manual_seed(SEED), device="cuda")
    state = optimizer.adam(TRAIN_LR).init(params)
    step = filip_engine.make_train_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    step(params, state, esm_params, batch, gen)                 # warm
    torch.cuda.synchronize()
    k4 = maxsim.filip_similarity_fused.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, state, esm_params, batch, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    k4_ms = sum(e.self_device_time_total for e in kernels if "filip_maxsim" in e.key) / 1e3
    out = {"launches": sum(e.count for e in kernels), "busy_ms": busy_ms,
           "busy_share": busy_ms / (1e3 * wall), "wall_ms": 1e3 * wall,
           "filip_maxsim": maxsim.filip_similarity_fused.launches - k4, "k4_device_ms": k4_ms}
    log(f"[time] one FILIP step (batch {cfg.batch_size}, {cfg.length_groups} group(s)) under "
        f"torch.profiler: {out['launches']} kernel launches ({out['filip_maxsim']} "
        f"filip_maxsim, {k4_ms:.4f} ms of device time), device busy {busy_ms:.4f} ms of "
        f"{out['wall_ms']:.4f} ms ({100 * out['busy_share']:.2f}%)")
    return out


# ---------------------------------------------------------------------------
# Phase 8: one train step through K2 / K3 against the plain loss
# ---------------------------------------------------------------------------

def capturing(state, params):
    """Make ``state.apply`` keep, by leaf name, the gradients it applies."""
    named = checkpoint._flatten(params)
    apply = state.apply

    def capture():   # FILIP's steps give emb_ffn, which they do not read, no gradient
        state.grads = {k: t.grad.detach().clone() for k, t in named.items()
                       if t.grad is not None}
        apply()

    state.apply = capture
    return state


def clone_tree(tree):
    return {k: clone_tree(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.clone()


def step_readings(pool: int, packed: bool = False) -> dict:
    """One frozen train step at global batch ``pool`` through K2 or K3 (by
    clip_engine's rule) and through the plain loss, from the same heads and
    batch (4 length groups, or with ``packed`` one packed batch): the loss
    within 1e-5 relative and the gradients within 1e-5 of each leaf's
    largest. Adam's first update is lr g / (|g| + eps): when g
    moves by dg it moves by at most 2 lr |dg| / (max|g| + eps), which near
    g = 0 turns f32 noise into up to lr; each updated parameter is held to
    that bound plus 1e-6, and the count beyond a flat 1e-5 is printed.
    Returns the readings and whether they are within the limits ("ok")."""
    cfg_esm = common.esm_config("t30_150M", "bfloat16")
    mcfg = clip.CLIPConfig(input_dim=cfg_esm.hidden_size, dropout=0.0, esm=cfg_esm)
    cfg = clip_engine.EngineConfig(model=mcfg, batch_size=pool // 16, accumulated_batches=16,
                                   length_groups=4, packed=packed)
    esm_params = esm2.init_params(cfg_esm, torch.Generator(device="cuda").manual_seed(0),
                                  dtype=torch.bfloat16, device="cuda")
    data_dir = WORK / "train_data"
    if not (data_dir / "receptor.fasta").exists():
        write_fixture(data_dir, n_families=FIXTURE_FAMILIES, seed=42)
    train_ds, _, _ = dataset.generate_datasets(data_dir, seed=42)
    loader = dataset.PairLoader(train_ds, pool // 16, seed=SEED)
    peps, recs = next(clip_engine._accumulate(loader, 16))
    batch = to_device(clip_engine._prepare(common.make_tokenizer(), cfg)(peps, recs), "cuda")
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
    log(f"[step] global batch {pool}{' packed' if packed else ''} through {kernel} vs the "
        f"plain loss (dropout 0, Adam "
        f"lr {TRAIN_LR:g}): loss {lk:.6f} vs {lp:.6f}, relative |err| {loss_err:.3g} (tolerance "
        f"1e-5); gradients max |err| / leaf max {grad_err:.3g} (tolerance 1e-5); updated "
        f"params max |err| {param_err:.3g}, {over_bound} of {n} past Adam's bound, {over_flat} "
        f"past a flat 1e-5 {'ok' if ok else 'FAIL'}")
    return {"kernel": kernel, "loss_rel_err": loss_err, "grad_rel_err": grad_err,
            "param_max_abs_err": param_err, "over_bound": over_bound, "ok": ok}


def check_step(pool: int, packed: bool = False) -> dict:
    """step_readings, which must be within their limits."""
    r = step_readings(pool, packed)
    if not r["ok"]:
        raise AssertionError(f"the {'packed ' if packed else ''}train step through "
                             f"{r['kernel']} disagrees with the plain loss")
    return {k: r[k] for k in ("loss_rel_err", "grad_rel_err", "param_max_abs_err")}


def plain_forward(q, k, v, segments, with_lse=False):
    """K1's plain versions in K1's place (ops.attention._forward)."""
    out = attention.attention_reference(q, k, v, segments)
    return (out, attention.attention_reference_lse(q, k, segments)) if with_lse else out


def plain_backward(q, k, v, segments, do, lse):
    """K5's plain version in K5's place: it recomputes what lse holds."""
    return attention.attention_reference_bwd(q, k, v, segments, do)


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


def finetune_step_runs(fault_libs: dict, packed: bool = False) -> dict:
    """One finetune step at global batch 256 (one pad bucket in 16 chunks,
    or with ``packed`` the packed step over the same pairs; remat, dropout
    0, the two-group Adam) from the same f32 master weights and batch, once
    per attention path: {name: (loss, {leaf: gradient})}.
    "kernel" runs K1 and K5; "k1_plain_bwd" K1 and K5's plain version;
    "plain_fwd_k5" K1's plain version and K5; "plain" both plain versions
    (the TPU kernels' semantics, rounding where they round); "fault" K1
    and the swept_tiles planted-fault build of K5 (its dk/dv loop drops
    the last query tile); "eager" and "eager_f32"
    attention_impl="eager" (plain attention through autograd) with a bf16
    and an f32 backbone. The packed step runs "kernel" twice ("again")
    and leaves out "plain_fwd_k5" and "plain"."""
    base = common.esm_config("t30_150M", "bfloat16")
    esm0 = esm2.init_params(base, torch.Generator(device="cuda").manual_seed(0),
                            dtype=torch.bfloat16, device="cuda")
    data_dir = WORK / "train_data"
    if not (data_dir / "receptor.fasta").exists():
        write_fixture(data_dir, n_families=FIXTURE_FAMILIES, seed=42)
    train_ds, _, _ = dataset.generate_datasets(data_dir, seed=42)
    peps, recs = next(clip_engine._accumulate(dataset.PairLoader(train_ds, 16, seed=SEED), 16))
    tokenize = packed_engine.tokenize_packed if packed else clip_engine.tokenize_pair_batch
    batch = to_device(tokenize(common.make_tokenizer(), peps, recs), "cuda")
    heads0 = clip.init_params(clip.CLIPConfig(input_dim=base.hidden_size, esm=base),
                              torch.Generator().manual_seed(SEED), device="cuda")
    k1, k5 = attention._forward, attention.fused_attention_bwd
    plain_fwd, plain_bwd = plain_forward, plain_backward
    c = len(unfrozen_chunks(batch)) if packed else 2 * 16       # chunks per pass
    runs = (("kernel", "fused", torch.bfloat16, k1, k5, (90 * c, 30 * c)),
            ("again", "fused", torch.bfloat16, k1, k5, (90 * c, 30 * c)),
            ("k1_plain_bwd", "fused", torch.bfloat16, k1, plain_bwd, (90 * c, 0)),
            ("plain_fwd_k5", "fused", torch.bfloat16, plain_fwd, k5, (0, 30 * c)),
            ("plain", "fused", torch.bfloat16, plain_fwd, plain_bwd, (0, 0)),
            ("fault", "fused", torch.bfloat16, k1, k5, (90 * c, 30 * c)),
            ("eager", "eager", torch.bfloat16, k1, k5, (0, 0)),
            ("eager_f32", "eager", torch.float32, k1, k5, (0, 0)))
    skipped = ("plain_fwd_k5", "plain") if packed else ("again",)
    out = {"shapes": (unfrozen_chunks(batch) if packed else
                      (tuple(batch["pep_ids"].shape), tuple(batch["rec_ids"].shape)))}
    for name, impl, dtype, fwd, bwd, want in runs:
        if name in skipped:
            continue
        esm_cfg = dataclasses.replace(base, attention_impl=impl, compute_dtype=dtype)
        cfg = clip_engine.EngineConfig(
            model=clip.CLIPConfig(input_dim=base.hidden_size, dropout=0.0, esm=esm_cfg),
            packed=packed)
        params = finetune.init_params(esm0, clone_tree(heads0))
        state = capturing(finetune.make_optimizer(cfg).init(params), params)
        before = (attention.fused_attention.launches, k5.launches)
        faulty = (attention_kernels(fault_libs["swept_tiles"], ("attention_bwd",))
                  if name == "fault" else contextlib.nullcontext())
        with attention_function(fwd, bwd), faulty:
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


def check_finetune_step(fault_libs: dict, packed: bool = False) -> dict:
    """K5 inside the finetune step (one pad bucket, or with ``packed`` the
    packed step, which must also repeat to the bit), and the port's
    attention against eager autograd (finetune_step_runs).

    1. K5 in the step: "kernel" against "k1_plain_bwd". Both run K1's
       forward, so the loss and the heads' gradients agree exactly, and the
       backbone's gradients differ only by K5 against its plain version:
       the order of f32 sums before P and dS are rounded to bf16. Every
       leaf within FT_K5_TOL of its largest entry (four bf16 ulps, see
       there), the loss within
       FT_LOSS_TOL relative. The planted fault (K5 built with its dk/dv loop
       dropping the last query tile) must fail this; its largest ratio to
       the limit is printed.
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
    out = finetune_step_runs(fault_libs, packed)
    what = "packed finetune" if packed else "finetune"
    grads = {k: v[1] for k, v in out.items() if k != "shapes"}
    loss = {k: v[0] for k, v in out.items() if k != "shapes"}
    pairs = tuple((a, b) for a, b in (
        ("kernel", "k1_plain_bwd"), ("fault", "k1_plain_bwd"), ("kernel", "plain_fwd_k5"),
        ("kernel", "eager"), ("plain", "eager"), ("kernel", "eager_f32"),
        ("k1_plain_bwd", "eager_f32"), ("plain_fwd_k5", "eager_f32"), ("plain", "eager_f32"),
        ("eager", "eager_f32")) if a in grads and b in grads)
    gaps = {f"{a}_vs_{b}": leaf_gaps(grads[a], grads[b]) for a, b in pairs}
    summary = {name: {"loss_rel": abs(loss[a] - loss[b]) / abs(loss[b]),
                      **gap_summary(gaps[name])}
               for name, (a, b) in zip(gaps, pairs)}
    for name, row in summary.items():
        log(f"[step] {what} {name}: loss relative {row['loss_rel']:.3g}; " + "; ".join(
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
    shapes = (f"chunk forwards a pass {out['shapes']}" if packed else
              f"pep {out['shapes'][0]}, rec {out['shapes'][1]}")
    # 3. the packed step run twice from the same state: the same loss and gradients
    same = (not packed or (loss["again"] == lk
                           and all(torch.equal(grads["again"][k], gk[k]) for k in gk)))
    log(f"[step] {what} step at global batch 256 ({shapes}; dropout 0): loss "
        f"through K1/K5 {lk:.6f}, K1 and K5's plain version {loss['k1_plain_bwd']:.6f}, eager "
        f"{le:.6f}, eager f32 {lf:.6f}. K5 against its plain version in the step: loss "
        f"relative {loss_k5:.3g} (tolerance {FT_LOSS_TOL:g}), largest max|err|/leaf max over "
        f"the tolerance {FT_K5_TOL:g}: {tight[worst]:.4g} ({worst}); the planted fault (K5 "
        f"built to drop the last query tile of dk/dv): {fault[worst_fault]:.4g} ({worst_fault}) "
        f"{'ok' if ok1 else 'FAIL'}. Against eager: |loss - eager| {abs(lk - le):.3g} "
        f"(allowed {loss_allowed:.3g}), largest gradient ratio to 2|eager - f32| + "
        f"{FT_GRAD_FLOOR:g} max|f32|: {ratios[worst_eager]:.4g} ({worst_eager}) "
        f"{'ok' if ok2 else 'FAIL'}"
        + (f". Run twice: loss and gradients {'equal' if same else 'DIFFER'} to the bit"
           if packed else ""))
    if not ok1:
        raise AssertionError(f"K5 in the {what} step disagrees with its plain version")
    if fault[worst_fault] <= 1.0:
        raise AssertionError(f"the {what} step check does not see a K5 that drops a query tile")
    if not ok2:
        raise AssertionError(f"the {what} step through K1/K5 disagrees with the eager step")
    if not same:
        raise AssertionError(f"the {what} step is not deterministic")
    return {"loss_rel_err": loss_k5, "grad_ratio": tight[worst], "grad_leaf": worst,
            "fault_ratio": fault[worst_fault], "fault_leaf": worst_fault,
            "eager_loss_abs_err": abs(lk - le), "eager_loss_allowed": loss_allowed,
            "eager_grad_ratio": ratios[worst_eager], "eager_grad_leaf": worst_eager,
            "gaps": summary}


# ---------------------------------------------------------------------------
# Phase 9: times
# ---------------------------------------------------------------------------

def sm_clock_hz() -> float:
    """The card's largest SM clock (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def attention_work(seg: torch.Tensor) -> dict:
    """What one head of the function needs on these segments, summed over
    the rows: allowed (query, key) pairs, valid tokens (segment > 0), pad
    tokens, and tokens of the rows that hold a pad (a pad query's output is
    the mean of v over all T keys, with no exponential)."""
    T = seg.shape[1]
    allowed = (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] > 0)
    pads = (seg <= 0).sum(1)
    return {"pairs": int(allowed.sum()), "valid": int((seg > 0).sum()), "pads": int(pads.sum()),
            "padded_rows_tokens": T * int((pads > 0).sum())}


def attention_bound(seg: torch.Tensor, backward: bool, clock_hz: float) -> dict:
    """K1's (or K5's) bound on this run's segments, one head's work times
    NH. Operations: bf16 tensor-core FLOPs over the allowed pairs (K1: S and
    P.V; K5: S, dP, dq, dk, dv), and f32 adds for the pad queries' closed
    form (K1: the column sum of v, T*32 per (row, head) with a pad; K5: the
    sum of the pads' dO and its add to every key's dv, (pads + T)*32).
    Bytes moved once: K1 reads q and k of valid tokens and v of every
    token (a row without pads has no other; a pad query's mean reads all of
    its row) and writes o; K5 reads q, k and v
    of valid tokens and dO of every token and writes dq, dk and dv; both
    read the segments. No statistics: the TPU-form function has none.
    Beside them the exponential floor: one exp per allowed pair at 16 ex2
    per clock on each of the 132 SMs, at clocks.max.sm."""
    B, T = seg.shape
    w = attention_work(seg)
    row = NH * DH * 2                              # bytes of one token's heads
    if backward:
        flops = NH * 5 * 2 * DH * w["pairs"]
        adds = NH * DH * (w["pads"] + w["padded_rows_tokens"])
        nbytes = row * (3 * w["valid"] + 4 * B * T) + B * T * 4
    else:
        flops = NH * 2 * 2 * DH * w["pairs"]
        adds = NH * DH * w["padded_rows_tokens"]
        nbytes = row * (2 * w["valid"] + 2 * B * T) + B * T * 4
    t_ops = flops / H100_BF16_FLOPS + adds / H100_F32_FLOPS
    t_bytes = nbytes / H100_BYTES_PER_S
    exp_ms = 1e3 * NH * w["pairs"] / (132 * 16 * clock_hz)
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "exp_floor_ms": exp_ms, "allowed_share": w["pairs"] / (B * T * T),
            "counts": f"{flops / 1e9:.4f} GFLOP bf16 and {adds / 1e6:.4f} M f32 adds, "
                      f"{nbytes / 1e6:.4f} MB, {NH * w['pairs'] / 1e6:.4f} M exponentials at "
                      f"{clock_hz / 1e9:.3f} GHz"}


def dense_segments(B: int, T: int) -> torch.Tensor:
    return torch.ones(B, T, dtype=torch.int32, device="cuda")


def time_attention(gen: torch.Generator, gpu: str) -> dict:
    """K1 (as serving calls it, without statistics), K1 with its statistics,
    its plain version and torch's scaled_dot_product_attention with the same
    boolean mask, at B=16, T=512, NH=20: padded rows, then every token in
    one segment (the dense row, where no tile is skipped)."""
    B, T = 16, 512
    clock = sm_clock_hz()
    rows = {}
    for kind, seg in (("padded", padded_segments(B, T)), ("dense", dense_segments(B, T))):
        # four input sets (4 x 42 MB) so that successive calls miss the 50 MB L2
        sets = [qkv(B, T, gen) for _ in range(4)]
        allowed = ((seg[:, None, :, None] == seg[:, None, None, :])
                   & (seg[:, None, None, :] > 0))
        cycle = itertools.cycle(sets)

        def library():
            q, k, v = (x.transpose(1, 2) for x in next(cycle))
            torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=allowed,
                                                             scale=1.0)

        row = {"shape": [B, T, NH, DH], "segments": kind,
               "ms": cuda_ms(lambda: attention.fused_attention(*next(cycle), seg), 100),
               "with_lse_ms": cuda_ms(lambda: attention._forward(*next(cycle), seg, True), 100),
               "plain_ms": cuda_ms(lambda: attention.attention_reference(*next(cycle), seg), 10),
               "library_ms": cuda_ms(library, 50), **attention_bound(seg, False, clock)}
        counts = row.pop("counts")
        log(f"[time] attention_fwd B={B} T={T} NH={NH} {kind}: kernel {row['ms']:.6f} ms "
            f"({row['with_lse_ms']:.6f} ms writing its statistics), plain {row['plain_ms']:.6f} "
            f"ms, library (scaled_dot_product_attention) {row['library_ms']:.6f} ms, bound "
            f"{row['bound_ms']:.6f} ms ({row['bound_by']}: {counts}; allowed pairs "
            f"{row['allowed_share']:.4f} of T^2), exponential floor {row['exp_floor_ms']:.6f} ms "
            f"| {gpu}")
        rows[kind] = row
    return {**rows["padded"], "dense": rows["dense"]}


def time_attention_bwd(gen: torch.Generator, gpu: str, packed: list = ()) -> list[dict]:
    """K5 (fed K1's statistics), its plain version, and the backward alone
    of torch's scaled_dot_product_attention with the same boolean mask (a
    yardstick: torch.autograd.grad on a saved graph), at K5_TIME_SHAPES
    padded, at (16, 512) dense and on the packed chunks ``packed`` ((kind,
    segments) pairs), in device time summed by torch.profiler: at the chunk
    shapes the wrapper's host work (checks, allocations, ctypes) outlasts
    the kernels."""
    rows = []
    clock = sm_clock_hz()
    shapes = ([(padded_segments(B, T), "padded") for B, T in K5_TIME_SHAPES]
              + [(dense_segments(16, 512), "dense")] + [(seg, kind) for kind, seg in packed])
    for seg, kind in shapes:
        B, T = seg.shape
        allowed = ((seg[:, None, :, None] == seg[:, None, None, :])
                   & (seg[:, None, None, :] > 0))
        # input sets enough that successive calls miss the 50 MB L2 (one set
        # at (28, 2048) is 294 MB)
        sets = []
        for _ in range(4 if B * T <= 16 * 512 else 1):
            q, k, v = qkv(B, T, gen)
            do = torch.randn(B, T, NH, DH, device="cuda", generator=gen).bfloat16()
            lse = attention._forward(q, k, v, seg, with_lse=True)[1]
            lq, lk, lv = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
            out = torch.nn.functional.scaled_dot_product_attention(lq, lk, lv, attn_mask=allowed,
                                                                   scale=1.0)
            sets.append((q, k, v, do, lse, (out, (lq, lk, lv), do.transpose(1, 2))))
        cycle = itertools.cycle(sets)

        def kernel():
            q, k, v, do, lse, _ = next(cycle)
            attention.fused_attention_bwd(q, k, v, seg, do, lse)

        def plain():
            q, k, v, do, _, _ = next(cycle)
            by_rows(attention.attention_reference_bwd, q, k, v, seg, do)

        def library():
            out, inputs, do = next(cycle)[5]
            torch.autograd.grad(out, inputs, do, retain_graph=True)

        row = {"shape": [B, T, NH, DH], "segments": kind, "ms": device_ms(kernel, 100),
               "wall_ms": cuda_ms(kernel, 100), "plain_ms": device_ms(plain, 10),
               "library_ms": device_ms(library, 100), **attention_bound(seg, True, clock)}
        counts = row.pop("counts")
        log(f"[time] attention_bwd B={B} T={T} NH={NH} {kind}, device time: kernel "
            f"{row['ms']:.6f} ms ({row['wall_ms']:.6f} ms per call with the host), plain "
            f"{row['plain_ms']:.6f} ms, library (scaled_dot_product_attention backward) "
            f"{row['library_ms']:.6f} ms, bound {row['bound_ms']:.6f} ms ({row['bound_by']}: "
            f"{counts}; allowed pairs {row['allowed_share']:.4f} of T^2) = "
            f"{100 * row['bound_ms'] / row['ms']:.2f}% of the bound, exponential floor "
            f"{row['exp_floor_ms']:.6f} ms | {gpu}")
        rows.append(row)
    return rows


def maxsim_work(ma: torch.Tensor, mb: torch.Tensor, D: int) -> dict:
    """What K4 needs on these masks: the token pairs both masks allow
    (ma * mb > 0), the operations of their products kept at f32 accuracy on
    the tensor cores (three TF32 products of 2 D operations each), and the
    bytes of the valid tokens of ha and hb (mask nonzero), both masks and
    both outputs, each moved once."""
    pa, na = float((ma > 0).sum()), float((ma < 0).sum())
    pb, nb = float((mb > 0).sum()), float((mb < 0).sum())
    pairs = pa * pb + na * nb
    tokens = int((ma != 0).sum()) + int((mb != 0).sum())
    return {"pairs": pairs, "flops": 3 * 2 * D * pairs,
            "bytes": 4 * D * tokens + 4 * (ma.numel() + mb.numel())
            + 8 * ma.shape[0] * mb.shape[0]}


def maxsim_bound(ma: torch.Tensor, mb: torch.Tensor, D: int) -> tuple[float, str, str]:
    """(bound ms, what bounds it, the counts) of maxsim_work at the dense
    TF32 peak and the memory rate."""
    work = maxsim_work(ma, mb, D)
    t_ops, t_bytes = work["flops"] / H100_TF32_FLOPS, work["bytes"] / H100_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else "operations",
            f"{work['flops'] / 1e9:.4f} GFLOP over {work['pairs']:.6g} allowed pairs "
            f"({work['pairs'] / (ma.numel() * mb.numel()):.4f} of all), "
            f"{work['bytes'] / 1e6:.4f} MB")


def time_maxsim(gen: torch.Generator, gpu: str) -> list[dict]:
    """K4 and its plain version at K4_TIME_SHAPES, beside the bound on
    the same masks and the ceiling of an f32 FFMA design (every token pair
    at the CUDA cores' peak): the wrapper's call by CUDA events, and the
    kernel's own device time by torch.profiler. No single PyTorch call
    computes masked max-sim, so there is no library time."""
    rows = []
    for (Ba, Bb, TA, TB), iters in zip(K4_TIME_SHAPES, (50, 50, 5)):
        ha, hb, ma, mb = maxsim_inputs(Ba, Bb, TA, TB, gen)
        ms = cuda_ms(lambda: maxsim.filip_similarity_fused(ha, hb, ma, mb, 1.0), iters)
        kernel_ms = device_ms(lambda: maxsim.filip_similarity_fused(ha, hb, ma, mb, 1.0), iters,
                              kernel="filip_maxsim_kernel")
        plain_ms = cuda_ms(lambda: maxsim.maxsim_reference(ha, hb, ma, mb), 3, warmup=1)
        bound_ms, bound_by, counts = maxsim_bound(ma, mb, FILIP_D)
        ffma_ms = 1e3 * 2 * Ba * Bb * TA * TB * FILIP_D / H100_F32_FLOPS
        log(f"[time] filip_maxsim (Ba, Bb, TA, TB)=({Ba}, {Bb}, {TA}, {TB}) D={FILIP_D}: "
            f"call {ms:.6f} ms (kernel's device time {kernel_ms:.6f}), plain {plain_ms:.6f} ms, "
            f"library none, bound {bound_ms:.6f} ms ({bound_by}: {counts}; TF32 peak "
            f"{H100_TF32_FLOPS / 1e12:g} TFLOP/s) = {100 * bound_ms / ms:.2f}% of the bound "
            f"({100 * bound_ms / kernel_ms:.2f}% by device time); an f32 FFMA design's "
            f"ceiling {ffma_ms:.6f} ms | {gpu}")
        rows.append({"shape": [Ba, Bb, TA, TB, FILIP_D], "ms": ms, "device_ms": kernel_ms,
                     "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
                     "bound_by": bound_by, "ffma_ceiling_ms": ffma_ms})
    return rows


def time_serving(ctx: dict, rng: np.random.Generator, gpu: str, what: str = "bf16") -> dict:
    """/embed p50 for one sequence, the same encode without HTTP, and seqs/s
    at batch 32, against ctx's server and backbone."""
    base = ctx["base"]
    one = synthetic_seqs(rng, [100])
    for _ in range(3):
        embed_json(base, one, "rec")
    lat = []
    for _ in range(30):
        t0 = time.perf_counter()
        embed_json(base, one, "rec")
        lat.append(1e3 * (time.perf_counter() - t0))
    out = {"embed_p50_ms": statistics.median(lat)}
    log(f"[time] {what} /embed 1 sequence (100 aa, bucket 128): p50 {out['embed_p50_ms']:.4f} "
        f"ms over 30 requests | {gpu}")
    # the same encode without HTTP and the coalescer: what those layers add
    tok = common.make_tokenizer()
    direct = []
    for _ in range(30):
        t0 = time.perf_counter()
        embed.embed_sequences(ctx["heads"], ctx["esm_params"], one, "rec", ctx["mcfg"], tok,
                              torch.device("cuda"), batch_size=32, pad_batch=True)
        direct.append(1e3 * (time.perf_counter() - t0))
    out["encode_p50_ms"] = statistics.median(direct)
    log(f"[time] {what} embed_sequences 1 sequence without HTTP: p50 "
        f"{out['encode_p50_ms']:.4f} ms over 30 calls | {gpu}")
    batch = ctx["batch32"]
    embed_json(base, batch, "rec")
    dts = []
    for _ in range(10):
        t0 = time.perf_counter()
        embed_json(base, batch, "rec")
        dts.append(time.perf_counter() - t0)
    out["batch32_seqs_per_s"] = 32 / statistics.median(dts)
    log(f"[time] {what} /embed batch 32 (50-299 aa): {out['batch32_seqs_per_s']:.4f} seqs/s "
        f"(median of 10 requests) | {gpu}")
    return out


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


def device_ms(fn, iters: int, warmup: int = 3, kernel: str = "") -> float:
    """Device time of fn() per call: the CUDA kernels' self time summed by
    torch.profiler over iters calls (only those whose name holds `kernel`).
    Host work between launches (autograd, allocation, ctypes) is left out;
    cuda_ms includes it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # Now and then a profiler session records no device events at all (seen
    # once in a run on an H100, at a step that had timed fine before): such
    # a session is taken again, at most twice.
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.self_device_time_total for e in prof.key_averages() if kernel in e.key)
        if total_us > 0:
            return total_us / 1e3 / iters
    raise AssertionError("torch.profiler recorded no device time in 3 sessions")


def infonce_bound(B: int, D: int) -> tuple[float, str, str]:
    """(bound ms, what bounds it, the counts) of forward plus backward: the
    logits, dX and dY, each product kept at f32 accuracy as three TF32
    products on the tensor cores (18 B^2 D operations at the TF32 peak),
    against x, y read and dX, dY, the loss written once."""
    ops = 18 * B * B * D
    nbytes = 16 * B * D + 4
    t_ops, t_bytes = ops / H100_TF32_FLOPS, nbytes / H100_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else "operations",
            f"{ops / 1e9:.4f} GFLOP TF32, {nbytes / 1e6:.4f} MB")


def infonce_ceiling(B: int, D: int) -> float:
    """The ceiling of the FFMA design K2 and K3 had before (ms): 6 B^2 D f32
    FLOP on the CUDA cores."""
    return 1e3 * 6 * B * B * D / H100_F32_FLOPS


# Numbers the timing rows work out rather than measure: they go to the log
# and PERF.md, never to the kernels line, whose only computed number is
# bound_ms.
COMPUTED_KEYS = ("cuda_core_ceiling_ms", "ffma_ceiling_ms", "launch_floor_ms", "exp_floor_ms")


def measured_only(obj):
    """obj (the kernels line's dicts and lists) without COMPUTED_KEYS."""
    if isinstance(obj, dict):
        return {k: measured_only(v) for k, v in obj.items() if k not in COMPUTED_KEYS}
    if isinstance(obj, list):
        return [measured_only(v) for v in obj]
    return obj


def device_kernels(fn, first: str, iters: int = 20) -> tuple[float, float]:
    """Device kernels per fn() call by torch.profiler: those whose name holds
    "pct_infonce" (the kernels of csrc/infonce.cu) and all device events
    (autograd's fill of the cotangent among them), each over the count of
    the call's first kernel, whose name holds `first` (a session may drop
    whole calls)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    calls = sum(e.count for e in events if first in e.key)
    if calls == 0:
        raise AssertionError(f"torch.profiler recorded no {first} kernel")
    return (sum(e.count for e in events if "pct_infonce" in e.key) / calls,
            sum(e.count for e in events) / calls)


def time_infonce(gen: torch.Generator, gpu: str) -> dict:
    """K2 at (256, 128), K3 at (1024, 128) and (4096, 128), forward plus
    backward through autograd, and the plain clip_infonce the same way;
    beside them the bound, the old design's CUDA-core ceiling, the device
    kernels a call runs (autograd's fill of the cotangent among them) and
    the launch floor: those kernels times an empty kernel's device time
    (torch.cuda._sleep(0)) under the same profiler. No single PyTorch call
    computes symmetric InfoNCE, so there is no library time."""
    empty_ms = device_ms(lambda: torch.cuda._sleep(0), 200)
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
        row["cuda_core_ceiling_ms"] = infonce_ceiling(B, 128)
        row["kernels_per_call"], row["device_kernels_per_call"] = device_kernels(
            kernel, "infonce_cluster" if name == "infonce" else "infonce_tiles")
        row["empty_kernel_ms"] = empty_ms
        row["launch_floor_ms"] = row["kernels_per_call"] * empty_ms
        log(f"[time] {name} B={B} D=128 forward+backward: kernel {row['ms']:.6f} ms of device "
            f"time ({row['wall_ms']:.6f} ms per call with the host), forward alone "
            f"{row['fwd_ms']:.6f} ms; plain {row['plain_ms']:.6f} ms ({row['plain_wall_ms']:.6f} "
            f"ms with the host); library none; bound {row['bound_ms']:.6f} ms ({row['bound_by']}: "
            f"{counts}; TF32 peak {H100_TF32_FLOPS / 1e12:g} TFLOP/s) = "
            f"{100 * row['bound_ms'] / row['ms']:.2f}% of the bound; the CUDA-core ceiling "
            f"{row['cuda_core_ceiling_ms']:.6f} ms; {row['kernels_per_call']:.4g} kernels of "
            f"csrc/infonce.cu a call ({row['device_kernels_per_call']:.4g} device kernels with "
            f"autograd's), launch floor {row['launch_floor_ms']:.6f} ms (empty kernel "
            f"{empty_ms:.6f} ms) | {gpu}")
        rows.setdefault(name, []).append(row)
    return rows


def time_dispatch(gen: torch.Generator, gpu: str) -> list[dict]:
    """K2 (pools up to its K2_MAX_POOL) and K3 forward+backward on the same
    inputs at each pool of DISPATCH_POOLS: the readings that
    clip_engine.fused_infonce_fits' split rests on (the faster by device
    time, and what the rule picks)."""
    rows = []
    for B in DISPATCH_POOLS:
        x, y = (t.requires_grad_(True) for t in unit_rows(B, 128, 1.0, gen))
        row = {"pool": B, "picked": loss_kernel(B), "infonce": None}
        for name, fn in (("infonce", infonce.fused_infonce),
                         ("infonce_tiled", infonce.fused_infonce_tiled)):
            if name == "infonce" and B > infonce.K2_MAX_POOL:
                continue

            def run():
                torch.autograd.grad(fn(x, y), (x, y))
            row[name] = {"ms": device_ms(run, 100), "wall_ms": cuda_ms(run, 100)}
        row["faster"] = min((k for k in ("infonce", "infonce_tiled") if row[k]),
                            key=lambda k: row[k]["ms"])
        k2 = (f"infonce {row['infonce']['ms']:.6f} ms of device time "
              f"({row['infonce']['wall_ms']:.6f} ms with the host)" if row["infonce"]
              else f"infonce takes pools up to {infonce.K2_MAX_POOL}")
        log(f"[time] dispatch B={B} D=128 forward+backward: {k2}, infonce_tiled "
            f"{row['infonce_tiled']['ms']:.6f} ms ({row['infonce_tiled']['wall_ms']:.6f} ms); "
            f"faster by device time {row['faster']}, the rule picks {row['picked']} | {gpu}")
        rows.append(row)
    return rows


def time_train_steps(tctx: dict, run: str, what: str, gpu: str, pairs: int = 256) -> float:
    """pairs/s of a step of ``pairs`` (global batch 256 by default) over a
    run's steps after the first: the card's time between the events
    recorded after consecutive steps, with no sync inside the epoch."""
    torch.cuda.synchronize()
    ends = tctx[run]["ends"]
    dts = [a.elapsed_time(b) / 1e3 for a, b in zip(ends, ends[1:])]
    rate = pairs / statistics.median(dts)
    log(f"[time] {what} at global batch {pairs} (t30_150M): {rate:.4f} pairs/s, "
        f"median of {len(dts)} steps after the first ({1e3 * min(dts):.2f}-"
        f"{1e3 * max(dts):.2f} ms per step, by CUDA events); fixture {tctx['profile']} | {gpu}")
    return rate


# ---------------------------------------------------------------------------
# Phases 9-11: the int8 w8a8 backbone (P1) and the fused FFN gate (K6)
# ---------------------------------------------------------------------------

def row_cosines(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def serve_requests(base: str, ctx: dict, what: str) -> dict:
    """/healthz, the single-sequence /embed of phase 3's sequences, its
    32-sequence /embed and /topk over the index (order checked as in phase
    3): {(side, bucket) or "batch32": embeddings}."""
    health = json.loads(call(base, "/healthz")[1])
    if not (health["status"] == "ok" and health["index_size"] == 256):
        raise AssertionError(f"{what} /healthz {health}")
    got = {key: embed_json(base, [seq], key[0])[0] for key, (seq, _) in ctx["singles"].items()}
    got["batch32"] = embed_json(base, ctx["batch32"], "rec")
    queries = ctx["batch32"][:4]
    hits = post_json(base, "/topk", {"queries": queries, "side": "pep", "k": 10})["hits"]
    qemb = embed_json(base, queries, "pep")
    with np.load(WORK / "index.npz") as index:
        ids, corpus = index["ids"], index["embeddings"]
    want = np.argsort(-(qemb @ corpus.T), axis=1)[:, :10]
    for q, row in enumerate(hits):
        if [h["id"] for h in row] != [str(ids[i]) for i in want[q]]:
            raise AssertionError(f"{what} /topk order wrong for query {q}")
    log(f"[{what}] /healthz ok; /embed of {len(ctx['singles'])} single sequences and of 32; "
        f"/topk k=10 over 256: order ok")
    return got


def cosines_against(got: dict, ctx: dict) -> np.ndarray:
    """Per-row cosines of got's embeddings against phase 3's (bf16, gate off)."""
    cos = list(row_cosines(got["batch32"], ctx["emb32"]))
    cos += [float(row_cosines(got[key][None], emb[None])[0])
            for key, (_, emb) in ctx["singles"].items()]
    return np.asarray(cos)


def run_int8_serve_phase(ctx: dict) -> dict:
    """cli.serve --esm-dtype int8 over phase 3's weights and index: launch
    counts (P1 six times a layer, K1 once), the served embeddings against
    the same encode through P1's plain version on the card (equal to the
    bit), and their cosine against the bf16 path."""
    model_args = ctx["model_args"] + ["--esm-dtype", "int8"]
    with counted_forwards() as forwards:
        reset_counts()
        args = serve.build_argparser().parse_args(
            model_args + ["--index", str(WORK / "index.npz"), "--port", "0"])
        server = serve.make_server(args)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        out: dict = {"base": base, "server": server, "thread": thread}
        got = serve_requests(base, ctx, "int8 serve")
        launches = {"dense_mm": dense_mm.mm.launches,
                    "attention_fwd": attention.fused_attention.launches,
                    "ffn_gelu": ffn.dense_gelu.launches}
    cfg = common.esm_config("t30_150M", "int8")
    n = len(forwards)
    want = {"dense_mm": 6 * cfg.num_layers * n, "attention_fwd": cfg.num_layers * n,
            "ffn_gelu": 0}
    if not forwards or launches != want:
        raise AssertionError(f"int8 serve: launches {launches} over {n} forwards, want {want}")
    log(f"[int8 serve] {n} backbone forwards: dense_mm {launches['dense_mm']} = "
        f"{6 * cfg.num_layers} per forward (q, k, v, o, wi, wo x {cfg.num_layers} layers), "
        f"attention_fwd {launches['attention_fwd']} = {cfg.num_layers} per forward")
    mcfg = clip.CLIPConfig(input_dim=cfg.hidden_size, esm=cfg)
    qparams = esm2.quantize_params(ctx["esm_params"])
    tok = common.make_tokenizer()
    kernel_mm = dense_mm.mm
    dense_mm.mm = dense_mm.mm_reference
    try:
        plain = {key: embed.embed_sequences(ctx["heads"], qparams, [seq], key[0], mcfg, tok,
                                            torch.device("cuda"), batch_size=32,
                                            pad_batch=True)[0]
                 for key, (seq, _) in ctx["singles"].items()}
        plain["batch32"] = embed.embed_sequences(ctx["heads"], qparams, ctx["batch32"], "rec",
                                                 mcfg, tok, torch.device("cuda"), batch_size=32,
                                                 pad_batch=True)
    finally:
        dense_mm.mm = kernel_mm
    equal = all(np.array_equal(got[k], plain[k]) for k in got)
    cos = cosines_against(got, ctx)
    log(f"[int8 serve] served embeddings against the same encode through dense_mm's plain "
        f"version: {'equal to the bit' if equal else 'DIFFERENT'}; per-row cosine against "
        f"the bf16 path over {len(cos)} rows: min {cos.min():.6f}, median "
        f"{np.median(cos):.6f} (need min >= {INT8_COSINE_MIN})")
    if not equal:
        raise AssertionError("the int8 path through P1 differs from P1's plain version")
    if not cos.min() >= INT8_COSINE_MIN:
        raise AssertionError(f"int8 embeddings drift from bf16: cosine {cos.min()}")
    out.update(launches=launches, cos_min=float(cos.min()), cos_median=float(np.median(cos)),
               heads=ctx["heads"], esm_params=qparams, mcfg=mcfg, batch32=ctx["batch32"])
    return out


def run_int8_train() -> dict:
    """cli.main --esm-dtype int8 for one epoch on a fixture of
    INT8_FIXTURE_FAMILIES families: three frozen steps at global batch 256
    (16 chunks, 4 length groups) and the eval batches; finite losses; P1
    six times a layer per backbone forward, 32 forwards per step, 8 per
    eval batch; K2 once forward and once backward per step."""
    data_dir, runs = WORK / "int8_data", WORK / "runs_int8"
    t0 = time.perf_counter()
    with counted_forwards() as forwards, timed_steps() as ends:
        reset_counts()
        train_cli.main(["--synthetic-fixture", "--data-dir", str(data_dir), "--fixture-families",
                        str(INT8_FIXTURE_FAMILIES), "--epochs", "1", "--runs-dir", str(runs),
                        "--esm-dtype", "int8"])
        p1, k1 = dense_mm.mm.launches, attention.fused_attention.launches
        counts = infonce_counts()
    wall = time.perf_counter() - t0
    run = check_run_dir(runs)
    train_ds, val_ds, test_ds = dataset.generate_datasets(data_dir, seed=42)
    steps = len(train_ds) // 16 // 16
    evals = len(val_ds) // 16 + len(test_ds) // 16
    want_forwards = 32 * steps + 8 * evals
    want = {"infonce": (steps + evals, steps), "infonce_tiled": (0, 0)}
    if (steps != 3 or len(ends) != steps or len(forwards) != want_forwards
            or p1 != 180 * want_forwards or k1 != 30 * want_forwards or counts != want):
        raise AssertionError(f"int8 train: {len(ends)} steps (want {steps} = 3), "
                             f"{len(forwards)} forwards (want {want_forwards}), dense_mm {p1}, "
                             f"attention_fwd {k1}, InfoNCE {counts} (want {want})")
    metrics = json.loads((run / "metrics.jsonl").read_text().splitlines()[0])
    log(f"[int8 train] cli.main --esm-dtype int8: {steps} steps at global batch 256, {evals} "
        f"eval batches of 16; train loss {metrics['train_loss']:.6f}, val loss "
        f"{metrics['val_loss']:.6f} (finite); {len(forwards)} backbone forwards, dense_mm {p1} "
        f"= 180 per forward, attention_fwd {k1}; InfoNCE (forward, backward) calls {counts}; "
        f"cli.main {wall:.2f} s")
    return {"steps": steps, "ends": ends, "launches": {
        "dense_mm": p1, "attention_fwd": k1, **{k: v[0] for k, v in counts.items()}}}


@contextlib.contextmanager
def ffn_gate():
    os.environ["PCT_FFN_PALLAS"] = "1"
    try:
        yield
    finally:
        del os.environ["PCT_FFN_PALLAS"]


def run_k6_serve_phase(ctx: dict) -> dict:
    """Phase 3's server and requests with PCT_FFN_PALLAS=1 set for the
    phase: K6 once a layer per forward, and the embeddings at cosine >=
    COSINE_MIN per row against the gate off."""
    with ffn_gate(), counted_forwards() as forwards:
        reset_counts()
        got = serve_requests(ctx["base"], ctx, "K6 serve")
        launches = {"ffn_gelu": ffn.dense_gelu.launches,
                    "attention_fwd": attention.fused_attention.launches,
                    "dense_mm": dense_mm.mm.launches}
    layers = ctx["mcfg"].esm.num_layers
    n = len(forwards)
    want = {"ffn_gelu": layers * n, "attention_fwd": layers * n, "dense_mm": 0}
    if not forwards or launches != want:
        raise AssertionError(f"K6 serve: launches {launches} over {n} forwards, want {want}")
    cos = cosines_against(got, ctx)
    log(f"[K6 serve] {n} backbone forwards: ffn_gelu {launches['ffn_gelu']} = {layers} per "
        f"forward; per-row cosine against the gate off over {len(cos)} rows: min "
        f"{cos.min():.6f}, median {np.median(cos):.6f} (need >= {COSINE_MIN})")
    if not cos.min() >= COSINE_MIN:
        raise AssertionError(f"K6 embeddings drift from the gate off: cosine {cos.min()}")
    return {"launches": launches, "cos_min": float(cos.min())}


def dense_bound(N: int, K: int, M: int, s8: bool) -> tuple[float, str, str]:
    """(bound ms, what bounds it, the counts) of P1: 2NKM operations at the
    int8 or bf16 tensor-core peak, against x and W read and the 4-byte
    output written once."""
    ops = 2 * N * K * M
    e = 1 if s8 else 2
    nbytes = e * (N * K + K * M) + 4 * N * M
    t_ops = ops / (H100_INT8_OPS if s8 else H100_BF16_FLOPS)
    t_bytes = nbytes / H100_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else "operations",
            f"{ops / 1e9:.4f} G{'OP' if s8 else 'FLOP'}, {nbytes / 1e6:.4f} MB")


def time_dense_mm(gen: torch.Generator, gpu: str) -> list[dict]:
    """P1 s8 at the probe's shape and at the batch-32 wi shape against
    torch._int_mm (cuBLASLt s8, given W k-major, the layout cuBLASLt takes
    fast, made once outside the timing: the weights are static), P1 bf16
    against torch.matmul (bf16 out), their plain versions, four input sets
    each so that calls miss the L2."""
    rows = []
    for kind, (N, K, M) in (("s8", (8192, 2560, 2560)), ("s8", (10240, 640, 2560)),
                            ("bf16", (8192, 2560, 2560))):
        s8 = kind == "s8"
        sets = [(s8_pair if s8 else bf16_pair)(N, K, M, gen) for _ in range(4)]
        cycle = itertools.cycle(sets)
        out_dtype = torch.int32 if s8 else torch.float32
        library = torch._int_mm if s8 else torch.matmul
        library_cycle = itertools.cycle([(x, w.t().contiguous().t()) for x, w in sets]
                                        if s8 else sets)
        row = {"kind": kind, "shape": [N, K, M],
               "ms": cuda_ms(lambda: dense_mm.mm(*next(cycle), out_dtype), 50),
               "plain_ms": cuda_ms(lambda: dense_mm.mm_reference(*next(cycle), out_dtype), 5),
               "library_ms": cuda_ms(lambda: library(*next(library_cycle)), 50)}
        row["bound_ms"], row["bound_by"], counts = dense_bound(N, K, M, s8)
        log(f"[time] dense_mm {kind} {(N, K, M)}: kernel {row['ms']:.6f} ms, plain "
            f"{row['plain_ms']:.6f} ms, library ({'torch._int_mm, W k-major' if s8 else 'torch.matmul, bf16 out'}) "
            f"{row['library_ms']:.6f} ms, bound {row['bound_ms']:.6f} ms ({row['bound_by']}: "
            f"{counts}) = {100 * row['bound_ms'] / row['ms']:.2f}% of the bound | {gpu}")
        rows.append(row)
    return rows


def time_ffn(gen: torch.Generator, gpu: str) -> dict:
    """K6 at the batch-32 wi shape, its plain version, and torch.addmm
    followed by gelu (two calls: no single PyTorch call computes it)."""
    N, H, M = 10240, 640, 2560
    sets = [ffn_inputs(N, H, M, gen) for _ in range(4)]
    cycle = itertools.cycle(sets)

    def two_calls():
        x, w, b = next(cycle)
        torch.nn.functional.gelu(torch.addmm(b, x, w))

    row = {"shape": [N, H, M],
           "ms": cuda_ms(lambda: ffn.dense_gelu(*next(cycle), "erf"), 50),
           "plain_ms": cuda_ms(lambda: ffn.dense_gelu_reference(*next(cycle), "erf"), 5),
           "library_ms": None, "addmm_gelu_ms": cuda_ms(two_calls, 50)}
    row["bound_ms"], row["bound_by"], counts = ffn_bound(N, H, M)
    log(f"[time] ffn_gelu {(N, H, M)} erf: kernel {row['ms']:.6f} ms, plain "
        f"{row['plain_ms']:.6f} ms, library none (torch.addmm + gelu, two calls: "
        f"{row['addmm_gelu_ms']:.6f} ms), bound {row['bound_ms']:.6f} ms ({row['bound_by']}: "
        f"{counts}) = {100 * row['bound_ms'] / row['ms']:.2f}% of the bound | {gpu}")
    return row


def ffn_bound(N: int, H: int, M: int) -> tuple[float, str, str]:
    """(bound ms, what bounds it, the counts) of K6: 2NHM bf16 FLOP against
    x, W, b read and the bf16 output written once."""
    flops = 2 * N * H * M
    nbytes = 2 * (N * H + H * M + M + N * M)
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else "operations",
            f"{flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.4f} MB")


def time_short_products(gen: torch.Generator, gpu: str) -> dict:
    """P1 s8 and K6 at 128 tokens (a one-sequence request) through t30_150M's
    three layer shapes, beside torch._int_mm (W k-major) and torch.addmm +
    gelu, by device time (torch.profiler): at this size a call's host side
    outlasts its kernel, so CUDA events around back-to-back calls would read
    the host."""
    rows = {"s8": [], "ffn": []}
    N = 128
    for K, M in T30_LAYERS:
        sets = [s8_pair(N, K, M, gen) for _ in range(4)]
        cycle = itertools.cycle(sets)
        lib = itertools.cycle([(x, w.t().contiguous().t()) for x, w in sets])
        row = {"shape": [N, K, M],
               "ms": device_ms(lambda: dense_mm.mm(*next(cycle), torch.int32), 50),
               "library_ms": device_ms(lambda: torch._int_mm(*next(lib)), 50)}
        row["bound_ms"], row["bound_by"], counts = dense_bound(N, K, M, True)
        rows["s8"].append(row)
        log(f"[time] dense_mm s8 {(N, K, M)} (device time): kernel {row['ms']:.6f} ms, library "
            f"(torch._int_mm, W k-major) {row['library_ms']:.6f} ms, bound "
            f"{row['bound_ms']:.6f} ms ({row['bound_by']}: {counts}) | {gpu}")
        fsets = [ffn_inputs(N, K, M, gen) for _ in range(4)]
        fcycle = itertools.cycle(fsets)

        def two_calls():
            x, w, b = next(fcycle)
            torch.nn.functional.gelu(torch.addmm(b, x, w))

        row = {"shape": [N, K, M],
               "ms": device_ms(lambda: ffn.dense_gelu(*next(fcycle), "erf"), 50),
               "library_ms": None, "addmm_gelu_ms": device_ms(two_calls, 50)}
        row["bound_ms"], row["bound_by"], counts = ffn_bound(N, K, M)
        rows["ffn"].append(row)
        log(f"[time] ffn_gelu {(N, K, M)} erf (device time): kernel {row['ms']:.6f} ms, "
            f"library none (torch.addmm + gelu: {row['addmm_gelu_ms']:.6f} ms), bound "
            f"{row['bound_ms']:.6f} ms ({row['bound_by']}: {counts}) | {gpu}")
    return rows


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
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS) + 1) as pool:
        faults = pool.submit(build_faults)
        reports = list(pool.map(build.build, KERNELS))
        fault_libs = faults.result()
    for name, report in zip(KERNELS, reports):
        log(f"[build] {name}: {build.library_path(name)}\n{report.strip()}")
    log(f"[build] done in {time.perf_counter() - t0:.1f} s (and the planted-fault copies "
        f"{', '.join(f'{k}: {sorted(v)}' for k, v in fault_libs.items())} under {FAULT_DIR})")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    segments = path_segments()
    k1_cases = attention_cases(gen, segments)
    max_err = check_attention(k1_cases)
    k4_cases = maxsim_cases(gen)
    k4_err = check_maxsim(k4_cases)
    nce_cases = infonce_cases(gen)
    nce_err = check_infonce(nce_cases)
    k5_cases = bwd_cases(gen, segments)
    k5_err = check_attention_bwd(k5_cases)
    p1_err = check_dense_mm(gen)
    k6_err = check_ffn(gen)
    fault_reads = check_faults(fault_libs["main_loop"], gen)
    fault_reads.update(check_attention_faults(fault_libs, k1_cases, k5_cases))
    fault_reads.update(check_maxsim_faults(fault_libs, k4_cases))
    fault_reads.update(check_infonce_faults(fault_libs, nce_cases))
    del k1_cases, k5_cases, k4_cases, nce_cases
    rng = np.random.default_rng(SEED)
    ctx = run_serve_phase(rng)
    try:
        check_end_to_end(ctx)
        fctx = run_filip_phase(ctx, rng)
        try:
            check_filip_end_to_end(ctx, fctx)
            tctx = run_train_phase()
            pctx = run_packed_phase()
            uctx = run_packed_unfrozen_phase()
            ftctx = run_filip_train_phase(fault_libs, gen)
            steps = {"k2": check_step(256), "k3": check_step(1024),
                     "packed": check_step(256, packed=True),
                     "finetune": check_finetune_step(fault_libs),
                     "finetune_packed": check_finetune_step(fault_libs, packed=True),
                     "filip": check_filip_step(ftctx["runs"], WORK / "filip_data", fault_libs)}
            ictx = run_int8_serve_phase(ctx)
            try:
                i8train = run_int8_train()
                k6ctx = run_k6_serve_phase(ctx)
                times = time_attention(gen, gpu)
                k5_times = time_attention_bwd(gen, gpu, [
                    (kind, seg) for kind, path, seg in segments
                    if path and seg.shape in ((16, 256), (28, 2048))])
                k4_times = time_maxsim(gen, gpu)
                nce_times = time_infonce(gen, gpu)
                dispatch = time_dispatch(gen, gpu)
                p1_times = time_dense_mm(gen, gpu)
                k6_times = time_ffn(gen, gpu)
                short_times = time_short_products(gen, gpu)
                serving = {"bf16": time_serving(ctx, rng, gpu),
                           "int8": time_serving(ictx, rng, gpu, "int8")}
                with ffn_gate():
                    serving["k6"] = time_serving(ctx, rng, gpu, "PCT_FFN_PALLAS=1")
                time_filip_serving(ctx, fctx, rng, gpu)
                filip_times = time_filip_train(ftctx, WORK / "filip_data", gpu)
                tctx["packed"] = pctx
                tctx["finetune_packed"], tctx["lora_packed"] = uctx["finetune"], uctx["lora"]
                pairs_per_s = {run: time_train_steps(tctx, run, what, gpu) for run, what in (
                    ("k2", "frozen train step (4 length groups)"),
                    ("packed", "packed frozen train step (flat packing)"),
                    ("finetune", "finetune step (one pad bucket, remat)"),
                    ("lora", f"LoRA step (rank {LORA_RANK}, one pad bucket, remat)"),
                    ("finetune_packed", "packed finetune step (flat packing, remat)"),
                    ("lora_packed", f"packed LoRA step (rank {LORA_RANK}, flat packing, "
                                    "remat)"))}
                pairs_per_s["int8"] = time_train_steps(
                    {"int8": i8train, "profile": f"{INT8_FIXTURE_FAMILIES} families"}, "int8",
                    "int8 w8a8 frozen train step (4 length groups)", gpu)
            finally:
                stop(ictx)
        finally:
            stop(fctx)
    finally:
        stop(ctx)
        shutil.rmtree(WORK, ignore_errors=True)
        shutil.rmtree(FAULT_DIR, ignore_errors=True)

    paths = {"serve": ctx["launches"], "filip_serve": fctx["launches"],
             "train_256": tctx["k2"]["launches"], "train_1024": tctx["k3"]["launches"],
             "train_packed": pctx["launches"],
             "train_finetune": tctx["finetune"]["launches"],
             "train_lora": tctx["lora"]["launches"],
             "train_finetune_packed": uctx["finetune"]["launches"],
             "train_lora_packed": uctx["lora"]["launches"],
             **{f"train_{name}": run["launches"] for name, run in ftctx["runs"].items()},
             "int8_serve": ictx["launches"],
             "int8_train": i8train["launches"], "k6_serve": k6ctx["launches"]}
    by_path = {name: {path: counts.get(name, 0) for path, counts in paths.items()}
               for name in ("attention_fwd", "attention_bwd", "filip_maxsim", "infonce",
                            "infonce_tiled", "dense_mm", "ffn_gelu")}
    kernels = [{
        "name": "attention_fwd", "phase": "serve", "route": "cuda",
        "source": "protein_clip_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "protein_clip_tpu/ops/attention_pallas.py:105",
        "launches": ctx["launches"]["attention_fwd"],
        "launches_by_path": by_path["attention_fwd"], "max_abs_err": max_err, **times,
        "fault": {k: fault_reads[k] for k in ("attention_fwd_swept_tiles", "attention_fwd_skip")},
        "train_packed": {"launches": pctx["launches"]["attention_fwd"],
                         "chunk_forwards_per_step": pctx["chunks_per_step"],
                         "cos_min_vs_grouped": pctx["paths"]["cos_min"]},
        "train_finetune_packed": {"launches": uctx["finetune"]["launches"]["attention_fwd"],
                                  "chunk_forwards_per_pass": uctx["finetune"]["chunks_per_pass"]},
    }, {
        "name": "attention_bwd", "phase": "train_finetune", "route": "cuda",
        "source": "protein_clip_tpu_torch/csrc/attention_bwd.cu",
        "replaces": "protein_clip_tpu/ops/attention_pallas.py:287",
        "launches": tctx["finetune"]["launches"]["attention_bwd"],
        "launches_by_path": by_path["attention_bwd"], "max_abs_err": k5_err, **k5_times[0],
        "at_chunks": k5_times[1:3], "dense": k5_times[3], "packed_chunks": k5_times[4:],
        "step_check": steps["finetune"],
        "fault": {k: fault_reads[k] for k in ("attention_bwd_swept_tiles", "attention_bwd_skip")},
        "finetune_pairs_per_s": pairs_per_s["finetune"], "lora_pairs_per_s": pairs_per_s["lora"],
        "train_finetune_packed": {"launches": uctx["finetune"]["launches"]["attention_bwd"],
                                  "chunk_forwards_per_pass": uctx["finetune"]["chunks_per_pass"],
                                  "step_check": steps["finetune_packed"],
                                  "pairs_per_s": pairs_per_s["finetune_packed"],
                                  "lora_pairs_per_s": pairs_per_s["lora_packed"],
                                  "launches_per_step": uctx["per_step"]},
    }, {
        "name": "filip_maxsim", "phase": "filip_serve", "route": "cuda",
        "source": "protein_clip_tpu_torch/csrc/filip_maxsim.cu",
        "replaces": "protein_clip_tpu/ops/filip_pallas.py:33",
        "launches": fctx["launches"]["filip_maxsim"],
        "launches_by_path": by_path["filip_maxsim"], "max_abs_err": k4_err,
        **{key: k4_times[0][key] for key in ("shape", "ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")},
        "topk": k4_times[1], "scorer_block": k4_times[2],
        "fault": {k: fault_reads[k] for k in ("maxsim_skip", "maxsim_tf32")},
        "train_filip": {"path_check": ftctx["k4"], "backward_max_rel_err": ftctx["backward_err"],
                        "retrieve_err": ftctx["retrieve_err"], "step_check": steps["filip"],
                        **{name: {"launches": run["launches"]["filip_maxsim"],
                                  "steps": run["steps"], "eval_batches": run["evals"],
                                  **filip_times[name]}
                           for name, run in ftctx["runs"].items()}},
    }, {
        "name": "infonce", "phase": "train_256", "route": "cuda",
        "source": "protein_clip_tpu_torch/csrc/infonce.cu",
        "replaces": "protein_clip_tpu/ops/infonce_pallas.py:30",
        "launches": tctx["k2"]["launches"]["infonce"],
        "bwd_launches": tctx["k2"]["bwd"]["infonce"],
        "launches_by_path": by_path["infonce"], "max_abs_err": nce_err["infonce"],
        **nce_times["infonce"][0], "step_check": steps["k2"],
        "fault": {k: fault_reads[k] for k in ("infonce_tf32", "infonce_partial")},
        "train_pairs_per_s": pairs_per_s["k2"], "dispatch": dispatch,
        "train_packed": {"launches": pctx["launches"]["infonce"],
                         "bwd_launches": pctx["bwd"]["infonce"], "step_check": steps["packed"],
                         "pairs_per_s": pairs_per_s["packed"],
                         "deterministic": pctx["paths"]["deterministic"],
                         "launches_per_step": pctx["per_step"]},
    }, {
        "name": "infonce_tiled", "phase": "train_1024", "route": "cuda",
        "source": "protein_clip_tpu_torch/csrc/infonce.cu",
        "replaces": "protein_clip_tpu/ops/infonce_pallas.py:128",
        "launches": tctx["k3"]["launches"]["infonce_tiled"],
        "bwd_launches": tctx["k3"]["bwd"]["infonce_tiled"],
        "launches_by_path": by_path["infonce_tiled"], "max_abs_err": nce_err["infonce_tiled"],
        **nce_times["infonce_tiled"][0], "at_4096": nce_times["infonce_tiled"][1],
        "step_check": steps["k3"],
        "fault": {k: fault_reads[k] for k in ("infonce_tf32", "infonce_partial")},
    }, {
        "name": "dense_mm", "phase": "int8_serve", "route": "cuda",
        "source": "protein_clip_tpu_torch/csrc/dense_mm.cu",
        "replaces": "tools/probe_int8_pallas.py:19",
        "launches": ictx["launches"]["dense_mm"],
        "launches_by_path": by_path["dense_mm"], "max_abs_err": p1_err["s8_max_abs_err"],
        "bf16_rel_err": p1_err["bf16_rel_err"],
        **{key: p1_times[0][key] for key in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                             "library_ms")},
        "at_wi_batch32": p1_times[1], "bf16": p1_times[2], "at_128_tokens": short_times["s8"],
        "fault": {k: fault_reads[k] for k in ("dense_mm_s8", "dense_mm_s8_small",
                                              "dense_mm_bf16")},
        "int8_cos_min": ictx["cos_min"], "int8_cos_median": ictx["cos_median"],
        "serving": serving["int8"], "bf16_serving": serving["bf16"],
        "int8_train_pairs_per_s": pairs_per_s["int8"],
    }, {
        "name": "ffn_gelu", "phase": "k6_serve", "route": "cuda",
        "source": "protein_clip_tpu_torch/csrc/ffn_gelu.cu",
        "replaces": "protein_clip_tpu/ops/ffn_pallas.py:99",
        "launches": k6ctx["launches"]["ffn_gelu"],
        "launches_by_path": by_path["ffn_gelu"], "max_abs_err": k6_err, **k6_times,
        "at_128_tokens": short_times["ffn"],
        "fault": {k: fault_reads[k] for k in ("ffn_gelu", "ffn_gelu_small")},
        "cos_min": k6ctx["cos_min"],
        "serving": serving["k6"],
    }]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(gpu_line(), flush=True)
    print(json.dumps({"kernels": measured_only(kernels)}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
