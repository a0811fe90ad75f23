"""Where the time of one train step goes, on the card: the frozen CLIP
backbone (default), ``--finetune`` or ``--lora-rank R``, each over one pad
bucket (the frozen step: length groups) or over packed rows (``--packed``);
or the FILIP step (``--filip``), frozen, packed or unfrozen alike.

    python -m protein_clip_tpu_torch.tools.profile_train [--batch-size 16]
        [--packed] [--finetune | --lora-rank 8] [--esm-config t33_650M]
        [--esm-dtype float32]
    PCT_FFN_PALLAS=1 python -m protein_clip_tpu_torch.tools.profile_train --packed
        --finetune --esm-dtype float32
    python -m protein_clip_tpu_torch.tools.profile_train --filip [--batch-size 10]
        [--length-groups 1] [--num-chunks 1] [--use-dcl] [--packed [--scatter-tiers 4]]
        [--finetune | --lora-rank 8]

Builds ESM-2 ``--esm-config`` (default t30_150M; every family runs in
bf16, or with ``--esm-dtype float32`` in f32 through K1-f32 and K5-f32)
with seeded random weights and CLIP heads on
the GPU, and global batches of batch-size x 16 pairs drawn from the seeded
synthetic corpus of 3000 families (receptors 60-180 aa, peptides 8-30 aa),
tokenized as ``cli.main`` does: into 4 length groups for the frozen step,
packed into rows (``train/packed_engine.tokenize_packed``) with
``--packed``, into one pad bucket for the unfrozen ones. Then, for the step of that
mode (16 chunks, or chunks of 16 packed rows; dropout 0.1, Adam; the
unfrozen steps with their two learning-rate groups, per-layer remat and an
f32 master backbone or rank-R adapters):

- the host time to tokenize one global batch (the prefetch thread's work);
- the wall time per step (median of 5 after 2 warm-up steps), pairs/s and
  the peak of ``torch.cuda.max_memory_allocated`` over those 5 steps;
- the same step cut into its layers, with a device sync after each (median
  of 5 more steps). Frozen: the backbone (32 chunked forwards under
  no_grad; packed: the device-side maps and one forward per chunk of
  packed rows), the heads' forward and the loss, the backward (heads and
  K2/K3), and the optimizer. Unfrozen: pass 1 (32 chunk encodes under
  no_grad), the loss and its gradient with respect to the embeddings,
  pass 2 (32 chunk encodes with a graph, each with its backward: remat
  recompute and K5), and the optimizer. Packed unfrozen: pass 1 (the
  device-side maps and each chunk's token sums under no_grad), the tail
  (pooling, loss and their backward), pass 2 (each chunk's token sums with
  a graph and their backward), and the optimizer;
- steps under ``torch.profiler`` (2 frozen, 1 unfrozen): the device's busy
  share of the wall time, kernel launches per step, K1, K5, K4 and K6
  launches (each in the backbone's dtype: K1-f32, K5-f32 and K6-f32 in f32;
  K6 only under ``PCT_FFN_PALLAS=1``) and their shares of the device time,
  and device time by kernel.

With ``--filip`` the step is ``train/filip_engine``'s over one batch of
``--batch-size`` pairs (no x 16; default 10, the FILIP CLI's), in
``--length-groups`` groups and ``--num-chunks`` backbone microbatches
(defaults 1 and 1; the CLI's scale-up is 128, 4 and 8), its layers: the
backbone, the token heads' forward, the max-sim forward (K4, one launch per
(group, group) block), the loss, the loss's backward to the scores, the
max-sim backward (plain PyTorch: ``ops/filip.maxsim_backward``, and the
temperature's share), the heads' backward, and the optimizer. With
``--packed`` (``train/filip_packed.py``, ``--scatter-tiers`` tiers, default
4) the backbone runs over packed rows, and the scatter of the normalised
tokens into their tier buffers and the assembly of the (n, n) scores from
the tier-pair K4 blocks are layers of their own, each way. With
``--finetune`` or ``--lora-rank`` the FILIP two-pass step
(``train/filip_finetune.py``, ``train/filip_lora.py``; one bucket, or
packed): pass 1, the tail (max-sim and loss, with the packed scatter,
forward and backward), pass 2 and the optimizer.

Prints the card's name and power limit beside the numbers.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..cli import common
from ..data.prefetch import to_device
from ..data.synthetic import make_pair_corpus
from ..models import clip, esm2, filip, heads
from ..ops import attention, ffn, infonce
from ..ops import filip as maxsim
from ..ops.infonce import filip_loss
from ..train import (clip_engine, filip_engine, filip_finetune, filip_lora, filip_packed,
                     finetune, lora, optimizer, packed_engine)
from ..train.gradcache import encode_hidden_chunked
from ..utils.device import resolve_device


def _wall(fn, n: int) -> list[float]:
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch-size", type=int, default=None,
                   help="pairs per sub-batch (x 16; default 16); with --filip the batch "
                        "(default 10)")
    p.add_argument("--packed", action="store_true",
                   help="the step over packed rows (train/packed_engine.py; with --finetune "
                        "or --lora-rank the packed two-pass step of train/finetune.py)")
    p.add_argument("--length-groups", type=int, default=1, help="with --filip")
    p.add_argument("--num-chunks", type=int, default=1, help="with --filip")
    p.add_argument("--use-dcl", action="store_true", help="with --filip")
    p.add_argument("--scatter-tiers", type=int, default=4, help="with --filip --packed")
    p.add_argument("--esm-config", default="t30_150M",
                   choices=["t30_150M", "t6_8M", "t12_35M", "t33_650M", "t36_3B", "t48_15B", "tiny"])
    p.add_argument("--esm-dtype", default="bfloat16", choices=["bfloat16", "float32"],
                   help="the backbone's compute dtype")
    p.add_argument("--filip", action="store_true",
                   help="the FILIP step (train/filip_engine.py; with --finetune or --lora-rank "
                        "train/filip_finetune.py or train/filip_lora.py)")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--finetune", action="store_true",
                      help="the unfrozen-backbone step (train/finetune.py)")
    mode.add_argument("--lora-rank", type=int, default=0,
                      help="> 0: the LoRA step (train/lora.py) at this rank")
    args = p.parse_args(argv)
    engine = finetune if args.finetune else lora if args.lora_rank else None
    unfrozen = engine is not None
    device = resolve_device("cuda")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"card: {gpu}; torch {torch.__version__}; --esm-config {args.esm_config}, "
          f"--esm-dtype {args.esm_dtype}")
    esm_cfg = common.esm_config(args.esm_config, args.esm_dtype)
    if args.filip:
        engine = (filip_finetune if args.finetune else filip_lora if args.lora_rank
                  else filip_engine)
        mcfg = filip.FILIPConfig(input_dim=esm_cfg.hidden_size, esm=esm_cfg)
        cfg = clip_engine.EngineConfig(model=mcfg, batch_size=args.batch_size or 10,
                                       accumulated_batches=1, num_chunks=args.num_chunks,
                                       length_groups=1 if unfrozen else args.length_groups,
                                       packed=args.packed, scatter_tiers=args.scatter_tiers,
                                       filip_use_dcl=args.use_dcl)
    else:
        mcfg = clip.CLIPConfig(input_dim=esm_cfg.hidden_size, esm=esm_cfg)
        cfg = clip_engine.EngineConfig(model=mcfg, batch_size=args.batch_size or 16,
                                       length_groups=1 if engine else 4, packed=args.packed)
    pool = cfg.global_batch
    esm_params = esm2.init_params(esm_cfg, torch.Generator(device=device).manual_seed(0),
                                  dtype=esm_cfg.compute_dtype, device=device)
    params = (filip if args.filip else clip).init_params(
        mcfg, torch.Generator().manual_seed(0), device=device)
    if args.finetune:
        params, esm_params = finetune.init_params(esm_params, params), {}
    elif args.lora_rank:
        adapters = lora.init_lora(torch.Generator(device=device).manual_seed(1), esm_params,
                                  args.lora_rank)
        params = lora.init_params(adapters, params)
    state = (engine.make_optimizer(cfg) if hasattr(engine, "make_optimizer")
             else optimizer.adam()).init(params)
    step = (engine or clip_engine).make_train_step(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    tok = common.make_tokenizer()
    peps, recs = make_pair_corpus(n_families=3000, seed=42)
    rng = np.random.default_rng(0)

    def host_batch():
        idx = rng.choice(len(recs), pool, replace=False)
        p, r = [peps[i] for i in idx], [recs[i] for i in idx]
        if args.packed:
            return (packed_engine.tokenize_packed(tok, p, r, scatter_tiers=cfg.scatter_tiers
                                                  if args.filip else 1),)
        if engine and cfg.length_groups == 1:
            return (clip_engine.tokenize_pair_batch(tok, p, r),)
        return clip_engine.tokenize_grouped(tok, p, r, cfg.length_groups)

    t0 = time.perf_counter()
    host = [host_batch() for _ in range(14)]
    tok_ms = 1e3 * (time.perf_counter() - t0) / len(host)
    shapes = [[tuple(b[f"{s}_ids"].shape) for b in host[0]] for s in ("pep", "rec")]
    batches = [to_device(b if len(b) > 1 else b[0], device) for b in host]
    print(f"[data] global batch {pool} in {len(host[0])} batch(es) of (rows, width): pep "
          f"{shapes[0]}, rec {shapes[1]} (the first batch); tokenize {tok_ms:.4f} ms per "
          f"batch on the host")

    it = iter(batches)

    def train_step():
        nonlocal params, state
        params, state, _ = step(params, state, esm_params, next(it), gen)

    loss_fn = clip_engine.default_loss_fn()

    def layered_step() -> list[float]:
        """The grouped step's code, with a sync and a clock after each layer."""
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        if args.packed:
            batch, hidden = packed_engine._packs_and_hidden(
                esm_params, next(it), mcfg, packed_engine._default_rows_per_chunk(None))
            mark()
            loss = loss_fn(*packed_engine._pooled_sides(params, batch, hidden, pool, mcfg,
                                                        train=True, generator=gen))
        else:
            groups = [clip_engine.expand_batch(b) for b in next(it)]
            hidden = [clip_engine._hidden(esm_params, b, cfg, cfg.num_chunks // len(groups))
                      for b in groups]
            mark()
            embs = [[clip.encode_side(params, side, h, b[f"{side}_mask"], mcfg, train=True,
                                      generator=gen) for side, h in zip(("pep", "rec"), hs)]
                    for hs, b in zip(hidden, groups)]
            loss = loss_fn(torch.cat([e[0] for e in embs]), torch.cat([e[1] for e in embs]))
        mark()
        loss.backward()
        mark()
        state.apply()
        mark()
        return [b - a for a, b in zip(marks, marks[1:])]

    def layered_unfrozen_step() -> list[float]:
        """The two-pass step's code (train/gradcache.gradcache_value_and_grad
        inside finetune's step), with a sync and a clock after each layer."""
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        batch = clip_engine.expand_batch(next(it))
        seeds = finetune._chunk_seeds(gen, cfg.num_chunks)
        view = engine.esm_view(cfg)
        sides = [(finetune._encoder(cfg, side, lambda p: view(p, esm_params)),
                  finetune._chunked(batch, side, cfg.num_chunks, s))
                 for side, s in zip(("pep", "rec"), seeds)]
        with torch.no_grad():
            embs = [[fn(params, c) for c in chunks] for fn, chunks in sides]
        mark()
        ex, ey = (torch.cat(e).requires_grad_(True) for e in embs)
        grads = torch.autograd.grad(loss_fn(ex, ey), (ex, ey))
        mark()
        for (fn, chunks), g in zip(sides, grads):
            for c, gc in zip(chunks, g.split(len(g) // cfg.num_chunks)):
                fn(params, c).backward(gc)
        mark()
        state.apply()
        mark()
        return [b - a for a, b in zip(marks, marks[1:])]

    def layered_packed_unfrozen_step() -> list[float]:
        """The packed two-pass step's code (finetune.make_train_step_packed),
        with a sync and a clock after each layer."""
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        chunk_sums, scan_sums, tail, prepare = finetune._packed_machinery(
            cfg, loss_fn, packed_engine._default_rows_per_chunk(None), engine.esm_view(cfg))
        sides = prepare(next(it), gen)
        with torch.no_grad():
            sums, counts = scan_sums(params, esm_params, sides)
        mark()
        for t in sums.values():
            t.requires_grad_(True)
        tail(params, sums, counts, sides).backward()
        mark()
        for side, (chunks, seeds, _) in sides.items():
            for chunk, seed in zip(chunks, seeds):
                chunk_sums(params, esm_params, side, chunk, seed)[0].backward(sums[side].grad)
        mark()
        state.apply()
        mark()
        return [b - a for a, b in zip(marks, marks[1:])]

    def layered_filip_step() -> list[float]:
        """The FILIP step's code (filip_engine), with a sync and a clock
        after each layer; the backward runs in three parts: the loss's to
        the scores, the max-sim's to the tokens and the temperature, the
        heads' to the parameters."""
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        batch = next(it)
        groups = [clip_engine.expand_batch(b) for b in
                  (batch if isinstance(batch, tuple) else (batch,))]
        hidden = [[encode_hidden_chunked(
            esm_params, b[f"{side}_ids"], b[f"{side}_mask"], mcfg.esm, filip_engine._snap_chunks(
                len(b[f"{side}_ids"]), max(1, cfg.num_chunks // len(groups)))).float()
            for side in ("pep", "rec")] for b in groups]
        mark()
        toks = [[filip.encode_side_tokens(params, side, h, mcfg, train=True, generator=gen)
                 for side, h in zip(("pep", "rec"), hs)] for hs in hidden]
        mark()
        leaves = [[t.detach().requires_grad_(True) for t in ts] for ts in toks]
        blocks = [[maxsim.filip_similarity_fused(a[0], b[1], ga["pep_mask"], gb["rec_mask"],
                                                 params["temperature"])
                   for b, gb in zip(leaves, groups)] for a, ga in zip(leaves, groups)]
        sims = [torch.cat([torch.cat([blk[k] for blk in row], dim=1) for row in blocks])
                for k in (0, 1)]
        mark()
        loss = filip_loss(*sims, cfg.filip_use_dcl)
        mark()
        grads = torch.autograd.grad(loss, sims)
        mark()
        torch.autograd.backward(sims, grads)
        mark()
        torch.autograd.backward([t for ts in toks for t in ts],
                                [x.grad for xs in leaves for x in xs])
        mark()
        state.apply()
        mark()
        return [b - a for a, b in zip(marks, marks[1:])]

    def layered_filip_packed_step() -> list[float]:
        """The packed FILIP step's code (filip_packed.filip_sim_packed and
        the loss), with a sync and a clock after each layer; each boundary
        (tokens, tier buffers, scores) is a fresh leaf, so the backward runs
        layer by layer."""
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        batch = packed_engine.expand_packed_batch(next(it))
        packs = {side: {k: batch[f"{side}_{k}"] for k in ("ids", "seg", "pos", "owner")}
                 for side in ("pep", "rec")}
        hidden = {side: packed_engine._encode_packed_chunked(
            esm_params, pk["ids"], pk["seg"], pk["pos"], mcfg.esm,
            packed_engine._default_rows_per_chunk(None)).float() for side, pk in packs.items()}
        mark()
        toks = {side: filip_packed._l2_normalize_tokens(heads.encode_tokens(
            params[side], h, mcfg.activation, dropout_rate=mcfg.dropout, train=True,
            generator=gen)) for side, h in hidden.items()}
        mark()
        tok_leaves = {side: t.detach().requires_grad_(True) for side, t in toks.items()}
        tiers = {side: filip_packed._scatter_side(x, packs[side], batch.get(f"{side}_stiers"),
                                                  pool) for side, x in tok_leaves.items()}
        mark()
        buffers = [b for side in ("pep", "rec") for t in tiers[side] for b in t[:1]]
        leaves = {side: [(t[0].detach().requires_grad_(True), *t[1:]) for t in tiers[side]]
                  for side in tiers}
        sims = filip_packed._sim_from_tiers(leaves["pep"], leaves["rec"], params["temperature"],
                                            maxsim.filip_similarity_fused, pool)
        mark()
        loss = filip_loss(*sims, cfg.filip_use_dcl)
        mark()
        grads = torch.autograd.grad(loss, sims)
        mark()
        torch.autograd.backward(sims, grads)
        mark()
        torch.autograd.backward(buffers, [t[0].grad for side in ("pep", "rec")
                                          for t in leaves[side]])
        mark()
        torch.autograd.backward(list(toks.values()), [x.grad for x in tok_leaves.values()])
        mark()
        state.apply()
        mark()
        return [b - a for a, b in zip(marks, marks[1:])]

    def layered_filip_unfrozen_step() -> list[float]:
        """The FILIP two-pass step's code (filip_finetune, one bucket or
        packed), with a sync and a clock after each pass."""
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        sim_fn, dcl, view = filip_finetune._resolve(cfg, None, None, engine_view)
        if args.packed:
            chunk_tokens, prepare, tail = filip_finetune._packed_token_machinery(
                cfg, sim_fn, dcl, packed_engine._default_rows_per_chunk(None), view)
            sides = prepare(next(it), gen)
            with torch.no_grad():
                X = filip_finetune._scan_tokens(chunk_tokens, params, esm_params, sides)
            mark()
            for x in X.values():
                x.requires_grad_(True)
            tail(params, X, sides).backward()
            mark()
            for side, (chunks, seeds, _, _) in sides.items():
                for chunk, seed, g in zip(chunks, seeds, X[side].grad.split(
                        [len(c["ids"]) for c in chunks])):
                    chunk_tokens(params, esm_params, side, chunk, seed).backward(g)
        else:
            encode_chunk, prepare, tail = filip_finetune._token_machinery(cfg, sim_fn, dcl, view)
            batch, chunks = prepare(next(it), gen)
            with torch.no_grad():
                H = {side: torch.cat([encode_chunk(params, esm_params, side, c)
                                      for c in chunks[side]]) for side in ("pep", "rec")}
            mark()
            for h in H.values():
                h.requires_grad_(True)
            tail(params, H["pep"], H["rec"], batch).backward()
            mark()
            for side in ("pep", "rec"):
                for c, g in zip(chunks[side], H[side].grad.split(len(chunks[side][0]["ids"]))):
                    encode_chunk(params, esm_params, side, c).backward(g)
        mark()
        state.apply()
        mark()
        return [b - a for a, b in zip(marks, marks[1:])]

    engine_view = (lora if args.lora_rank else finetune).esm_view(cfg) if unfrozen else None
    _wall(train_step, 2)
    torch.cuda.reset_peak_memory_stats()
    walls = _wall(train_step, 5)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    layered = (layered_filip_unfrozen_step if args.filip and unfrozen
               else layered_filip_packed_step if args.filip and args.packed
               else layered_filip_step if args.filip
               else layered_packed_unfrozen_step if engine and args.packed
               else layered_unfrozen_step if engine else layered_step)
    layers = np.median([layered() for _ in range(5)], axis=0) * 1e3
    step_ms = 1e3 * statistics.median(walls)
    names = (("pass 1", "tail (" + ("scatter, " if args.packed else "")
              + "max-sim + loss, forward and backward)", "pass 2 (forward + backward)",
              "optimizer") if args.filip and unfrozen else
             ("backbone (packed)", "heads forward", "scatter into tier buffers",
              "max-sim forward (K4) + assembly", "loss", "loss backward (to the scores)",
              "assembly + max-sim backward (plain)", "scatter backward", "heads backward",
              "optimizer") if args.filip and args.packed else
             ("backbone", "heads forward", "max-sim forward (K4)", "loss",
              "loss backward (to the scores)", "max-sim backward (plain)", "heads backward",
              "optimizer") if args.filip else
             ("pass 1", "tail (pooling + loss, forward and backward)",
              "pass 2 (forward + backward)", "optimizer") if engine and args.packed else
             ("pass 1", "loss + embedding gradients", "pass 2 (forward + backward)",
              "optimizer") if engine else
             ("backbone", "heads forward + loss", "backward", "optimizer"))
    print(f"[step] wall p50 {step_ms:.4f} ms ({pool / step_ms * 1e3:.4f} pairs/s, 5 steps); "
          f"peak memory {peak_gb:.4f} GB (max_memory_allocated) | {gpu}")
    print("[step] by layer, p50 of 5 synced steps: " + "; ".join(
        f"{n} {ms:.4f} ms ({100 * ms / layers.sum():.2f}%)" for n, ms in zip(names, layers)))

    n = 1 if unfrozen else 2

    k1_name, k5_name = (attention._kernel(name, esm_cfg.compute_dtype)
                        for name in ("attention_fwd", "attention_bwd"))
    k6_name = ffn.KERNELS[esm_cfg.compute_dtype]
    k1, k5 = attention.launches[k1_name], attention.launches[k5_name]
    k6 = ffn.launches[k6_name]
    k2 = infonce.fused_infonce.launches + infonce.fused_infonce_tiled.launches
    k4 = maxsim.filip_similarity_fused.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            train_step()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    k1 = (attention.launches[k1_name] - k1) // n
    k5 = (attention.launches[k5_name] - k5) // n
    k2 = (infonce.fused_infonce.launches + infonce.fused_infonce_tiled.launches - k2) // n
    k4 = (maxsim.filip_similarity_fused.launches - k4) // n
    k6 = (ffn.launches[k6_name] - k6) // n
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)

    def share(name: str) -> str:
        us = sum(e.self_device_time_total for e in kernels if name in e.key)
        return f"{100 * us / busy_us:.2f}% ({us / n / 1e3:.4f} ms)"

    print(f"[profile] {n} step(s): device busy {busy_us / n / 1e3:.4f} ms per step = "
          f"{100 * busy_us / 1e6 / window:.2f}% of the wall time; "
          f"{sum(e.count for e in kernels) / n:.0f} kernel launches per step ({k1} {k1_name}, "
          f"{k5} {k5_name} calls of 2 launches, {k2} InfoNCE forward calls, {k4} K4, {k6} "
          f"{k6_name}); K1 {share('attention_fwd')}, K5 {share('attention_bwd')}, K4 "
          f"{share('filip_maxsim')}, K6 "
          f"{share('FfnGeluF32Out' if k6_name == 'ffn_gelu_f32' else 'FfnGeluOut')} "
          "of the device time")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:14]:
        us = e.self_device_time_total
        print(f"[profile]   {100 * us / busy_us:6.2f}%  {us / n / 1e3:9.4f} ms/step  "
              f"{e.count // n:6d}x  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
