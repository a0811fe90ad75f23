"""Where the time of one CLIP train step goes, on the card: the frozen
backbone (default), ``--finetune`` or ``--lora-rank R``.

    python -m protein_clip_tpu_torch.tools.profile_train [--batch-size 16]
        [--finetune | --lora-rank 8]

Builds ESM-2 t30_150M in bf16 with seeded random weights and CLIP heads on
the GPU, and global batches of batch-size x 16 pairs drawn from the seeded
synthetic corpus of 3000 families (receptors 60-180 aa, peptides 8-30 aa),
tokenized as ``cli.main`` does: into 4 length groups for the frozen step,
into one pad bucket for the unfrozen ones. Then, for the step of that mode
(16 chunks, dropout 0.1, Adam; the unfrozen steps with their two
learning-rate groups, per-layer remat and an f32 master backbone or rank-R
adapters):

- the host time to tokenize one global batch (the prefetch thread's work);
- the wall time per step (median of 5 after 2 warm-up steps) and pairs/s;
- the same step cut into its layers, with a device sync after each (median
  of 5 more steps). Frozen: the backbone (32 chunked forwards under
  no_grad), the heads' forward and the loss, the backward (heads and
  K2/K3), and the optimizer. Unfrozen: pass 1 (32 chunk encodes under
  no_grad), the loss and its gradient with respect to the embeddings,
  pass 2 (32 chunk encodes with a graph, each with its backward: remat
  recompute and K5), and the optimizer;
- steps under ``torch.profiler`` (2 frozen, 1 unfrozen): the device's busy
  share of the wall time, kernel launches per step, K1 and K5 launches and
  their shares of the device time, and device time by kernel.

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
from ..models import clip, esm2
from ..ops import attention, infonce
from ..train import clip_engine, finetune, lora, optimizer
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
    p.add_argument("--batch-size", type=int, default=16, help="pairs per sub-batch (x 16)")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--finetune", action="store_true",
                      help="the unfrozen-backbone step (train/finetune.py)")
    mode.add_argument("--lora-rank", type=int, default=0,
                      help="> 0: the LoRA step (train/lora.py) at this rank")
    args = p.parse_args(argv)
    engine = finetune if args.finetune else lora if args.lora_rank else None
    device = resolve_device("cuda")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"card: {gpu}; torch {torch.__version__}")
    esm_cfg = common.esm_config("t30_150M", "bfloat16")
    mcfg = clip.CLIPConfig(input_dim=esm_cfg.hidden_size, esm=esm_cfg)
    cfg = clip_engine.EngineConfig(model=mcfg, batch_size=args.batch_size,
                                   length_groups=1 if engine else 4)
    pool = cfg.global_batch
    esm_params = esm2.init_params(esm_cfg, torch.Generator(device=device).manual_seed(0),
                                  dtype=esm_cfg.compute_dtype, device=device)
    params = clip.init_params(mcfg, torch.Generator().manual_seed(0), device=device)
    if args.finetune:
        params, esm_params = finetune.init_params(esm_params, params), {}
    elif args.lora_rank:
        adapters = lora.init_lora(torch.Generator(device=device).manual_seed(1), esm_params,
                                  args.lora_rank)
        params = lora.init_params(adapters, params)
    state = (engine.make_optimizer(cfg) if engine else optimizer.adam()).init(params)
    step = (engine or clip_engine).make_train_step(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    tok = common.make_tokenizer()
    peps, recs = make_pair_corpus(n_families=3000, seed=42)
    rng = np.random.default_rng(0)

    def host_batch():
        idx = rng.choice(len(recs), pool, replace=False)
        p, r = [peps[i] for i in idx], [recs[i] for i in idx]
        if engine:
            return (clip_engine.tokenize_pair_batch(tok, p, r),)
        return clip_engine.tokenize_grouped(tok, p, r, cfg.length_groups)

    t0 = time.perf_counter()
    host = [host_batch() for _ in range(14)]
    tok_ms = 1e3 * (time.perf_counter() - t0) / len(host)
    widths = [tuple(int(b[f"{s}_ids"].shape[1]) for b in host[0]) for s in ("pep", "rec")]
    batches = [to_device(b[0] if engine else b, device) for b in host]
    print(f"[data] global batch {pool} in {len(host[0])} pad bucket(s); pad widths of the "
          f"first batch: pep {widths[0]}, rec {widths[1]}; tokenize {tok_ms:.4f} ms per "
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

    _wall(train_step, 2)
    walls = _wall(train_step, 5)
    layers = np.median([(layered_unfrozen_step if engine else layered_step)()
                        for _ in range(5)], axis=0) * 1e3
    step_ms = 1e3 * statistics.median(walls)
    names = (("pass 1", "loss + embedding gradients", "pass 2 (forward + backward)",
              "optimizer") if engine else
             ("backbone", "heads forward + loss", "backward", "optimizer"))
    print(f"[step] wall p50 {step_ms:.4f} ms ({pool / step_ms * 1e3:.4f} pairs/s, 5 steps) | "
          f"{gpu}")
    print("[step] by layer, p50 of 5 synced steps: " + "; ".join(
        f"{n} {ms:.4f} ms ({100 * ms / layers.sum():.2f}%)" for n, ms in zip(names, layers)))

    n = 1 if engine else 2
    k1 = attention.fused_attention.launches
    k5 = attention.fused_attention_bwd.launches
    k2 = infonce.fused_infonce.launches + infonce.fused_infonce_tiled.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            train_step()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    k1 = (attention.fused_attention.launches - k1) // n
    k5 = (attention.fused_attention_bwd.launches - k5) // n
    k2 = (infonce.fused_infonce.launches + infonce.fused_infonce_tiled.launches - k2) // n
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)

    def share(name: str) -> str:
        us = sum(e.self_device_time_total for e in kernels if name in e.key)
        return f"{100 * us / busy_us:.2f}% ({us / n / 1e3:.4f} ms)"

    print(f"[profile] {n} step(s): device busy {busy_us / n / 1e3:.4f} ms per step = "
          f"{100 * busy_us / 1e6 / window:.2f}% of the wall time; "
          f"{sum(e.count for e in kernels) / n:.0f} kernel launches per step ({k1} K1, "
          f"{k5} K5 calls of 2 launches, {k2} InfoNCE forward calls); K1 "
          f"{share('attention_fwd')}, K5 {share('attention_bwd')} of the device time")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:14]:
        us = e.self_device_time_total
        print(f"[profile]   {100 * us / busy_us:6.2f}%  {us / n / 1e3:9.4f} ms/step  "
              f"{e.count // n:6d}x  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
