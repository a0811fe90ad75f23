"""Throughput of the packed CLIP train step on the card: the port of the
TPU package's ``bench.py`` (its ``main``, ``bench_finetune`` and
``bench_lora``).

    python -m protein_clip_tpu_torch.tools.bench_train
    PCT_BENCH_PROFILE=longtail python -m protein_clip_tpu_torch.tools.bench_train
    PCT_BENCH_MODE=finetune python -m protein_clip_tpu_torch.tools.bench_train
    PCT_BENCH_MODE=lora PCT_LORA_RANK=8 python -m protein_clip_tpu_torch.tools.bench_train

ESM-2 t30_150M with seeded random weights (seed 0), CLIP heads (seed 1),
global batch 256 packed (``cfg.packed``, 16 rows a chunk). The mode
(``PCT_BENCH_MODE``) picks the step:

- ``frozen`` (default): the bf16 backbone frozen, Adam at 1e-3;
- ``finetune``: the packed finetune step (``train/finetune.py``), an f32
  master backbone in bf16 compute, remat, the two-group Adam with the
  backbone at 1e-5 (``bench_finetune``);
- ``lora``: the packed LoRA step (``train/lora.py``) over a bf16 base,
  adapters of rank ``PCT_LORA_RANK`` (default 8, seed 2) at 1e-4
  (``bench_lora``).

Eleven global batches of synthetic pairs are drawn from
``numpy.random.default_rng(42)`` as ``bench.py`` draws them: peptides of
8-29 residues, receptors of 100-499 (``PCT_BENCH_PROFILE=longtail``: 90% of
100-399 and 10% of 1200-1998), tokenized into the packed wire and staged on
the card. One warm step, then 10 timed steps with the losses left on the
card until the end, as ``train_gc`` runs them; the wall clock stops when
every loss has been read. Prints one JSON line: pairs/s, the step time,
K1 and K5 launches (the wrappers' counts: a K5 call runs two kernels) and
InfoNCE calls per step, the peak of
``torch.cuda.max_memory_allocated`` over the timed steps, each timed
batch's (rows, width) per side, and the card's name and power limit. Needs
a CUDA card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import time

import numpy as np
import torch

from ..cli import common
from ..data.prefetch import to_device
from ..models import clip, esm2
from ..ops import attention, infonce
from ..train import clip_engine, finetune, lora, optimizer, packed_engine
from ..utils.device import resolve_device

AAS = list("LAGVSERTIDPKQNFYMHWC")
GLOBAL_BATCH = 256
STEPS = 10


def rec_len(rng: np.random.Generator, profile: str) -> int:
    """A receptor length, as ``bench.py``'s ``_rec_len`` draws it."""
    if profile == "longtail":
        if rng.random() < 0.10:
            return rng.integers(1200, 1999)
        return rng.integers(100, 400)
    return rng.integers(100, 500)


def make_batches(rng: np.random.Generator, n: int, profile: str) -> list[dict]:
    """n packed host batches of GLOBAL_BATCH pairs, drawn in ``bench.py``'s
    order: a batch's peptides, then its receptors."""
    tok = common.make_tokenizer()
    out = []
    for _ in range(n):
        peps = ["".join(rng.choice(AAS, rng.integers(8, 30))) for _ in range(GLOBAL_BATCH)]
        recs = ["".join(rng.choice(AAS, rec_len(rng, profile))) for _ in range(GLOBAL_BATCH)]
        out.append(packed_engine.tokenize_packed(tok, peps, recs))
    return out


def build(mode: str, device) -> tuple:
    """(params, optimizer state, esm_params, step) of ``mode``'s packed step,
    configured as ``bench.py`` configures it."""
    esm_cfg = common.esm_config("t30_150M", "bfloat16")
    mcfg = clip.CLIPConfig(input_dim=esm_cfg.hidden_size, esm=esm_cfg)
    heads = clip.init_params(mcfg, torch.Generator().manual_seed(1), device=device)
    cfg = clip_engine.EngineConfig(model=mcfg, batch_size=16,
                                   accumulated_batches=GLOBAL_BATCH // 16, packed=True)
    gen0 = torch.Generator(device=device).manual_seed(0)
    if mode == "frozen":
        esm_params = esm2.init_params(esm_cfg, gen0, dtype=esm_cfg.compute_dtype, device=device)
        return (heads, optimizer.adam(cfg.learning_rate).init(heads), esm_params,
                clip_engine.make_train_step(cfg))
    if mode == "finetune":
        cfg = dataclasses.replace(cfg, num_chunks=16, remat=True, backbone_lr=1e-5)
        params = finetune.init_params(
            esm2.init_params(esm_cfg, gen0, dtype=torch.float32, device=device), heads)
        return (params, finetune.make_optimizer(cfg).init(params), {},
                finetune.make_train_step(cfg))
    if mode == "lora":
        cfg = dataclasses.replace(cfg, num_chunks=16, remat=True, backbone_lr=1e-4)
        esm_params = esm2.init_params(esm_cfg, gen0, dtype=esm_cfg.compute_dtype, device=device)
        rank = int(os.environ.get("PCT_LORA_RANK", "8"))
        params = lora.init_params(
            lora.init_lora(torch.Generator(device=device).manual_seed(2), esm_params, rank),
            heads)
        return params, lora.make_optimizer(cfg).init(params), esm_params, lora.make_train_step(cfg)
    raise ValueError(f"PCT_BENCH_MODE={mode!r}: frozen, finetune or lora")


def main() -> int:
    device = resolve_device("cuda")
    profile = os.environ.get("PCT_BENCH_PROFILE", "standard")
    mode = os.environ.get("PCT_BENCH_MODE", "frozen")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    params, state, esm_params, step = build(mode, device)
    gen = torch.Generator(device=device).manual_seed(0)

    host = make_batches(np.random.default_rng(42), STEPS + 1, profile)
    batches = [to_device(b, device) for b in host]
    torch.cuda.synchronize()
    params, state, loss = step(params, state, esm_params, batches[0], gen)
    float(loss)
    torch.cuda.reset_peak_memory_stats()
    k1 = attention.fused_attention.launches
    k5 = attention.fused_attention_bwd.launches
    nce = infonce.fused_infonce.launches + infonce.fused_infonce_tiled.launches
    losses = []
    t0 = time.perf_counter()
    for b in batches[1:]:
        params, state, loss = step(params, state, esm_params, b, gen)
        losses.append(loss)
    values = [float(x) for x in losses]
    dt = time.perf_counter() - t0
    if not all(np.isfinite(values)):
        raise RuntimeError(f"non-finite losses {values}")
    packs = {side: [list(b[f"{side}_ids"].shape) for b in host[1:]] for side in ("pep", "rec")}
    print(json.dumps({
        "metric": "pairs_per_sec", "value": STEPS * GLOBAL_BATCH / dt, "unit": "pairs/s",
        "mode": mode, "step_ms": 1e3 * dt / STEPS, "global_batch": GLOBAL_BATCH,
        "steps": STEPS, "profile": profile, "packs": packs,
        "k1_launches_per_step": (attention.fused_attention.launches - k1) / STEPS,
        "k5_launches_per_step": (attention.fused_attention_bwd.launches - k5) / STEPS,
        "infonce_calls_per_step": (infonce.fused_infonce.launches
                                   + infonce.fused_infonce_tiled.launches - nce) / STEPS,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "device": torch.cuda.get_device_name(0), "gpu": gpu}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
