"""Throughput of the packed frozen CLIP train step on the card: the port's
counterpart of the TPU package's headline ``bench.py`` (its ``main``).

    python -m protein_clip_tpu_torch.tools.bench_train
    PCT_BENCH_PROFILE=longtail python -m protein_clip_tpu_torch.tools.bench_train

ESM-2 t30_150M in bf16 with seeded random weights (seed 0), CLIP heads
(seed 1), Adam at 1e-3, global batch 256 packed (``cfg.packed``, 16 rows a
chunk). Eleven global batches of synthetic pairs are drawn from
``numpy.random.default_rng(42)`` as ``bench.py`` draws them: peptides of
8-29 residues, receptors of 100-499 (``PCT_BENCH_PROFILE=longtail``: 90% of
100-399 and 10% of 1200-1998), tokenized into the packed wire and staged on
the card. One warm step, then 10 timed steps with the losses left on the
card until the end, as ``train_gc`` runs them; the wall clock stops when
every loss has been read. Prints one JSON line: pairs/s, the step time,
K1 launches and InfoNCE calls per step, each timed batch's (rows, width)
per side, and the card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

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
from ..train import clip_engine, optimizer, packed_engine
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


def main() -> int:
    device = resolve_device("cuda")
    profile = os.environ.get("PCT_BENCH_PROFILE", "standard")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    esm_cfg = common.esm_config("t30_150M", "bfloat16")
    esm_params = esm2.init_params(esm_cfg, torch.Generator(device=device).manual_seed(0),
                                  dtype=esm_cfg.compute_dtype, device=device)
    mcfg = clip.CLIPConfig(input_dim=esm_cfg.hidden_size, esm=esm_cfg)
    params = clip.init_params(mcfg, torch.Generator().manual_seed(1), device=device)
    cfg = clip_engine.EngineConfig(model=mcfg, batch_size=16,
                                   accumulated_batches=GLOBAL_BATCH // 16, packed=True)
    state = optimizer.adam(cfg.learning_rate).init(params)
    step = clip_engine.make_train_step(cfg)
    gen = torch.Generator(device=device).manual_seed(0)

    host = make_batches(np.random.default_rng(42), STEPS + 1, profile)
    batches = [to_device(b, device) for b in host]
    torch.cuda.synchronize()
    params, state, loss = step(params, state, esm_params, batches[0], gen)
    float(loss)
    k1 = attention.fused_attention.launches
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
        "step_ms": 1e3 * dt / STEPS, "global_batch": GLOBAL_BATCH, "steps": STEPS,
        "profile": profile, "packs": packs,
        "k1_launches_per_step": (attention.fused_attention.launches - k1) / STEPS,
        "infonce_calls_per_step": (infonce.fused_infonce.launches
                                   + infonce.fused_infonce_tiled.launches - nce) / STEPS,
        "device": torch.cuda.get_device_name(0), "gpu": gpu}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
