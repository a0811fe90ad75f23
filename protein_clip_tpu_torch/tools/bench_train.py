"""Throughput of the packed CLIP and FILIP train steps on the card: the port
of the TPU package's ``bench.py`` (its ``main``, ``bench_finetune``,
``bench_lora``, ``bench_filip``, ``bench_finetune_filip`` and
``bench_eval``).

    python -m protein_clip_tpu_torch.tools.bench_train
    PCT_BENCH_PROFILE=longtail python -m protein_clip_tpu_torch.tools.bench_train
    PCT_BENCH_MODE=finetune python -m protein_clip_tpu_torch.tools.bench_train
    PCT_BENCH_MODE=lora PCT_LORA_RANK=8 python -m protein_clip_tpu_torch.tools.bench_train
    PCT_BENCH_MODE=filip python -m protein_clip_tpu_torch.tools.bench_train
    PCT_BENCH_MODE=finetune_filip python -m protein_clip_tpu_torch.tools.bench_train
    PCT_ESM_CONFIG=t33_650M PCT_BENCH_MODE=finetune python -m protein_clip_tpu_torch.tools.bench_train
    PCT_BENCH_MODE=eval python -m protein_clip_tpu_torch.tools.bench_train
    PCT_PACK_TIERS=4 PCT_BENCH_PROFILE=longtail python -m protein_clip_tpu_torch.tools.bench_train
    PCT_BENCH_MODE=mlm PCT_MLM_MODE=finetune PCT_MLM_PACKED=1 python -m protein_clip_tpu_torch.tools.bench_train

ESM-2 ``PCT_ESM_CONFIG`` (default t30_150M, as ``bench.py`` reads it; every
family runs on the card in bf16) with seeded random weights (seed 0), CLIP
heads (seed 1),
global batch 256 packed (``cfg.packed``, 16 rows a chunk). The mode
(``PCT_BENCH_MODE``) picks the step:

- ``frozen`` (default): the bf16 backbone frozen, Adam at 1e-3;
- ``finetune``: the packed finetune step (``train/finetune.py``), an f32
  master backbone in bf16 compute, remat, the two-group Adam with the
  backbone at 1e-5 (``bench_finetune``);
- ``lora``: the packed LoRA step (``train/lora.py``) over a bf16 base,
  adapters of rank ``PCT_LORA_RANK`` (default 8, seed 2) at 1e-4
  (``bench_lora``);
- ``filip``: the packed FILIP step (``train/filip_packed.py``) over the
  frozen bf16 backbone, FILIP heads (seed 1), batch ``PCT_FILIP_BATCH``
  (default 128, no accumulation), ``PCT_FILIP_SCATTER_TIERS`` scatter
  tiers (default 4), remat, Adam at 1e-3, 8 timed steps (``bench_filip``);
- ``finetune_filip``: the packed FILIP finetune step
  (``train/filip_finetune.py``) at the same batch and tiers, an f32 master
  backbone at 1e-5, 6 timed steps (``bench_finetune_filip``);
- ``mlm``: the MLM step of ``cli/mlm_train.py`` (``bench_mlm``): the LM
  head (seed 1) over the frozen bf16 backbone (``PCT_MLM_MODE=head``, the
  default) or with the f32 master backbone too (``finetune``, remat; one
  Adam at 1e-3 over both, as ``bench_mlm`` has it), Adam,
  ``PCT_MLM_BATCH`` sequences a step (default 64) of receptor lengths,
  padded or packed into rows (``PCT_MLM_PACKED=1``), 15% masking from a
  generator seeded 0; 8 timed steps, in real (not pad) tokens a second;
- ``eval``: the frozen mode's model on its draws, no step: the packed eval
  step (``make_eval_step``, what ``fit`` validates with under
  ``--packed``) and the packed retrieval encode (``embed_packed``, what
  ``cli.topk --packed`` runs), each timed over the 10 batches after a warm
  one, in pairs/s (``bench_eval``).

``PCT_PACK_TIERS`` (default 1) packs the frozen, eval and FILIP modes'
batches in that many width tiers (``tokenize_packed(tiers=...)``), as
``bench.py`` reads it.

Global batches of synthetic pairs are drawn from
``numpy.random.default_rng(42)`` as ``bench.py`` draws them: peptides of
8-29 residues, receptors of 100-499 (``PCT_BENCH_PROFILE=longtail``: 90% of
100-399 and 10% of 1200-1998); the FILIP modes draw both sides as
receptors. They are tokenized into the packed wire and staged on the card.
One warm step, then the timed steps (10 for CLIP) with the losses left on
the card until the end, as ``train_gc`` runs them; the wall clock stops
when every loss has been read. Prints one JSON line: the family, pairs/s, the step
time, K1, K4 and K5 launches (the wrappers' counts: a K5 call runs two
kernels) and InfoNCE calls per step, the peak of
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
from ..cli import mlm_train
from ..models import clip, esm2, filip
from ..ops import attention, infonce
from ..ops import filip as maxsim
from ..train import (clip_engine, filip_engine, filip_finetune, finetune, lora, optimizer,
                     packed_engine)
from ..utils.device import resolve_device

AAS = list("LAGVSERTIDPKQNFYMHWC")
GLOBAL_BATCH = 256
STEPS = 10
FILIP_STEPS = {"filip": 8, "finetune_filip": 6}


def rec_len(rng: np.random.Generator, profile: str) -> int:
    """A receptor length, as ``bench.py``'s ``_rec_len`` draws it."""
    if profile == "longtail":
        if rng.random() < 0.10:
            return rng.integers(1200, 1999)
        return rng.integers(100, 400)
    return rng.integers(100, 500)


def pack_tiers() -> int:
    """Width tiers of the frozen, eval and FILIP modes' packing,
    ``PCT_PACK_TIERS`` (default 1: flat), as ``bench.py`` reads it."""
    return int(os.environ.get("PCT_PACK_TIERS", "1"))


def make_batches(rng: np.random.Generator, n: int, profile: str, tiers: int = 1) -> list[dict]:
    """n packed host batches of GLOBAL_BATCH pairs, drawn in ``bench.py``'s
    order: a batch's peptides, then its receptors; in ``tiers`` widths a
    side (the sticky caches cleared first)."""
    tok = common.make_tokenizer()
    packed_engine.clear_tier_width_cache()
    out = []
    for _ in range(n):
        peps = ["".join(rng.choice(AAS, rng.integers(8, 30))) for _ in range(GLOBAL_BATCH)]
        recs = ["".join(rng.choice(AAS, rec_len(rng, profile))) for _ in range(GLOBAL_BATCH)]
        out.append(packed_engine.tokenize_packed(tok, peps, recs, tiers=tiers))
    return out


def make_filip_batches(rng: np.random.Generator, n: int, profile: str, batch: int,
                       scatter_tiers: int, tiers: int = 1) -> list[dict]:
    """n packed host batches of ``batch`` FILIP pairs, drawn in
    ``bench_filip``'s order: a batch's first sides, then its second, both
    of receptor lengths; in ``tiers`` widths a side."""
    tok = common.make_tokenizer()
    packed_engine.clear_tier_width_cache()
    out = []
    for _ in range(n):
        peps = ["".join(rng.choice(AAS, rec_len(rng, profile))) for _ in range(batch)]
        recs = ["".join(rng.choice(AAS, rec_len(rng, profile))) for _ in range(batch)]
        out.append(packed_engine.tokenize_packed(tok, peps, recs, tiers=tiers,
                                                 scatter_tiers=scatter_tiers))
    return out


def pack_shapes(batch: dict, side: str) -> list[list[int]]:
    """(rows, width) of each of a packed batch's packs on one side."""
    packs = batch.get(f"{side}_packs") or ({"ids": batch[f"{side}_ids"]},)
    return [list(p["ids"].shape) for p in packs]


def esm_family() -> str:
    """The backbone family, ``PCT_ESM_CONFIG`` (default t30_150M)."""
    return os.environ.get("PCT_ESM_CONFIG", "t30_150M")


def build_filip(mode: str, device, batch: int, scatter_tiers: int) -> tuple:
    """(params, optimizer state, esm_params, step) of a FILIP mode's packed
    step, as ``bench_filip`` and ``bench_finetune_filip`` configure it."""
    esm_cfg = common.esm_config(esm_family(), "bfloat16")
    mcfg = filip.FILIPConfig(input_dim=esm_cfg.hidden_size, esm=esm_cfg)
    heads = filip.init_params(mcfg, torch.Generator().manual_seed(1), device=device)
    cfg = clip_engine.EngineConfig(model=mcfg, batch_size=batch, accumulated_batches=1,
                                   num_chunks=batch // 16, packed=True,
                                   scatter_tiers=scatter_tiers, remat=True)
    gen0 = torch.Generator(device=device).manual_seed(0)
    if mode == "filip":
        esm_params = esm2.init_params(esm_cfg, gen0, dtype=esm_cfg.compute_dtype, device=device)
        return (heads, optimizer.adam(cfg.learning_rate).init(heads), esm_params,
                filip_engine.make_train_step(cfg))
    cfg = dataclasses.replace(cfg, backbone_lr=1e-5)
    params = filip_finetune.init_params(
        esm2.init_params(esm_cfg, gen0, dtype=torch.float32, device=device), heads)
    return (params, filip_finetune.make_optimizer(cfg).init(params), {},
            filip_finetune.make_train_step(cfg))


def build(mode: str, device) -> tuple:
    """(params, optimizer state, esm_params, step) of ``mode``'s packed step,
    configured as ``bench.py`` configures it."""
    esm_cfg = common.esm_config(esm_family(), "bfloat16")
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
    raise ValueError(f"PCT_BENCH_MODE={mode!r}: frozen, finetune, lora, filip, "
                     "finetune_filip, eval or mlm")


def bench_eval(device, profile: str, gpu: str) -> dict:
    """Pairs/s of the packed eval step and of the packed retrieval encode
    (``bench.py``'s ``bench_eval``) on the frozen mode's model and draws;
    each call's outputs are left on the card until the last is read."""
    heads, _, esm_params, _ = build("frozen", device)
    esm_cfg = common.esm_config(esm_family(), "bfloat16")
    mcfg = clip.CLIPConfig(input_dim=esm_cfg.hidden_size, esm=esm_cfg)
    cfg = clip_engine.EngineConfig(model=mcfg, batch_size=16,
                                   accumulated_batches=GLOBAL_BATCH // 16, packed=True)
    eval_step = clip_engine.make_eval_step(cfg)
    batches = [to_device(b, device) for b in
               make_batches(np.random.default_rng(42), STEPS + 1, profile, pack_tiers())]
    out = {}
    for name, fn in (("eval", lambda b: eval_step(heads, esm_params, b)),
                     ("retrieval_encode",
                      lambda b: torch.cat(packed_engine.embed_packed(heads, esm_params, b,
                                                                     mcfg)).sum())):
        float(fn(batches[0]))
        k1 = attention.launches["attention_fwd"]
        t0 = time.perf_counter()
        values = [float(v) for v in [fn(b) for b in batches[1:]]]
        dt = time.perf_counter() - t0
        if not all(np.isfinite(values)):
            raise RuntimeError(f"non-finite {name} outputs {values}")
        out[f"{name}_pairs_per_sec"] = STEPS * GLOBAL_BATCH / dt
        out[f"{name}_ms"] = 1e3 * dt / STEPS
        out[f"{name}_k1_launches"] = (attention.launches["attention_fwd"] - k1) / STEPS
    return {"metric": "eval_pairs_per_sec", "value": out["eval_pairs_per_sec"],
            "unit": "pairs/s", "mode": "eval", "esm_config": esm_family(), "profile": profile,
            "global_batch": GLOBAL_BATCH, "steps": STEPS, **out,
            "device": torch.cuda.get_device_name(0), "gpu": gpu}


MLM_STEPS = 8


def bench_mlm(device, profile: str, gpu: str) -> dict:
    """Real tokens a second of the MLM step (``bench.py``'s ``bench_mlm``):
    one warm step, then MLM_STEPS timed steps with the losses left on the
    card until the last is read; K1 and K5 launches a step and the peak of
    ``torch.cuda.max_memory_allocated`` over the timed steps."""
    mode = os.environ.get("PCT_MLM_MODE", "head")
    batch = int(os.environ.get("PCT_MLM_BATCH", "64"))
    packed = os.environ.get("PCT_MLM_PACKED") == "1"
    esm_cfg = common.esm_config(esm_family(), "bfloat16")
    lm_head = esm2.init_lm_head(esm_cfg, torch.Generator().manual_seed(1), device=device)
    gen0 = torch.Generator(device=device).manual_seed(0)
    if mode == "finetune":
        esm_params = {}
        trainable = {"esm": esm2.init_params(esm_cfg, gen0, dtype=torch.float32, device=device),
                     "head": lm_head}
        opt = optimizer.adam(1e-3)
        view = lambda t, _: finetune._cast_esm(t["esm"], esm_cfg.compute_dtype)  # noqa: E731
    elif mode == "head":
        esm_params = esm2.init_params(esm_cfg, gen0, dtype=esm_cfg.compute_dtype, device=device)
        trainable, opt, view = lm_head, optimizer.adam(1e-3), None
    else:
        raise ValueError(f"PCT_MLM_MODE={mode!r}: head or finetune")
    state = opt.init(trainable)
    step, _ = mlm_train.make_steps(esm_cfg, mode, view)
    tok = common.make_tokenizer()
    rng = np.random.default_rng(42)
    batches, tokens = [], 0
    for i in range(MLM_STEPS + 1):
        seqs = ["".join(rng.choice(AAS, rec_len(rng, profile))) for _ in range(batch)]
        if packed:
            arrs = (packed_engine.tokenize_packed_rows(tok, seqs),)
            real = int((arrs[0] != 1).sum())
        else:
            enc = tok(seqs)
            arrs = (torch.from_numpy(enc["input_ids"]), torch.from_numpy(enc["attention_mask"]))
            real = int(enc["attention_mask"].sum())
        tokens += real if i > 0 else 0
        batches.append(mlm_train.batch_inputs(to_device(arrs, device), packed))
    mask_gen = torch.Generator(device=device).manual_seed(0)
    masks = [mlm_train.draw_masks(mask_gen, b, 0.15) for b in batches]
    trainable, state, loss = step(trainable, state, esm_params, batches[0], masks[0])
    float(loss)
    torch.cuda.reset_peak_memory_stats()
    k1, k5 = attention.launches["attention_fwd"], attention.launches["attention_bwd"]
    losses = []
    t0 = time.perf_counter()
    for b, m in zip(batches[1:], masks[1:]):
        trainable, state, loss = step(trainable, state, esm_params, b, m)
        losses.append(loss)
    values = [float(x) for x in losses]
    dt = time.perf_counter() - t0
    if not all(np.isfinite(values)):
        raise RuntimeError(f"non-finite MLM losses {values}")
    return {"metric": "mlm_tokens_per_sec", "value": tokens / dt, "unit": "tokens/s",
            "mode": "mlm", "mlm_mode": mode, "packed": packed, "batch": batch,
            "esm_config": esm_family(), "profile": profile, "steps": MLM_STEPS,
            "seqs_per_sec": MLM_STEPS * batch / dt, "step_ms": 1e3 * dt / MLM_STEPS,
            "rows": [list(b["ids"].shape) for b in batches[1:]],
            "k1_launches_per_step": (attention.launches["attention_fwd"] - k1) / MLM_STEPS,
            "k5_launches_per_step": (attention.launches["attention_bwd"] - k5) / MLM_STEPS,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "device": torch.cuda.get_device_name(0), "gpu": gpu}


def main() -> int:
    device = resolve_device("cuda")
    profile = os.environ.get("PCT_BENCH_PROFILE", "standard")
    mode = os.environ.get("PCT_BENCH_MODE", "frozen")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    if mode == "eval":
        print(json.dumps(bench_eval(device, profile, gpu)))
        return 0
    if mode == "mlm":
        print(json.dumps(bench_mlm(device, profile, gpu)))
        return 0
    rng = np.random.default_rng(42)
    if mode in FILIP_STEPS:
        pairs = int(os.environ.get("PCT_FILIP_BATCH", "128"))
        tiers = int(os.environ.get("PCT_FILIP_SCATTER_TIERS", "4"))
        steps = FILIP_STEPS[mode]
        params, state, esm_params, step = build_filip(mode, device, pairs, tiers)
        host = make_filip_batches(rng, steps + 1, profile, pairs, tiers,
                                  pack_tiers() if mode == "filip" else 1)
    else:
        pairs, tiers, steps = GLOBAL_BATCH, 1, STEPS
        params, state, esm_params, step = build(mode, device)
        host = make_batches(rng, steps + 1, profile, pack_tiers() if mode == "frozen" else 1)
    gen = torch.Generator(device=device).manual_seed(0)
    batches = [to_device(b, device) for b in host]
    torch.cuda.synchronize()
    params, state, loss = step(params, state, esm_params, batches[0], gen)
    float(loss)
    torch.cuda.reset_peak_memory_stats()
    k1 = attention.launches["attention_fwd"]
    k5 = attention.launches["attention_bwd"]
    k4 = maxsim.filip_similarity_fused.launches
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
    packs = {side: [pack_shapes(b, side) for b in host[1:]] for side in ("pep", "rec")}
    print(json.dumps({
        "metric": "pairs_per_sec", "value": steps * pairs / dt, "unit": "pairs/s",
        "mode": mode, "esm_config": esm_family(), "step_ms": 1e3 * dt / steps, "global_batch": pairs,
        "scatter_tiers": tiers, "pack_tiers": pack_tiers() if mode in ("frozen", "filip") else 1,
        "steps": steps, "profile": profile, "packs": packs,
        "k1_launches_per_step": (attention.launches["attention_fwd"] - k1) / steps,
        "k4_launches_per_step": (maxsim.filip_similarity_fused.launches - k4) / steps,
        "k5_launches_per_step": (attention.launches["attention_bwd"] - k5) / steps,
        "infonce_calls_per_step": (infonce.fused_infonce.launches
                                   + infonce.fused_infonce_tiled.launches - nce) / steps,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "device": torch.cuda.get_device_name(0), "gpu": gpu}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
