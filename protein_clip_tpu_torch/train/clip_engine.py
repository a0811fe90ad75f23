"""CLIP training engine over a frozen backbone: the port of
``protein_clip_tpu/train/clip_engine.py``.

- batches are tokenized on the host into int8 ids at static bucket lengths
  (``tokenize_pair_batch``), or length-grouped (``tokenize_grouped``);
- the frozen ESM-2 backbone runs once per step over microbatches
  (``gradcache.encode_hidden_chunked``), with no graph;
- the heads run in f32 with autograd, the loss is the fused InfoNCE (K2 or
  K3 on the card), and the optimizer updates the head parameters in place.

A step is ``(params, opt_state, esm_params, batch, generator) -> (params,
opt_state, loss)``: ``opt_state`` is ``optimizer.OptState`` bound to
``params``, whose tensors it updates in place (the TPU package returns new
ones), and ``generator`` a ``torch.Generator`` on the device that feeds
dropout in place of a JAX key. Losses come back as device tensors, so a
step does not wait for the card.

With ``cfg.packed`` the steps are ``train/packed_engine``'s, over
``tokenize_packed`` batches (flat packing). Not ported here:
``stack_batches`` / ``make_train_step_many``, which amortise a TPU dispatch
(queued as CUDA graphs).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable

import numpy as np
import torch

from ..data.prefetch import prefetch_to_device
from ..data.tokenizer import PAD_ID, EsmTokenizer
from ..models import clip
from ..ops.infonce import fused_infonce, fused_infonce_tiled
from .gradcache import encode_hidden_chunked
from .packed_engine import make_eval_step_packed, make_train_step_packed, tokenize_packed

Params = dict[str, Any]


def fused_infonce_fits(b: int) -> bool:
    """True when a pool of b goes to K2 (``fused_infonce``), False for K3
    (``fused_infonce_tiled``). K2 takes pools up to ``K2_MAX_POOL`` (512),
    K3 every pool; both take every embedding dim the wrappers accept, and
    the dim does not enter the rule (the TPU package's rule takes d for its
    VMEM fit).

    K2 is one cluster of 4 x 4 blocks over the whole logit grid: up to 256
    each block owns one 64 x 64 tile, above that four, one after another,
    with the logits formed again for the backward. K3 spreads the tiles over
    every block of the card and the clusters it holds. The split is where
    K3's forward+backward device time drops below K2's on an H100
    (``chip_smoke.time_dispatch``, PERF.md §6): K2 0.0273, 0.0280, 0.0289 ms
    at 16, 128, 256 against K3's 0.0356, 0.0363, 0.0375; at 384 and 512 K2
    0.0946 and 0.0979 against K3's 0.0395 and 0.0399."""
    return b <= 256


def default_loss_fn() -> Callable:
    """The steps' loss: K2 for pools that ``fused_infonce_fits``, K3 above.
    On CPU tensors both wrappers are the plain ``clip_infonce``; on CUDA they
    launch their kernels or raise, for every pool size."""

    def loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return (fused_infonce if fused_infonce_fits(len(x)) else fused_infonce_tiled)(x, y)

    return loss


@dataclasses.dataclass
class EngineConfig:
    model: clip.CLIPConfig
    batch_size: int = 16                 # sequences per loader sub-batch
    accumulated_batches: int = 16        # sub-batches per step: global batch 256
    learning_rate: float = 1e-3
    num_chunks: int = 16                 # backbone microbatches per step
    # > 1: sort pairs by receptor length and encode per group at tighter pad
    # buckets (tokenize_grouped); 1 = one bucket.
    length_groups: int = 1
    # sequence packing (train/packed_engine.py): about 95% of the tokens
    # filled, against about 80% for length groups; supersedes length_groups
    packed: bool = False
    # > 1: width-tiered packing, and FILIP's scatter tiers: not ported yet
    # (the packed steps raise; ROADMAP queue 1: width-tiered packing, packed
    # FILIP)
    packed_tiers: int = 1
    scatter_tiers: int = 1
    # FILIP only (train/filip_engine.py): the diagonal leaves the loss's
    # denominator (decoupled contrastive learning)
    filip_use_dcl: bool = False
    # per-layer rematerialisation of the backbone where it takes gradients
    # (train/finetune.py, train/lora.py); the frozen path keeps no graph
    remat: bool = True
    # learning rate of the backbone (finetune, default 1e-5) or of the LoRA
    # adapters (default 1e-4); the heads train at learning_rate
    backbone_lr: float | None = None
    # trainer knobs of train/optimizer.build; the defaults are plain Adam
    weight_decay: float = 0.0
    warmup_steps: int = 0
    lr_schedule: str = "constant"
    total_steps: int | None = None
    grad_clip: float = 0.0

    @property
    def global_batch(self) -> int:
        return self.batch_size * self.accumulated_batches


def tokenize_pair_batch(tokenizer: EsmTokenizer, peps: list[str],
                        recs: list[str]) -> dict[str, torch.Tensor]:
    """Both sides as int8 ids on the host (the 33-token vocab fits):
    ``expand_batch`` derives the masks on the device."""
    return {"pep_ids": torch.from_numpy(tokenizer(peps)["input_ids"].astype(np.int8)),
            "rec_ids": torch.from_numpy(tokenizer(recs)["input_ids"].astype(np.int8))}


def expand_batch(batch: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """int32 ids and attention masks from a compact batch. Pads occur only
    as trailing <pad> tokens, so the mask is ids != <pad>."""
    if "pep_mask" in batch:
        return batch
    out = {}
    for side in ("pep", "rec"):
        ids = batch[f"{side}_ids"]
        out[f"{side}_ids"] = ids.to(torch.int32)
        out[f"{side}_mask"] = (ids != PAD_ID).to(torch.int32)
    return out


def tokenize_grouped(tokenizer: EsmTokenizer, peps: list[str], recs: list[str],
                     n_groups: int = 2) -> tuple[dict[str, torch.Tensor], ...]:
    """Sort pairs by receptor length and split them into n_groups equal
    groups (the last takes the remainder), each padded to its own bucket.
    pep and rec are permuted together, so the InfoNCE diagonal stays
    aligned and the loss does not change."""
    order = sorted(range(len(recs)), key=lambda i: len(recs[i]))
    g = len(order) // n_groups
    groups = []
    for gi in range(n_groups):
        idx = order[gi * g:(gi + 1) * g] if gi < n_groups - 1 else order[(n_groups - 1) * g:]
        groups.append(tokenize_pair_batch(tokenizer, [peps[i] for i in idx],
                                          [recs[i] for i in idx]))
    return tuple(groups)


def _hidden(esm_params, batch, cfg: EngineConfig, n_chunks: int):
    mcfg = cfg.model
    hp = encode_hidden_chunked(esm_params, batch["pep_ids"], batch["pep_mask"], mcfg.esm,
                               n_chunks)
    hr = encode_hidden_chunked(esm_params, batch["rec_ids"], batch["rec_mask"], mcfg.esm,
                               n_chunks)
    return hp.float(), hr.float()


def _update(loss: torch.Tensor, params, opt_state):
    loss.backward()
    opt_state.apply()
    return params, opt_state, loss.detach()


def make_train_step(cfg: EngineConfig, loss_fn: Callable | None = None):
    """The global-batch step over one bucket; with ``cfg.length_groups`` > 1
    the grouped step, with ``cfg.packed`` the packed one. ``loss_fn``
    defaults to ``default_loss_fn()``."""
    if cfg.packed:
        return make_train_step_packed(cfg, loss_fn)
    if cfg.length_groups > 1:
        return make_train_step_grouped(cfg, loss_fn)
    loss_fn = loss_fn or default_loss_fn()
    mcfg = cfg.model

    def step(params, opt_state, esm_params, batch, generator):
        batch = expand_batch(batch)
        hp, hr = _hidden(esm_params, batch, cfg, cfg.num_chunks)
        pep = clip.encode_side(params, "pep", hp, batch["pep_mask"], mcfg, train=True,
                               generator=generator)
        rec = clip.encode_side(params, "rec", hr, batch["rec_mask"], mcfg, train=True,
                               generator=generator)
        return _update(loss_fn(pep, rec), params, opt_state)

    return step


def make_train_step_grouped(cfg: EngineConfig, loss_fn: Callable | None = None):
    """The step over length-grouped batches (``tokenize_grouped``): each
    group's backbone pass runs at its own bucket, with num_chunks /
    n_groups microbatches, and the pooled embeddings are concatenated
    before the global-batch loss."""
    loss_fn = loss_fn or default_loss_fn()
    mcfg = cfg.model

    def step(params, opt_state, esm_params, batches, generator):
        if isinstance(batches, dict):
            raise ValueError("grouped step needs a tuple of tokenize_grouped batches "
                             "(cfg.length_groups > 1 pairs with the grouped tokenizer)")
        batches = [expand_batch(b) for b in batches]
        n_chunks = max(1, cfg.num_chunks // len(batches))
        peps, recs = [], []
        for batch in batches:
            hp, hr = _hidden(esm_params, batch, cfg, n_chunks)
            peps.append(clip.encode_side(params, "pep", hp, batch["pep_mask"], mcfg,
                                         train=True, generator=generator))
            recs.append(clip.encode_side(params, "rec", hr, batch["rec_mask"], mcfg,
                                         train=True, generator=generator))
        return _update(loss_fn(torch.cat(peps), torch.cat(recs)), params, opt_state)

    return step


def make_eval_step(cfg: EngineConfig, loss_fn: Callable | None = None):
    """The eval step on the train step's data path (packed, grouped or one
    bucket), in eval mode and with no graph."""
    if cfg.packed:
        return make_eval_step_packed(cfg, loss_fn)
    if cfg.length_groups > 1:
        return make_eval_step_grouped(cfg, loss_fn)
    loss_fn = loss_fn or default_loss_fn()

    @torch.inference_mode()
    def step(params, esm_params, batch):
        return loss_fn(*clip.forward(params, esm_params, expand_batch(batch), cfg.model))

    return step


def make_eval_step_grouped(cfg: EngineConfig, loss_fn: Callable | None = None):
    """Eval over length-grouped batches: each group at its own bucket."""
    loss_fn = loss_fn or default_loss_fn()

    @torch.inference_mode()
    def step(params, esm_params, batches):
        if isinstance(batches, dict):
            raise ValueError("grouped eval step needs a tuple of tokenize_grouped batches "
                             "(cfg.length_groups > 1 pairs with the grouped tokenizer)")
        pairs = [clip.forward(params, esm_params, expand_batch(b), cfg.model) for b in batches]
        return loss_fn(torch.cat([p for p, _ in pairs]), torch.cat([r for _, r in pairs]))

    return step


def _accumulate(loader: Iterable, n: int):
    """Group n loader sub-batches into one global (peps, recs) batch; a
    trailing partial global batch is dropped, as the reference does."""
    peps: list[str] = []
    recs: list[str] = []
    count = 0
    for p, r in loader:
        peps.extend(p)
        recs.extend(r)
        count += 1
        if count == n:
            yield peps, recs
            peps, recs, count = [], [], 0


def _prepare(tokenizer: EsmTokenizer, cfg: EngineConfig | None):
    """(peps, recs) -> host batch, packed or grouped when cfg asks for it."""
    if cfg is not None and cfg.packed:
        return lambda p, r: tokenize_packed(tokenizer, p, r, tiers=cfg.packed_tiers,
                                            scatter_tiers=cfg.scatter_tiers)
    if cfg is not None and cfg.length_groups > 1:
        return lambda p, r: tokenize_grouped(tokenizer, p, r, cfg.length_groups)
    return lambda p, r: tokenize_pair_batch(tokenizer, p, r)


def _mean(losses: list[torch.Tensor]) -> float:
    return float(np.mean([float(x) for x in losses]))


def train_gc(params, opt_state, esm_params, loader, tokenizer, step_fn, cfg: EngineConfig,
             generator: torch.Generator, device) -> tuple[Params, Any, float]:
    """One epoch of global-batch training: (params, opt_state, mean loss).
    Tokenization runs on a background thread two batches ahead
    (``data/prefetch.py``); the losses are read once, at the epoch's end."""
    prepare = _prepare(tokenizer, cfg)
    batches = prefetch_to_device(_accumulate(loader, cfg.accumulated_batches),
                                 lambda pr: prepare(*pr), device)
    losses = []
    for batch in batches:
        params, opt_state, loss = step_fn(params, opt_state, esm_params, batch, generator)
        losses.append(loss)
    if not losses:
        raise ValueError(f"loader yielded fewer than accumulated_batches="
                         f"{cfg.accumulated_batches} sub-batches; no training step ran")
    return params, opt_state, _mean(losses)


def train_plain(params, opt_state, esm_params, loader, tokenizer, step_fn,
                generator: torch.Generator, device, cfg: EngineConfig | None = None
                ) -> tuple[Params, Any, float]:
    """Per-sub-batch training (the reference's ``train()``); 0.0 when the
    loader is empty."""
    prepare = _prepare(tokenizer, cfg)
    batches = prefetch_to_device(loader, lambda pr: prepare(*pr), device)
    losses = []
    for batch in batches:
        params, opt_state, loss = step_fn(params, opt_state, esm_params, batch, generator)
        losses.append(loss)
    return params, opt_state, _mean(losses) if losses else 0.0


def evaluate(params, esm_params, loader, tokenizer, eval_step, device,
             cfg: EngineConfig | None = None) -> float:
    """Mean per-batch loss; NaN for an empty loader (a dataset smaller than
    one batch with drop_last), where the reference would divide by 0."""
    prepare = _prepare(tokenizer, cfg)
    losses = [eval_step(params, esm_params, batch)
              for batch in prefetch_to_device(loader, lambda pr: prepare(*pr), device)]
    return _mean(losses) if losses else float("nan")
