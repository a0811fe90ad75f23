"""FILIP training engine over a frozen backbone: the port of
``protein_clip_tpu/train/filip_engine.py``.

Per-batch training (no GradCache, as the reference's FILIP recipe): the
loss is the mean of the two directions' InfoNCE over the late-interaction
scores (``ops/infonce.filip_loss``, with ``cfg.filip_use_dcl`` the
diagonal out of the denominator). The scores come from
``ops/filip.filip_similarity_fused`` by default, the masked max-sim kernel
K4 on the card (its plain version on CPU tensors), whose backward is
``ops/filip.maxsim_backward``; the backbone runs with no graph in
``cfg.num_chunks`` microbatches.

With ``cfg.length_groups`` > 1 the batch arrives length-grouped
(``clip_engine.tokenize_grouped``): each group's backbone runs at its own
pad bucket, and the (B, B) scores are assembled from n x n rectangular K4
blocks, so negatives span every group and the diagonal stays aligned
(pairs were permuted together).

The steps have ``clip_engine``'s signatures, so ``loop.fit(...,
use_gradcache=False, engine=filip_engine)`` drives them. Packed FILIP
(``cfg.packed``, the TPU package's ``train/filip_packed.py``) is not
ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models import filip
from ..ops.filip import filip_similarity_fused
from ..ops.infonce import filip_loss
from .clip_engine import EngineConfig, _update, expand_batch


def _snap_chunks(batch: int, want: int) -> int:
    """The most backbone microbatches, at most ``want``, that divide batch."""
    n = max(1, min(want, batch))
    while batch % n:
        n -= 1
    return n


def _check_flat(cfg: EngineConfig) -> None:
    if cfg.packed:
        raise NotImplementedError("packed FILIP (train/filip_packed.py, --scatter-tiers) is "
                                  "not ported yet (ROADMAP queue 1: packed FILIP)")


def _grouped_scores(params, esm_params, batches, cfg: EngineConfig, sim_fn: Callable,
                    train: bool, generator):
    """(sim_a, sim_b), each (B, B), of tokenize_grouped batches: each
    group encoded at its own bucket, the n x n rectangular blocks of
    ``sim_fn`` concatenated."""
    if isinstance(batches, dict):
        raise ValueError("grouped FILIP steps need a tuple of tokenize_grouped batches "
                         "(cfg.length_groups > 1 pairs with the grouped tokenizer)")
    batches = [expand_batch(b) for b in batches]
    sides = []
    for b in batches:
        n_chunks = _snap_chunks(b["pep_ids"].shape[0], max(1, cfg.num_chunks // len(batches)))
        ha, hb = filip.encode_batch_tokens(params, esm_params, b, cfg.model, train=train,
                                           generator=generator, num_chunks=n_chunks)
        sides.append((ha, hb, b["pep_mask"], b["rec_mask"]))
    blocks = [[sim_fn(a[0], b[1], a[2], b[3], params["temperature"]) for b in sides]
              for a in sides]
    return tuple(torch.cat([torch.cat([blk[k] for blk in row], dim=1) for row in blocks])
                 for k in (0, 1))


def make_train_step(cfg: EngineConfig, similarity_fn: Callable | None = None,
                    use_dcl: bool | None = None):
    """The step over one pad bucket, or with ``cfg.length_groups`` > 1 the
    grouped step. ``similarity_fn`` defaults to ``filip_similarity_fused``
    and ``use_dcl`` to ``cfg.filip_use_dcl``."""
    _check_flat(cfg)
    if cfg.length_groups > 1:
        return make_train_step_grouped(cfg, similarity_fn, use_dcl)
    use_dcl = cfg.filip_use_dcl if use_dcl is None else use_dcl
    sim_fn = similarity_fn or filip_similarity_fused
    n_chunks = _snap_chunks(cfg.batch_size, cfg.num_chunks)

    def step(params, opt_state, esm_params, batch, generator):
        sim_a, sim_b = filip.forward(params, esm_params, expand_batch(batch), cfg.model,
                                     train=True, generator=generator, similarity_fn=sim_fn,
                                     num_chunks=n_chunks)
        return _update(filip_loss(sim_a, sim_b, use_dcl), params, opt_state)

    return step


def make_train_step_grouped(cfg: EngineConfig, similarity_fn: Callable | None = None,
                            use_dcl: bool | None = None):
    """The step over tokenize_grouped batches: per-group backbone buckets,
    the (B, B) scores assembled from per-(group, group) blocks."""
    use_dcl = cfg.filip_use_dcl if use_dcl is None else use_dcl
    sim_fn = similarity_fn or filip_similarity_fused

    def step(params, opt_state, esm_params, batches, generator):
        sim_a, sim_b = _grouped_scores(params, esm_params, batches, cfg, sim_fn, True,
                                       generator)
        return _update(filip_loss(sim_a, sim_b, use_dcl), params, opt_state)

    return step


def make_eval_step(cfg: EngineConfig, similarity_fn: Callable | None = None,
                   use_dcl: bool | None = None):
    """The eval step on the train step's data path (grouped or one bucket),
    in eval mode and with no graph."""
    _check_flat(cfg)
    if cfg.length_groups > 1:
        return make_eval_step_grouped(cfg, similarity_fn, use_dcl)
    use_dcl = cfg.filip_use_dcl if use_dcl is None else use_dcl
    sim_fn = similarity_fn or filip_similarity_fused
    n_chunks = _snap_chunks(cfg.batch_size, cfg.num_chunks)

    @torch.inference_mode()
    def step(params, esm_params, batch):
        return filip_loss(*filip.forward(params, esm_params, expand_batch(batch), cfg.model,
                                         similarity_fn=sim_fn, num_chunks=n_chunks), use_dcl)

    return step


def make_eval_step_grouped(cfg: EngineConfig, similarity_fn: Callable | None = None,
                           use_dcl: bool | None = None):
    """Eval over tokenize_grouped batches: the grouped train path's scores,
    in eval mode and with no graph."""
    use_dcl = cfg.filip_use_dcl if use_dcl is None else use_dcl
    sim_fn = similarity_fn or filip_similarity_fused

    @torch.inference_mode()
    def step(params, esm_params, batches):
        return filip_loss(*_grouped_scores(params, esm_params, batches, cfg, sim_fn, False,
                                           None), use_dcl)

    return step
