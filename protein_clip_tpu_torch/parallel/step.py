"""The data-parallel CLIP steps, frozen, finetune and LoRA, one bucket or
flat-packed: the port of ``protein_clip_tpu/parallel/step.py`` and
``finetune_step.py`` (their data axis).

A mesh step is the single-device step of its mode (``train/clip_engine``,
``train/finetune``, ``train/lora``) built for a rank's rows
(``local_cfg``) with the gathered loss, and run by ``on_rank``:

  frozen    the rank's rows through the frozen backbone (K1 on the card, in
            microbatches, with no graph) and the heads with autograd;
  unfrozen  the two-pass GradCache step: pass 1 the rank's chunks with no
            graph (packed: per-sequence token sums over its shard's
            chunks), pass 2 (K5) replays only the rank's own chunks;
  loss      every rank's (b_local, D) f32 embeddings gathered, InfoNCE over
            the global batch (K2 at pools up to 256, K3 above, as
            ``fused_infonce_fits`` routes); the gather's backward sums the
            ranks' cotangents of a rank's rows.

Every rank differentiates its own copy of the loss, so its gradients are
``world_size`` times its share; ``on_rank`` averages them over the ranks
before the optimizer applies them (the TPU package's pmean): the update is
the gradient of the global loss. Dropout draws from a generator of the
rank's own (``mesh.rank_generator``). FILIP's steps (``filip_step.py``,
``packed_step.py``, ``filip_finetune_step.py``) have row-loss tails of their
own and run through ``on_rank`` too.

A step has the single-device engines' signature, ``(params, opt_state,
esm_params, batch, generator) -> (params, opt_state, loss)``, over this
rank's rows of the batch (``engine.MeshEngine.make_prepare``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from ..train import clip_engine, finetune, lora
from ..train import packed_engine as pe
from ..train.clip_engine import EngineConfig, default_loss_fn
from ..train.filip_engine import _snap_chunks
from .distributed import gather_rows, pmean_grads
from .mesh import Mesh, local_batch_size, rank_generator

ENGINES = {"frozen": clip_engine, "finetune": finetune, "lora": lora}


def gathered_loss(loss_fn: Callable) -> Callable:
    """loss(pep_local, rec_local): ``loss_fn`` over every rank's rows."""
    return lambda pep, rec: loss_fn(gather_rows(pep), gather_rows(rec))


def local_chunks(num_chunks: int, b_local: int, mesh: Mesh) -> int:
    """Backbone microbatches of a rank's rows: the single-device count over
    the data axis, snapped to a divisor of the local batch."""
    return _snap_chunks(b_local, max(1, num_chunks // mesh.data))


def local_cfg(cfg: EngineConfig, b_local: int, mesh: Mesh, **changes) -> EngineConfig:
    """``cfg`` for the single-device machinery on one rank's rows: one
    bucket (or flat packs) of b_local pairs in ``local_chunks`` (and
    ``changes``)."""
    return dataclasses.replace(cfg, batch_size=b_local, accumulated_batches=1, length_groups=1,
                               num_chunks=local_chunks(cfg.num_chunks, b_local, mesh),
                               **changes)


def check_rows(batch: dict, b_local: int) -> None:
    got = batch["pep_ids"].shape[0]
    if got != b_local:
        raise ValueError(f"the rank's batch holds {got} rows but the mesh step expects "
                         f"{b_local}: the global batch over the data axis "
                         "(engine.MeshEngine.make_prepare gives a rank its rows)")


def check_shard(batch: dict, b_local: int | None) -> None:
    """The rank's batch is one shard of the packed wire for this mesh: a
    batch dealt to another shard count would misroute tokens into the wrong
    sequences with a finite loss."""
    if "pep_operm" not in batch or any(f"{s}_{k}" in batch for s in pe.SIDES
                                       for k in ("packs", "stiers")):
        raise ValueError("the packed mesh steps take one shard of tokenize_packed_sharded "
                         "(flat packing; engine.MeshEngine.make_prepare gives a rank its shard)")
    for side in pe.SIDES:
        got = tuple(batch[f"{side}_operm"].shape)
        if len(got) != 1 or (b_local is not None and got[0] != b_local):
            raise ValueError(f"packed shard carries {side} operm {got} but the mesh expects "
                             f"({b_local},): tokenize_packed_sharded's n_shards must equal the "
                             "data axis")


def check_flat(tiers: int) -> None:
    if tiers > 1:
        raise ValueError("the packed mesh steps take flat packing only (packed_tiers=1)")


class _Averaged:
    """An optimizer state whose ``apply`` first averages the gradients of
    its leaves over the ranks."""

    def __init__(self, state):
        self.state = state
        self.leaves = state.leaves

    def apply(self) -> None:
        pmean_grads(self.leaves)
        self.state.apply()


def on_rank(step: Callable, mesh: Mesh, b_local: int, packed: bool) -> Callable:
    """``step``, a single-device step over a rank's rows, on the mesh: the
    rank's batch checked (its rows, or its shard of the packed wire), its
    dropout from the rank's generator, its gradients averaged over the
    ranks before the optimizer applies them."""
    check = check_shard if packed else check_rows

    def mesh_step(params, opt_state, esm_params, batch, generator):
        check(batch, b_local)
        params, _, loss = step(params, _Averaged(opt_state), esm_params, batch,
                               rank_generator(generator, mesh.index))
        return params, opt_state, loss

    return mesh_step


def make_sharded_train_step(cfg: EngineConfig, mesh: Mesh, mode: str = "frozen",
                            packed: bool = False):
    """The CLIP step of ``mode`` over a rank's rows of ``tokenize_pair_batch``
    batches of ``cfg.global_batch`` pairs, or (``packed``) over its shard of
    ``tokenize_packed_sharded``'s."""
    if packed:
        check_flat(cfg.packed_tiers)
    b_local = local_batch_size(cfg.global_batch, mesh)
    step = ENGINES[mode].make_train_step(local_cfg(cfg, b_local, mesh, packed=packed),
                                         gathered_loss(default_loss_fn()))
    return on_rank(step, mesh, b_local, packed)


def make_sharded_eval_step(cfg: EngineConfig, mesh: Mesh, mode: str = "frozen",
                           packed: bool = False):
    """The CLIP eval step of ``mode`` over a rank's rows of a padded batch,
    or its shard of a packed one (any batch the data axis divides)."""
    b_local = local_batch_size(cfg.global_batch, mesh)
    step = ENGINES[mode].make_eval_step(local_cfg(cfg, b_local, mesh, packed=packed),
                                        gathered_loss(default_loss_fn()))
    if not packed:
        return step

    def shard_step(params, esm_params, batch):
        check_shard(batch, None)
        return step(params, esm_params, batch)

    return shard_step
