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
``data`` times its share; ``on_rank`` averages them over the data group
before the optimizer applies them (the TPU package's pmean): the update is
the gradient of the global loss. Dropout draws from a generator of the
rank's data index (``mesh.rank_generator``), the same on its model ranks.
FILIP's steps (``filip_step.py``, ``packed_step.py``,
``filip_finetune_step.py``) have row-loss tails of their own and run
through ``on_rank`` too.

With a 'model' axis (tensor parallelism, unpacked steps only) the config's
backbone carries the mesh's model axis (``tp_model_config``, the role of
the TPU package's ``tp_safe_model_config``, which there also switches to
eager attention: here the heads are split by hand and K1/K5 run on a
rank's heads), the backbone (or the finetune engine's f32 masters) holds
the rank's Megatron slices (``engine.MeshEngine.prepare_esm``,
``prepare_params``), and the model ranks of a data index run the same rows:
the loss and the replicated leaves' gradients are the same on each. The
LoRA adapters are replicated but used only inside the sharded region, so
each model rank's gradient of them is its slices' share: ``on_rank`` sums
it over the model group before the mean over the data group. The clip's
global norm sums the split leaves' squares over the model group
(``sharding.sharded_sq_sum``).

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
from ..train.optimizer import tree_leaves
from . import sharding
from .distributed import gather_rows, pmean_grads, psum_grads
from .mesh import Mesh, local_batch_size, rank_generator

ENGINES = {"frozen": clip_engine, "finetune": finetune, "lora": lora}


def tp_model_config(model_cfg, mesh: Mesh):
    """A CLIP or FILIP model config (or an ESM-2 one) whose backbone runs on
    the mesh's model axis; the config itself at model 1."""
    if mesh.model == 1:
        return model_cfg
    if hasattr(model_cfg, "esm"):
        return dataclasses.replace(model_cfg, esm=tp_model_config(model_cfg.esm, mesh))
    return dataclasses.replace(model_cfg, model_axis=mesh.model_axis)


def tp_config(cfg: EngineConfig, mesh: Mesh) -> EngineConfig:
    """``cfg`` with its model on the mesh's model axis."""
    return dataclasses.replace(cfg, model=tp_model_config(cfg.model, mesh))


def gathered_loss(loss_fn: Callable, group=None) -> Callable:
    """loss(pep_local, rec_local): ``loss_fn`` over every rank's rows of the
    data ``group``."""
    return lambda pep, rec: loss_fn(gather_rows(pep, group), gather_rows(rec, group))


def local_chunks(num_chunks: int, b_local: int, mesh: Mesh) -> int:
    """Backbone microbatches of a rank's rows: the single-device count over
    the data axis, snapped to a divisor of the local batch."""
    return _snap_chunks(b_local, max(1, num_chunks // mesh.data))


def local_cfg(cfg: EngineConfig, b_local: int, mesh: Mesh, **changes) -> EngineConfig:
    """``cfg`` for the single-device machinery on one rank's rows: one
    bucket (or flat packs) of b_local pairs in ``local_chunks``, the
    backbone on the mesh's model axis (and ``changes``)."""
    return dataclasses.replace(tp_config(cfg, mesh), batch_size=b_local, accumulated_batches=1,
                               length_groups=1,
                               num_chunks=local_chunks(cfg.num_chunks, b_local, mesh), **changes)


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
    """An optimizer state whose ``apply`` first sums the model-partial
    gradients over the model group, then averages every gradient of its
    leaves over the data group; the state's clip reads the sharded tree's
    norm."""

    def __init__(self, state, mesh: Mesh, params):
        self.state, self.mesh = state, mesh
        self.leaves = state.leaves
        self.partial = []
        if mesh.model > 1:
            self.partial = tree_leaves(params["lora"]) if "lora" in params else []
            if hasattr(state, "sq_sum"):
                state.sq_sum = sharding.sharded_sq_sum(sharding.split_leaves(params), mesh)

    def apply(self) -> None:
        if self.partial:
            psum_grads(self.partial, self.mesh.model_group)
        pmean_grads(self.leaves, self.mesh.data_group)
        self.state.apply()


def on_rank(step: Callable, mesh: Mesh, b_local: int, packed: bool) -> Callable:
    """``step``, a single-device step over a rank's rows, on the mesh: the
    rank's batch checked (its rows, or its shard of the packed wire), its
    dropout from the generator of its data index, its gradients summed over
    the model group where they are partial and averaged over the data group
    before the optimizer applies them."""
    check = check_shard if packed else check_rows

    def mesh_step(params, opt_state, esm_params, batch, generator):
        check(batch, b_local)
        params, _, loss = step(params, _Averaged(opt_state, mesh, params), esm_params, batch,
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
                                         gathered_loss(default_loss_fn(), mesh.data_group))
    return on_rank(step, mesh, b_local, packed)


def make_sharded_eval_step(cfg: EngineConfig, mesh: Mesh, mode: str = "frozen",
                           packed: bool = False):
    """The CLIP eval step of ``mode`` over a rank's rows of a padded batch,
    or its shard of a packed one (any batch the data axis divides)."""
    b_local = local_batch_size(cfg.global_batch, mesh)
    step = ENGINES[mode].make_eval_step(local_cfg(cfg, b_local, mesh, packed=packed),
                                        gathered_loss(default_loss_fn(), mesh.data_group))
    if not packed:
        return step

    def shard_step(params, esm_params, batch):
        check_shard(batch, None)
        return step(params, esm_params, batch)

    return shard_step
