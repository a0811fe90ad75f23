"""The data-parallel unfrozen FILIP steps, finetune and LoRA, one bucket or
packed: the port of ``protein_clip_tpu/parallel/filip_finetune_step.py``.

Each rank runs the single-device token-level two-pass step on its own rows
(``train/filip_finetune.py``), with a tail of its own:

  pass 1   the rank's chunks through the backbone and the token heads with
           no graph: its normalised tokens (packed: its shard's rows);
  tail     the receptor side's (b_local, T, D) tokens and masks of every
           rank gathered (packed: after the scatter into one (b_local, L,
           D) buffer a side), the rank's rows of both direction matrices
           (K4 on the card), the global loss the sum of every rank's rows'
           terms; differentiated with respect to the parameters and the
           rank's tokens, the gather's backward bringing each rank's
           cotangents of a rank's tokens home;
  pass 2   the rank's own chunks again with a graph (remat, K5), fed their
           rows of those token gradients.

The gradients are averaged over the ranks (``step.on_rank``): every rank
differentiates its own copy of the global loss, whose sum's backward sums
the ranks' seeds, so the mean is the gradient of the one loss. LoRA runs
the same steps with the adapter merge as the backbone. With a 'model' axis
(one bucket only: the packed step refuses it, as the TPU package's does)
the backbone runs on the rank's Megatron slices and K4 keeps scoring the
replicated tokens.
"""

from __future__ import annotations

from typing import Callable

from ..ops.filip import filip_similarity_fused
from ..train import filip_finetune, finetune, lora
from ..train import packed_engine as pe
from ..train.clip_engine import EngineConfig
from ..train.filip_packed import _scatter_side
from .filip_step import gathered_similarity, mesh_row_loss
from .mesh import Mesh, local_batch_size
from .step import check_flat, local_cfg, on_rank, tp_config

Params = dict


def make_sharded_filip_finetune_step(cfg: EngineConfig, mesh: Mesh, *, packed: bool = False,
                                     lora_view: bool = False):
    """The dispatcher: one bucket or packed, the f32 master backbone or the
    adapter merge (into a rank's slices on a model axis) as the backbone
    view."""
    tp = tp_config(cfg, mesh)
    view = lora.esm_view(tp) if lora_view else finetune.esm_view(tp)
    if packed:
        return make_sharded_packed_filip_finetune_step(cfg, mesh, view)
    return make_sharded_plain_filip_finetune_step(cfg, mesh, view)


def make_sharded_plain_filip_finetune_step(cfg: EngineConfig, mesh: Mesh,
                                           view: Callable[[Params, Params], Params]):
    """The unfrozen FILIP step over a rank's rows of ``tokenize_pair_batch``
    batches of ``cfg.batch_size`` pairs, in ``step.local_chunks``."""
    sim = gathered_similarity(filip_similarity_fused, mesh.data_group)
    loss = mesh_row_loss(mesh, cfg.filip_use_dcl)
    b_local = local_batch_size(cfg.batch_size, mesh)
    encode_chunk, prepare, _ = filip_finetune._token_machinery(
        local_cfg(cfg, b_local, mesh), sim, cfg.filip_use_dcl, view)

    def tail(params, HA, HB, batch):
        return loss(*sim(HA, HB, batch["pep_mask"], batch["rec_mask"],
                         params["heads"]["temperature"]))

    def step(params, opt_state, esm_params, batch, generator):
        batch, chunks = prepare(batch, generator)
        loss = filip_finetune.token_passes(encode_chunk, tail, params, esm_params, batch, chunks)
        opt_state.apply()
        return params, opt_state, loss

    return on_rank(step, mesh, b_local, packed=False)


def make_sharded_packed_filip_finetune_step(cfg: EngineConfig, mesh: Mesh,
                                            view: Callable[[Params, Params], Params]):
    """The packed unfrozen FILIP step over a rank's shard of
    ``tokenize_packed_sharded`` batches of ``cfg.batch_size`` pairs (flat
    packing, no scatter tiers): the chunks take the same tokens on both
    sides, as on one device."""
    check_flat(cfg.packed_tiers)
    if mesh.model > 1:
        raise ValueError("packed sharding is DP-only; compose TP via the plain "
                         "make_sharded_plain_filip_finetune_step")
    sim = gathered_similarity(filip_similarity_fused, mesh.data_group)
    loss = mesh_row_loss(mesh, cfg.filip_use_dcl)
    b_local = local_batch_size(cfg.batch_size, mesh)
    chunk_tokens, prepare, _ = filip_finetune._packed_token_machinery(
        local_cfg(cfg, b_local, mesh), sim, cfg.filip_use_dcl, pe._default_rows_per_chunk(None),
        view)

    def tail(params, X, sides):
        (ha, ma, _), = _scatter_side(X["pep"], sides["pep"][2], None, b_local)
        (hb, mb, _), = _scatter_side(X["rec"], sides["rec"][2], None, b_local)
        return loss(*sim(ha, hb, ma, mb, params["heads"]["temperature"]))

    def step(params, opt_state, esm_params, batch, generator):
        sides = prepare(batch, generator)
        loss = filip_finetune.packed_token_passes(chunk_tokens, tail, params, esm_params, sides)
        opt_state.apply()
        return params, opt_state, loss

    return on_rank(step, mesh, b_local, packed=True)
