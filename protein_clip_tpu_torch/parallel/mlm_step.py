"""The MLM steps on the (data, model) mesh: the port of
``protein_clip_tpu/parallel/mlm_step.py`` (its six factories: the head's
train and eval steps, plain and packed, and the finetune and LoRA ones,
plain and packed).

One factory serves them all: the single-device step of the mode
(``train/mlm_engine.make_steps``) over a rank's shard, under the mesh's
wrapper (``step.on_rank``'s optimizer state):

- a rank's shard: its data index's rows of the plain (ids, mask) batch, or
  its rows of ``packed_engine.tokenize_packed_rows_sharded``'s wire
  (``rank_rows``); the packed and plain steps differ only there;
- masks drawn per data shard from the step's generator and the data index
  (``rank_masks``), the same on every model rank, as the TPU package folds
  the axis index into the step's key; a test feeds the TPU package's
  per-shard masks instead;
- the loss the global mean over every shard's masked positions: the
  (sum, count) terms summed over the data group before the divide
  (``global_mean``), so shards with more masked tokens weigh more;
- the trainable gradients averaged over the data group (each rank
  differentiates its copy of the global loss, so the sum's backward hands
  it data x its share), after the LoRA adapters' partial gradients are
  summed over the model group.

With a 'model' axis the backbone (or the finetune engine's f32 masters)
holds the rank's Megatron slices (``sharding.shard_params``) and its
config the mesh's model axis (``step.tp_model_config``); the LM head, tied
to the replicated token embedding, is replicated.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models import mlm
from ..train.mlm_engine import make_steps
from .distributed import global_sum
from .mesh import Mesh, rank_generator
from .step import _Averaged, tp_model_config


def global_mean(mesh: Mesh) -> Callable:
    """reduce(sum, count): the masked positions' mean over every data
    shard's, the terms summed over the data group."""
    def reduce(s: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        return global_sum(s, mesh.data_group) / global_sum(c, mesh.data_group).clamp(min=1.0)

    return reduce


def rank_rows(arrs: tuple, mesh: Mesh) -> tuple:
    """This rank's shard of a host batch: rows [i * n, (i + 1) * n) of every
    array for data index i (the plain (ids, mask) batch, or the packed
    wire's shard-major rows)."""
    n = arrs[0].shape[0]
    if n % mesh.data:
        raise ValueError(f"batch of {n} rows not divisible by data axis {mesh.data}")
    b = n // mesh.data
    return tuple(a[mesh.index * b:(mesh.index + 1) * b].contiguous() for a in arrs)


def rank_masks(generator: torch.Generator, inputs: dict, p: float, mesh: Mesh) -> tuple:
    """(masked ids, labels) of this rank's shard, drawn from a generator of
    the step's generator and the data index (``mesh.rank_generator``)."""
    return mlm.mask_tokens(rank_generator(generator, mesh.index), inputs["ids"], inputs["mask"],
                           p)


def make_sharded_mlm_steps(cfg, mesh: Mesh, mode: str = "head",
                           view: Callable | None = None) -> tuple[Callable, Callable]:
    """(train_step, eval_step) of ``mode`` ("head", "finetune", "lora") on
    the mesh, with the single-device steps' signatures over a rank's shard
    (``rank_rows``) and its masks (``rank_masks``): ``train_step(trainable,
    opt_state, esm_params, inputs, masks)`` and ``eval_step(trainable,
    esm_params, inputs, masks)``. ``view`` is the unfrozen modes' backbone
    view, built on ``tp_model_config(cfg, mesh)``."""
    train, evaluate = make_steps(tp_model_config(cfg, mesh), mode, view, global_mean(mesh))

    def train_step(trainable, opt_state, esm_params, inputs, masks):
        trainable, _, loss = train(trainable, _Averaged(opt_state, mesh, trainable), esm_params,
                                   inputs, masks)
        return trainable, opt_state, loss

    return train_step, evaluate
