"""The (data, model) mesh over the process group's ranks: the port of
``protein_clip_tpu/parallel/mesh.py``.

``data`` shards the batch: each rank encodes its rows, and the pooled
embeddings (CLIP) or the receptor side's tokens (FILIP) are gathered so the
InfoNCE negatives span the global batch. ``model`` (tensor parallelism over
the backbone) must be 1: it is not ported yet. The world is the mesh: one
rank a device, ``data * model`` ranks.
"""

from __future__ import annotations

import dataclasses

import torch

from . import distributed
from ..train.finetune import _chunk_seeds

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``data`` x ``model`` ranks; ``index`` is this rank's place on the
    data axis."""
    data: int
    model: int = 1
    index: int = 0

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}


def make_mesh(data: int | None = None, model: int = 1) -> Mesh:
    """The mesh of the process group's ranks (one rank and no group: a mesh
    of one). ``data`` defaults to the world size over ``model``."""
    if model != 1:
        raise NotImplementedError(
            f"not ported yet: a 'model' mesh axis of {model} (tensor parallelism, --tp): "
            "multi-device training beyond the data axis (ROADMAP queue 1: multi-device, TP)")
    n = distributed.world_size()
    data = n // model if data is None else data
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} ranks; the process "
                         f"group has {n}")
    return Mesh(data, model, distributed.rank() // model)


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    if global_batch % mesh.data:
        raise ValueError(f"global batch {global_batch} not divisible by data axis {mesh.data}")
    return global_batch // mesh.data


def rank_device(device_type: str, local_rank: int) -> torch.device:
    """A rank's device: ``cuda:<local rank>``, or the CPU."""
    return torch.device("cuda", local_rank) if device_type == "cuda" else torch.device("cpu")


def rank_generator(generator: torch.Generator | None, index: int) -> torch.Generator | None:
    """The dropout generator of the rank at ``index`` on the data axis, for
    one step: a seed drawn from the step's generator (the same draw on every
    rank) and the index, as the TPU package folds the axis index into the
    step's key. None without a generator."""
    if generator is None:
        return None
    seed = _chunk_seeds(generator, 1)[0][0]
    return torch.Generator(device=generator.device).manual_seed(
        (seed + 1_000_003 * (index + 1)) % 2 ** 63)
