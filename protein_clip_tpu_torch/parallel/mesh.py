"""The (data, model) mesh over the process group's ranks: the port of
``protein_clip_tpu/parallel/mesh.py``.

``data`` shards the batch: each rank encodes its rows, and the pooled
embeddings (CLIP) or the receptor side's tokens (FILIP) are gathered so the
InfoNCE negatives span the global batch. ``model`` shards the ESM-2
backbone the Megatron way (tensor parallelism, ``sharding.py``): each rank
of a model group holds its slice of the attention heads and FFN columns.
The world is the mesh: one rank a device, ``data * model`` ranks, rank r at
data index ``r // model`` and model index ``r % model``, as the TPU
package's ``reshape(data, model)`` of its devices lays them out.

Each mesh makes its process subgroups once, every rank every group in the
same order (``dist.new_group`` is collective): the data groups (the ranks
of one model index, over which batches are gathered and gradients
averaged) and the model groups (the ranks of one data index, over which a
layer's partial products are summed).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from . import distributed
from .distributed import ModelAxis
from ..train.finetune import _chunk_seeds

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``data`` x ``model`` ranks; ``index`` is this rank's place on the
    data axis, ``model_index`` on the model axis. ``data_group`` and
    ``model_group`` are this rank's process subgroups (None without a
    process group)."""
    data: int
    model: int = 1
    index: int = 0
    model_index: int = 0
    data_group: object = dataclasses.field(default=None, compare=False, repr=False)
    model_group: object = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def model_axis(self) -> ModelAxis | None:
        """The model axis the backbone's forward shards over, None at
        ``model`` 1 (the unsharded forward)."""
        if self.model == 1:
            return None
        return ModelAxis(self.model, self.model_index, self.model_group)


def check_model_axis(esm_cfg, model: int) -> None:
    """Raise ValueError unless ``model`` divides the backbone's heads and
    FFN width (the column-parallel splits)."""
    if model <= 1:
        return
    for what, n in (("num_heads", esm_cfg.num_heads),
                    ("FFN width (intermediate_size)", esm_cfg.intermediate_size)):
        if n % model:
            raise ValueError(f"the 'model' mesh axis of {model} (--tp) must divide the "
                             f"backbone's {what}, {n}")


def _subgroups(data: int, model: int) -> tuple[object, object]:
    """This rank's (data group, model group). With a model axis every rank
    makes every group, data groups first, in the same order; without one
    the data group is the world (None)."""
    if model == 1:
        return None, None
    me = distributed.rank()
    for m in range(model):
        g = dist.new_group([d * model + m for d in range(data)])
        if me % model == m:
            data_group = g
    for d in range(data):
        g = dist.new_group([d * model + m for m in range(model)])
        if me // model == d:
            model_group = g
    return data_group, model_group


def make_mesh(data: int | None = None, model: int = 1, esm_cfg=None) -> Mesh:
    """The mesh of the process group's ranks (one rank and no group: a mesh
    of one). ``data`` defaults to the world size over ``model``; with
    ``esm_cfg`` the model axis must divide its heads and FFN width."""
    if esm_cfg is not None:
        check_model_axis(esm_cfg, model)
    n = distributed.world_size()
    data = n // model if data is None else data
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} ranks; the process "
                         f"group has {n}")
    groups = _subgroups(data, model) if distributed.is_initialized() else (None, None)
    r = distributed.rank()
    return Mesh(data, model, r // model, r % model, *groups)


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
    step's key; the model ranks of a data index draw alike. None without a
    generator."""
    if generator is None:
        return None
    seed = _chunk_seeds(generator, 1)[0][0]
    return torch.Generator(device=generator.device).manual_seed(
        (seed + 1_000_003 * (index + 1)) % 2 ** 63)
