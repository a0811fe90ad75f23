"""Tensor-parallel layout of the ESM-2 backbone over the mesh's 'model'
axis: the port of ``protein_clip_tpu/parallel/sharding.py``.

The Megatron split on the stacked-layer tree (leading axis the layer):

- attention q, k, v and FFN wi: column-parallel, the out axis split (``w``
  and ``w_q`` on their last axis, ``w_s`` and ``b`` too): a rank holds
  NH / model heads and 4H / model FFN columns;
- attention o and FFN wo: row-parallel, the in axis split (``w`` and
  ``w_q``); ``w_s`` and ``b`` replicated (the bias is added after the
  partial products are summed, the int8 dequant needs the whole scale row);
- embeddings, LayerNorms and the heads: replicated.

A spec is the axis a leaf is split on, or None where it is replicated, and
follows from the leaf's path alone, so the same rule reads the backbone,
the finetune engine's ``{"esm": ..., "heads": ...}`` and an optimizer
state's leaf names. ``shard_params`` keeps only this rank's slice of each
split leaf (a copy of its own, so the full weight can be freed: the memory
is the point of tensor parallelism); ``gather_params`` rebuilds the
canonical one-device tree over the model group, for exports, snapshots and
evals. ``shard_opt_state`` and ``gather_opt_state`` do the same for an
optimizer state's moments, so a snapshot is written in the one-device
layout whatever the mesh.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from ..train.optimizer import tree_items, tree_leaves
from . import distributed
from .mesh import Mesh

COLUMN = ("q", "k", "v", "wi")
ROW = ("o", "wo")


def leaf_spec(path: str) -> int | None:
    """The axis the leaf at ``path`` ("esm/layers/attn/q/w", ...) is split
    on over the model axis, counted from the end (-1 out, -2 in), or None
    where it is replicated."""
    parts = path.split("/")
    if len(parts) < 4 or parts[-4] != "layers" or parts[-3] not in ("attn", "ffn"):
        return None
    lin, leaf = parts[-2], parts[-1]
    if lin in COLUMN and leaf in ("w", "w_q", "w_s", "b"):
        return -1
    if lin in ROW and leaf in ("w", "w_q"):
        return -2
    return None


def esm_param_specs(tree: Any, prefix: str = "") -> Any:
    """The spec of every leaf of a tree, on the same tree."""
    if isinstance(tree, dict):
        return {k: esm_param_specs(v, f"{prefix}{k}/") for k, v in tree.items()}
    return leaf_spec(prefix[:-1])


def head_param_specs(tree: Any) -> Any:
    """The heads are replicated: None at every leaf."""
    if isinstance(tree, dict):
        return {k: head_param_specs(v) for k, v in tree.items()}
    return None


def _map(tree: Any, fn, prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn, f"{prefix}{k}/") for k, v in tree.items()}
    return fn(prefix[:-1], tree)


def shard_leaf(t: torch.Tensor, axis: int | None, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of ``t`` on ``axis`` (a copy of its own), or ``t``
    where it is replicated or the model axis is 1."""
    if axis is None or mesh.model == 1:
        return t
    n = t.shape[axis]
    if n % mesh.model:
        raise ValueError(f"a tensor of shape {tuple(t.shape)} does not split over a 'model' "
                         f"axis of {mesh.model} on its axis {axis}")
    part = n // mesh.model
    return t.narrow(axis, mesh.model_index * part, part).clone()


def gather_leaf(t: torch.Tensor, axis: int | None, mesh: Mesh) -> torch.Tensor:
    """Every model rank's slice of ``t`` joined on ``axis`` in model order
    (collective over the model group), or ``t`` where it is replicated."""
    if axis is None or mesh.model == 1:
        return t
    t = t.detach().contiguous()
    out = t.new_empty((mesh.model * t.shape[0], *t.shape[1:]))
    distributed._all_gather(out, t, mesh.model_group)
    return torch.cat(out.view(mesh.model, *t.shape).unbind(0), dim=axis)


def shard_params(mesh: Mesh, tree: Any) -> Any:
    """``tree`` with every split leaf cut to this rank's slice (the
    canonical layout in, the rank's out); replicated leaves are the tree's
    own tensors."""
    return _map(tree, lambda path, t: shard_leaf(t, leaf_spec(path), mesh))


def gather_params(mesh: Mesh, tree: Any) -> Any:
    """The inverse of ``shard_params``: the canonical (L, in, out) tree from
    every model rank's slices. Every rank of the model group must call it."""
    with torch.no_grad():
        return _map(tree, lambda path, t: gather_leaf(t, leaf_spec(path), mesh))


def _opt_leaves(state: dict, prefix: str, fn) -> dict:
    """An ``OptState.state_dict()`` with ``fn(path, tensor)`` applied to each
    moment of a leaf (Adam's scalar ``step`` kept) and its ``shapes`` made
    to agree."""
    leaves = {name: {k: (fn(prefix + name, v) if v.dim() else v) for k, v in st.items()}
              for name, st in state["leaves"].items()}
    shapes = dict(state["shapes"])
    for name, st in leaves.items():
        for v in st.values():
            if v.dim():
                shapes[name] = list(v.shape)
    return {**state, "leaves": leaves, "shapes": shapes}


def _map_opt_state(state: dict, fn, prefix: str) -> dict:
    if "groups" in state:
        return {"groups": {g: _opt_leaves(s, f"{prefix}{g}/", fn)
                           for g, s in state["groups"].items()}}
    return _opt_leaves(state, prefix, fn)


def gather_opt_state(mesh: Mesh, state: dict, prefix: str = "") -> dict:
    """An optimizer ``state_dict()`` of a sharded tree in the one-device
    layout (every moment of a split leaf gathered over the model group;
    ``prefix`` is the tree's path above the state's leaf names). Every
    model rank must call it."""
    if mesh.model == 1:
        return state
    # a leaf that never had a gradient has no moments on any rank, so the
    # ranks gather the same leaves
    return _map_opt_state(
        state, lambda path, v: gather_leaf(v.to(_device(mesh)), leaf_spec(path), mesh).cpu(),
        prefix)


def shard_opt_state(mesh: Mesh, state: dict, prefix: str = "") -> dict:
    """The inverse of ``gather_opt_state``: a one-device layout optimizer
    state cut to this rank's slices."""
    if mesh.model == 1:
        return state
    return _map_opt_state(state, lambda path, v: shard_leaf(v, leaf_spec(path), mesh), prefix)


def _device(mesh: Mesh) -> torch.device:
    """The device the model group's collectives take: the CPU under gloo,
    the rank's card under NCCL."""
    if dist.get_backend(mesh.model_group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def nbytes(tree: Any) -> int:
    """The bytes of a tree's tensors (a rank's share of a sharded tree)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def split_leaves(tree: Any) -> list[torch.Tensor]:
    """The tensors of ``tree`` that are split over the model axis."""
    return [t for path, t in tree_items(tree) if leaf_spec(path) is not None]


def sharded_sq_sum(split: list[torch.Tensor], mesh: Mesh):
    """The clip's squared global norm of a tree whose ``split`` leaves are a
    rank's slices: their squares summed over the model group, the
    replicated leaves' counted once (they are equal on every model rank)."""
    ids = {id(t) for t in split}

    def sq_sum(leaves: list[torch.Tensor]) -> torch.Tensor:
        grads = [(id(t) in ids, t.grad) for t in leaves if t.grad is not None]
        zero = grads[0][1].new_zeros((), dtype=torch.float32)
        part = sum((g.float().square().sum() for s, g in grads if s), zero)
        rest = sum((g.float().square().sum() for s, g in grads if not s), zero)
        return distributed.all_sum(part, mesh.model_axis) + rest

    return sq_sum
