"""Flat-npz checkpoints, and the carry of the TPU package's parameters.

Parameters are nested dicts of tensors with the TPU package's layout: ESM-2
layers stacked on a leading layer axis, linear weights ``(in, out)``, CLIP
heads ``{pep, rec, temperature}``. An npz holds one array per leaf under
its ``/``-joined key path (``pep/aa_ffn/blocks/w``), the TPU package's
``train/checkpoint.export_npz`` format, so files written by either package
load in the other. numpy has no bfloat16: bf16 tensors are written as
float32, and a bfloat16 array that the TPU package wrote (two-byte void
dtype without ``ml_dtypes``) is read back bit for bit.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..utils.device import resolve_device


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    if isinstance(tree, dict):
        flat = {}
        for key in tree:
            flat.update(_flatten(tree[key], f"{prefix}{key}/"))
        return flat
    return {prefix[:-1]: tree}


def _map_like(like: Any, fn, prefix: str = "") -> Any:
    """``like``'s structure with each leaf replaced by fn(flat key, leaf);
    dict keys may hold ``/`` themselves (LoRA's ``attn/q``)."""
    if isinstance(like, dict):
        return {k: _map_like(v, fn, f"{prefix}{k}/") for k, v in like.items()}
    return fn(prefix[:-1], like)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(leaf)


def to_tensor(arr: np.ndarray, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """numpy -> tensor on ``device``; floating arrays take ``dtype`` when it
    is given."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V" and arr.dtype.itemsize == 2):
        # ml_dtypes.bfloat16, or its raw bits as numpy reads them without it
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        if not (arr.flags.writeable and arr.flags.c_contiguous):
            arr = np.array(arr, order="C")  # e.g. a read-only view of a JAX array
        t = torch.from_numpy(arr)
    t = t.to(device)
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def export_npz(path: str | Path, tree: Any) -> None:
    np.savez(path, **{k: _to_numpy(v) for k, v in _flatten(tree).items()})


def read_npz(path: str | Path) -> dict[str, np.ndarray]:
    """Every array of an npz, by flat key."""
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def load_npz(path: str | Path, like: Any, device="cuda") -> Any:
    """Load a flat npz into the structure of ``like`` (tensors, e.g. on the
    meta device): each leaf a tensor on ``device`` with the shape and dtype
    of the leaf it replaces."""
    device = resolve_device(device)
    data = read_npz(path)
    missing = set(_flatten(like)) - set(data)
    if missing:
        raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]} ...")

    def load(key, leaf):
        arr = data[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != {tuple(leaf.shape)}")
        return to_tensor(arr, device, leaf.dtype)

    return _map_like(like, load)


def from_numpy_tree(tree: Any, device="cuda", dtype: torch.dtype | None = None) -> Any:
    """Carry a parameter pytree of the TPU package, as numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)``), into the port's parameters on
    ``device``; floating leaves take ``dtype`` when it is given. The layouts
    are the same, so after the carry both packages compute the same thing."""
    device = resolve_device(device)

    def carry(node):
        if isinstance(node, dict):
            return {k: carry(v) for k, v in node.items()}
        return to_tensor(node, device, dtype)

    return carry(tree)
