"""Flat-npz checkpoints, HF checkpoint directories, and the carry of the
TPU package's parameters.

Parameters are nested dicts of tensors with the TPU package's layout: ESM-2
layers stacked on a leading layer axis, linear weights ``(in, out)``, CLIP
heads ``{pep, rec, temperature}``. An npz holds one array per leaf under
its ``/``-joined key path (``pep/aa_ffn/blocks/w``), the TPU package's
``train/checkpoint.export_npz`` format, so files written by either package
load in the other. numpy has no bfloat16: bf16 tensors are written as
float32, and a bfloat16 array that the TPU package wrote (two-byte void
dtype without ``ml_dtypes``) is read back bit for bit.

``read_hf_checkpoint`` reads the tensors of a HF ESM-2 checkpoint directory
(``model.safetensors`` or ``pytorch_model.bin``, either sharded) without the
``transformers`` and ``safetensors`` packages.

``save_train_state`` and ``load_train_state`` keep a run's train state for
``train/loop.fit(resume=True)``: the port's own format (``torch.save``,
read back with ``weights_only=True``), since the TPU package's Orbax
snapshots need Orbax; neither package reads the other's.
"""

from __future__ import annotations

import json
import os
import re
import struct
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..utils.device import resolve_device
from .optimizer import check_layout, tree_items


def _flatten(tree: Any) -> dict[str, Any]:
    return dict(tree_items(tree))


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
    is given, cast on the host, so the device holds the leaf once and in
    ``dtype`` only."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V" and arr.dtype.itemsize == 2):
        # ml_dtypes.bfloat16, or its raw bits as numpy reads them without it
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        if not (arr.flags.writeable and arr.flags.c_contiguous):
            arr = np.array(arr, order="C")  # e.g. a read-only view of a JAX array
        t = torch.from_numpy(arr)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


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


# ---------------------------------------------------------------------------
# Train-state snapshots
# ---------------------------------------------------------------------------

def _on_host(tree: Any) -> dict[str, torch.Tensor]:
    """A tree's tensors by flat key, copied to the host."""
    return {k: v.detach().to("cpu", copy=True) for k, v in _flatten(tree).items()}


def save_train_state(path: str | Path, state: dict) -> None:
    """Write a train state: ``params`` and ``best_params`` (trees of
    tensors, saved by flat key), ``opt_state`` (an optimizer state's
    ``state_dict()``, on the host), ``best_val`` and the loss lists (plain
    numbers), and ``tiers`` when given (the packer's sticky tier caches,
    ``packed_engine.tier_state``: lists of strings and ints); tensors are
    copied to the host. The
    file is written under a temporary name beside ``path`` and renamed into
    place, so a write cut short never replaces a readable snapshot."""
    path = Path(path)
    out = {"params": _on_host(state["params"]), "best_params": _on_host(state["best_params"]),
           "opt_state": state["opt_state"], "best_val": float(state["best_val"]),
           "train_losses": [float(v) for v in state["train_losses"]],
           "val_losses": [float(v) for v in state["val_losses"]]}
    if "tiers" in state:
        out["tiers"] = state["tiers"]
    tmp = path.with_name(path.name + ".tmp")
    torch.save(out, tmp)
    os.replace(tmp, path)


def load_train_state(path: str | Path, device="cuda") -> dict:
    """``save_train_state``'s dict with every tensor on ``device``; params
    and best params by flat key (``load_into`` puts them into a tree)."""
    return torch.load(path, map_location=resolve_device(device), weights_only=True)


def load_into(tree: Any, flat: dict[str, torch.Tensor], what: str = "params") -> None:
    """Copy ``flat`` (a saved tree by flat key) into ``tree``'s tensors in
    place; a tree of other keys or shapes raises ValueError naming them."""
    check_layout(f"saved {what}", {k: list(v.shape) for k, v in _flatten(tree).items()},
                 {k: list(v.shape) for k, v in flat.items()})
    with torch.no_grad():
        for k, leaf in _flatten(tree).items():
            leaf.copy_(flat[k])


def tree_like(tree: Any, flat: dict[str, torch.Tensor]) -> Any:
    """``tree``'s structure holding ``flat``'s tensors (by flat key)."""
    return _map_like(tree, lambda key, leaf: flat[key])


# ---------------------------------------------------------------------------
# HF checkpoint directories
# ---------------------------------------------------------------------------

# Tensors of a HF ESM-2 checkpoint that the backbone does not read (keys
# without the ``esm.`` prefix): the MLM and contact heads, a pooler, the
# rotary tables (recomputed) and the position ids.
HF_IGNORED = re.compile(r"^(lm_head\.|contact_head\.|pooler\.|embeddings\.position_ids$)"
                        r"|\.rotary_embeddings\.inv_freq$")
# the floating dtypes of a checkpoint's tensors (BF16 is read through torch)
_SAFETENSORS_DTYPES = {"F32": np.float32, "F16": np.float16, "BF16": None}


def _wanted(key: str, lm_head: bool) -> bool:
    return not HF_IGNORED.search(key) or (lm_head and key.startswith("lm_head."))


def read_safetensors(path: str | Path, keep=lambda key: True) -> dict[str, np.ndarray]:
    """The tensors of a ``.safetensors`` file whose names ``keep`` takes, as
    numpy arrays in their stored dtype (bf16 as float32, exactly); a kept
    tensor of another dtype than F32, F16 or BF16 raises. The file is an
    8-byte little-endian header length, a JSON header ({name: {dtype, shape,
    data_offsets}}, offsets from the end of the header) and the raw
    little-endian bytes."""
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        start = 8 + n
        for key, info in header.items():
            if key == "__metadata__" or not keep(key):
                continue
            if info["dtype"] not in _SAFETENSORS_DTYPES:
                raise ValueError(f"{path}: {key} has dtype {info['dtype']}, not a float one")
            lo, hi = info["data_offsets"]
            f.seek(start + lo)
            raw = bytearray(f.read(hi - lo))
            if info["dtype"] == "BF16":
                arr = torch.frombuffer(raw, dtype=torch.int16).view(torch.bfloat16).float().numpy()
            else:
                arr = np.frombuffer(raw, dtype=np.dtype(_SAFETENSORS_DTYPES[info["dtype"]])
                                    .newbyteorder("<"))
            out[key] = arr.reshape(info["shape"])
    return out


def _read_bin(path: Path, keep) -> dict[str, np.ndarray]:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float().numpy() for k, v in sd.items() if keep(k)}


def _checkpoint_files(path: Path) -> list[Path]:
    """The weight files of a HF checkpoint directory: safetensors before
    ``pytorch_model.bin`` (``from_pretrained``'s order), one file or the
    shards its ``*.index.json`` maps."""
    for name in ("model.safetensors", "pytorch_model.bin"):
        index = path / f"{name}.index.json"
        if index.exists():
            weight_map = json.loads(index.read_text())["weight_map"]
            return [path / f for f in dict.fromkeys(weight_map.values())]
        if (path / name).exists():
            return [path / name]
    raise FileNotFoundError(f"{path} holds no model.safetensors or pytorch_model.bin "
                            "(nor a sharded index of either): not a HF checkpoint directory")


def read_hf_checkpoint(path: str | Path, lm_head: bool = False) -> dict[str, np.ndarray]:
    """The state dict a HF ESM-2 checkpoint directory holds, as
    ``EsmModel.from_pretrained(path, add_pooling_layer=False).state_dict()``
    gives it to the TPU package's ``load_esm``: keys without the ``esm.``
    prefix, floating tensors in f32 (stored bf16 and f16 upcast). Tensors
    the backbone does not read (``HF_IGNORED``) are left out, the MLM head's
    kept with ``lm_head``. Reads ``model.safetensors`` by hand and
    ``pytorch_model.bin`` with ``torch.load(weights_only=True)``, sharded or
    not; neither ``transformers`` nor ``safetensors`` is needed."""
    path = Path(path)
    if not path.is_dir():
        raise FileNotFoundError(f"{path} is not a HF checkpoint directory")

    def keep(key):
        return _wanted(key.removeprefix("esm."), lm_head)

    out: dict[str, np.ndarray] = {}
    for f in _checkpoint_files(path):
        part = read_safetensors(f, keep) if f.suffix == ".safetensors" else _read_bin(f, keep)
        # stored bf16 and f16 upcast, as from_pretrained loads them into an f32 model
        out.update({k.removeprefix("esm."): v.astype(np.float32, copy=False)
                    for k, v in part.items()})
    return out
