"""LoRA, parameter-efficient finetuning of the ESM-2 backbone: the port of
``protein_clip_tpu/train/lora.py`` (its plain path).

Low-rank adapters (Hu et al. 2021) on the attention projection weights, and
optionally the FFN's: each stacked weight W (L, H, O) gains trainable f32
A (L, H, r) and B (L, r, O), B zero at init, and the model runs on the
effective weights W + (alpha / r) A.B. Zero-init makes step 0 exactly the
frozen model.

``merge_lora`` makes the effective weights with one batched einsum over the
layer axis, inside each chunk's graph, and the unchanged ``esm2.forward``
(K1 and K5 on the card) runs on them; autograd chains through the merge to
A and B. The frozen base stays in the compute dtype in the step's
``esm_params`` slot and gets no gradient buffers. What LoRA saves is
optimizer state, not backward work: the backward still forms each layer's
dense weight gradient to reach A and B.

Params: ``{"lora": {"attn/q": {"a", "b"}, ...}, "heads": <clip params>}``.
Two learning rates (``make_optimizer``): heads at ``cfg.learning_rate``,
adapters at ``cfg.backbone_lr`` (default 1e-4). With ``cfg.packed`` the step
is the packed finetune step (``finetune.make_train_step_packed``, flat
packing) with the adapter merge as its backbone.
"""

from __future__ import annotations

import math
import os
from typing import Any, Callable

import torch

from . import finetune, optimizer as opt_mod
from .clip_engine import EngineConfig, default_loss_fn, make_eval_step as _eval
from .finetune import _check_plain, _two_pass_step

Params = dict[str, Any]

# attention-only is the classic LoRA recipe; "wi"/"wo" extend to the FFN
ATTN_TARGETS = ("q", "k", "v", "o")
FFN_TARGETS = ("wi", "wo")


def _target_leaves(esm_params: Params, targets) -> dict[str, torch.Tensor]:
    layers = esm_params["layers"]
    out = {}
    for t in targets:
        group = "attn" if t in ATTN_TARGETS else "ffn"
        out[f"{group}/{t}"] = layers[group][t]["w"]
    return out


def init_lora(generator: torch.Generator, esm_params: Params, rank: int = 8,
              targets=ATTN_TARGETS) -> Params:
    """A ~ N(0, 1/rank) and B = 0, both f32 on the base's device, so the
    initial model is the frozen one exactly; per-layer matrices ride the
    stacked layer axis."""
    out = {}
    for name, w in _target_leaves(esm_params, targets).items():
        L, H, O = w.shape
        a = torch.randn((L, H, rank), generator=generator, device=generator.device)
        out[name] = {"a": (a / math.sqrt(rank)).to(w.device),
                     "b": torch.zeros((L, rank, O), device=w.device)}
    return out


def _rank_slice(ab: Params, w: torch.Tensor, model_axis) -> tuple[torch.Tensor, torch.Tensor]:
    """(A, B) of the delta of this rank's slice of W under tensor
    parallelism: a column-parallel W (q, k, v, wi: its out axis split)
    takes B's columns of the rank, a row-parallel one (o, wo) A's rows; the
    adapters themselves stay whole (replicated), so their gradient on each
    model rank is its slice's share (summed over the model group by the
    mesh step)."""
    a, b = ab["a"], ab["b"]
    if model_axis is not None:
        i = model_axis.index
        if b.shape[-1] != w.shape[-1]:
            n = w.shape[-1]
            b = b[..., i * n:(i + 1) * n]
        if a.shape[-2] != w.shape[-2]:
            n = w.shape[-2]
            a = a[:, i * n:(i + 1) * n]
    return a, b


def merge_lora(esm_params: Params, lora: Params, alpha: float, model_axis=None) -> Params:
    """Effective weights W + (alpha / r) A.B, batched over the layer axis
    with f32 accumulation and cast to W's dtype; the other leaves are the
    base's own tensors. With ``model_axis`` (``parallel.mesh.Mesh.
    model_axis``) the base holds this rank's Megatron slices, and only
    their part of each delta is formed."""
    layers = {k: dict(v) for k, v in esm_params["layers"].items()}
    for name, ab in lora.items():
        group, t = name.split("/")
        w = layers[group][t]["w"]
        r = ab["a"].shape[-1]
        a, b = _rank_slice(ab, w, model_axis)
        delta = torch.einsum("lhr,lro->lho", a.float(), b.float())
        layers[group][t] = {**layers[group][t], "w": w + (alpha / r * delta).to(w.dtype)}
    return {**esm_params, "layers": layers}


def init_params(lora: Params, head_params: Params) -> Params:
    return {"lora": lora, "heads": head_params}


def make_optimizer(cfg: EngineConfig) -> opt_mod.MultiOptimizer:
    """Two groups: heads at cfg.learning_rate, adapters at cfg.backbone_lr
    (default 1e-4: zero-init adapters take a hotter rate than a full
    backbone); cfg.grad_clip clips the whole tree."""
    ad_lr = cfg.backbone_lr if cfg.backbone_lr is not None else 1e-4
    return opt_mod.multi_transform({"lora": opt_mod.from_config(cfg, lr=ad_lr, grad_clip=0.0),
                                    "heads": opt_mod.from_config(cfg, grad_clip=0.0)},
                                   grad_clip=cfg.grad_clip)


def default_alpha(rank: int) -> float:
    """The alpha of a rank-``rank`` adapter set: PCT_LORA_ALPHA if set,
    else 2 * rank. The engines and the checkpoint loader both resolve it
    here, so serving uses the alpha the model trained with."""
    env = os.environ.get("PCT_LORA_ALPHA")
    return float(env) if env is not None else 2.0 * rank


def esm_view(cfg: EngineConfig) -> Callable[[Params, Params], Params]:
    """(params, esm_params) -> the backbone a chunk runs on: the adapters
    merged into the frozen base inside the graph, at ``default_alpha`` of
    their rank (into a rank's slices where the config's backbone has a
    model axis)."""
    def view(params, esm_params):
        rank = next(iter(params["lora"].values()))["a"].shape[-1]
        return merge_lora(esm_params, params["lora"], default_alpha(rank),
                          cfg.model.esm.model_axis)

    return view


def make_train_step(cfg: EngineConfig, loss_fn: Callable | None = None):
    """The LoRA step: (params, opt_state, esm_params, batch, generator) ->
    (params, opt_state, loss), with esm_params the frozen compute-dtype
    base and ``opt_state`` from ``make_optimizer(cfg).init(params)``; with
    ``cfg.packed`` over ``tokenize_packed`` batches."""
    if cfg.packed:
        return make_train_step_packed(cfg, loss_fn)
    _check_plain(cfg, "LoRA")
    return _two_pass_step(cfg, loss_fn or default_loss_fn(), esm_view(cfg))


def make_train_step_packed(cfg: EngineConfig, loss_fn: Callable | None = None,
                           rows_per_chunk: int | None = None):
    """The packed LoRA step: the packed finetune step with the adapters
    merged into the frozen base inside each chunk's graph, so gradients
    reach only the adapters and the heads."""
    return finetune.make_train_step_packed(cfg, loss_fn, rows_per_chunk, esm_view(cfg))


def make_eval_step(cfg: EngineConfig, loss_fn: Callable | None = None):
    """The frozen engine's eval step on the merged weights."""
    base = _eval(cfg, loss_fn)
    view = esm_view(cfg)

    def step(params, esm_params, batch):
        with torch.no_grad():
            merged = view(params, esm_params)
        return base(params["heads"], merged, batch)

    return step
