"""Projection heads over the ESM-2 backbone, in eval mode: the port of
``protein_clip_tpu/models/heads.py``.

    esm last_hidden_state (B, T, 640)
      -> Linear 640 -> 128 (projection)
      -> per-token FFN  [ (Linear, act, LayerNorm) x (h1 - 1), Linear ]
      -> masked mean over tokens
      -> pooled FFN     [ same structure, depth h2 ]
      -> L2 normalise * exp(temperature / 2)

Parameters are the TPU package's head dict: ``projection {w, b}`` and two
FFNs whose hidden blocks are stacked on a leading depth axis. Dropout is
the identity in eval mode; training (and with it dropout) is a later slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.device import resolve_device

Params = dict


def _uniform_linear(generator: torch.Generator, fan_in: int, fan_out: int,
                    dtype, device) -> Params:
    """torch.nn.Linear's default: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / (fan_in ** 0.5)

    def u(*shape):
        t = (torch.rand(shape, generator=generator, device=generator.device) * 2 - 1) * bound
        return t.to(device=device, dtype=dtype)

    return {"w": u(fan_in, fan_out), "b": u(fan_out)}


def init_ffn(generator: torch.Generator, dim: int, depth: int,
             dtype=torch.float32, device="cuda") -> Params:
    """(Linear -> act -> LayerNorm) x (depth - 1) + Linear."""
    device = resolve_device(device)
    n = depth - 1
    blocks = [_uniform_linear(generator, dim, dim, dtype, device) for _ in range(n)]
    stacked = {
        "w": (torch.stack([b["w"] for b in blocks]) if n
              else torch.zeros((0, dim, dim), dtype=dtype, device=device)),
        "b": (torch.stack([b["b"] for b in blocks]) if n
              else torch.zeros((0, dim), dtype=dtype, device=device)),
        "ln_w": torch.ones((n, dim), dtype=dtype, device=device),
        "ln_b": torch.zeros((n, dim), dtype=dtype, device=device),
    }
    return {"blocks": stacked,
            "out": _uniform_linear(generator, dim, dim, dtype, device)}


def init_head(generator: torch.Generator, input_dim: int, embedding_dim: int,
              h1: int, h2: int, dtype=torch.float32, device="cuda") -> Params:
    device = resolve_device(device)
    return {
        "projection": _uniform_linear(generator, input_dim, embedding_dim, dtype, device),
        "aa_ffn": init_ffn(generator, embedding_dim, h1, dtype, device),
        "emb_ffn": init_ffn(generator, embedding_dim, h2, dtype, device),
    }


def _layer_norm(x, w, b, eps=1e-5):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    return (((x32 - mu) * torch.rsqrt(var + eps)) * w + b).to(x.dtype)


ACTIVATIONS = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
}


def apply_ffn(params: Params, x: torch.Tensor, activation: str = "relu") -> torch.Tensor:
    """The hidden blocks in turn, then the output linear (eval mode)."""
    blocks = params["blocks"]
    act = ACTIVATIONS[activation]
    for i in range(blocks["w"].shape[0]):
        x = torch.matmul(x, blocks["w"][i]) + blocks["b"][i]
        x = _layer_norm(act(x), blocks["ln_w"][i], blocks["ln_b"][i])
    out = params["out"]
    return torch.matmul(x, out["w"]) + out["b"]


def masked_mean(h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """sum(h * mask) / clamp(count, 1) over the token axis."""
    mask_f = mask.to(h.dtype)
    s = (h * mask_f[..., None]).sum(-2)
    cnt = mask_f.sum(-1, keepdim=True).clamp(min=1.0)
    return s / cnt


def encode_pooled(params: Params, hidden: torch.Tensor, mask: torch.Tensor,
                  temperature: torch.Tensor, activation: str = "relu") -> torch.Tensor:
    """Full head pipeline -> scaled pooled embedding (B, D)."""
    proj = params["projection"]
    x = torch.matmul(hidden, proj["w"]) + proj["b"]
    x = apply_ffn(params["aa_ffn"], x, activation)
    pooled = apply_ffn(params["emb_ffn"], masked_mean(x, mask), activation)
    sq = pooled.float().square().sum(-1, keepdim=True).to(pooled.dtype)
    normed = pooled * torch.rsqrt(sq + torch.finfo(torch.float32).tiny)
    return normed * torch.exp(temperature.to(normed.dtype) / 2.0)
