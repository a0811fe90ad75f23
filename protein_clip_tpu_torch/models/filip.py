"""FILIP late-interaction heads over the ESM-2 backbone, in eval mode: the
port of ``protein_clip_tpu/models/filip.py``.

Per-token embeddings from both sides, L2-normalised per token, then the
FILIP similarity: for each pair (i, j), the max over the other side's
tokens, averaged over one's own valid tokens, in both directions.

``filip_similarity`` is the plain version that materialises the
(A, B, TA, TB) score tensor, kept as the oracle;
``ops/filip.filip_similarity_fused`` computes the same scores through the
masked max-sim kernel without it. The grouped and mean-average variants and
``forward`` belong to FILIP training, which is a later slice.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils.device import resolve_device
from . import esm2, heads

Params = dict


@dataclasses.dataclass(frozen=True)
class FILIPConfig:
    input_dim: int = 640
    embedding_dim: int = 128
    h1: int = 2
    h2: int = 2
    dropout: float = 0.1          # training only
    activation: str = "relu"
    esm: esm2.ESM2Config = dataclasses.field(default_factory=esm2.ESM2Config.t30_150M)


def init_params(cfg: FILIPConfig, generator: torch.Generator,
                dtype=torch.float32, device="cuda") -> Params:
    """The two head stacks and the temperature (1.0). The head tree is the
    CLIP heads' tree, so the CLIP checkpoint loaders read it."""
    device = resolve_device(device)
    return {
        "pep": heads.init_head(generator, cfg.input_dim, cfg.embedding_dim,
                               cfg.h1, cfg.h2, dtype, device),
        "rec": heads.init_head(generator, cfg.input_dim, cfg.embedding_dim,
                               cfg.h1, cfg.h2, dtype, device),
        "temperature": torch.tensor(1.0, dtype=dtype, device=device),
    }


def encode_side_tokens(params: Params, side: str, hidden: torch.Tensor,
                       cfg: FILIPConfig) -> torch.Tensor:
    """Per-token embeddings (B, T, D), L2-normalised along D in f32."""
    x = heads.encode_tokens(params[side], hidden, activation=cfg.activation)
    x32 = x.float()
    return (x32 / x32.square().sum(-1, keepdim=True).sqrt()).to(x.dtype)


def filip_similarity(ha: torch.Tensor, hb: torch.Tensor, mask_a: torch.Tensor,
                     mask_b: torch.Tensor, temperature) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain FILIP score. ha (A, TA, D), hb (B, TB, D) normalised; masks
    (A, TA), (B, TB) {0, 1}. Returns (sim_a, sim_b), each (A, B).

    Scores are divided by t before the max, and a max over no valid token
    stays f32-min (it is not clamped to 0 as the kernel clamps it)."""
    mask_a = mask_a.bool()
    mask_b = mask_b.bool()
    scores = torch.einsum("atd,bsd->abts", ha.float(), hb.float())
    scores = scores / torch.as_tensor(temperature, dtype=torch.float32, device=scores.device)
    pair = mask_a[:, None, :, None] & mask_b[None, :, None, :]
    masked = torch.where(pair, scores, torch.finfo(torch.float32).min)
    s_a = masked.amax(3)                  # (A, B, TA): max over b-tokens
    s_b = masked.amax(2)                  # (A, B, TB): max over a-tokens

    def masked_mean(t, m, eps=1e-6):
        return torch.where(m, t, 0.0).sum(-1) / m.sum(-1).float().clamp(min=eps)

    return masked_mean(s_a, mask_a[:, None, :]), masked_mean(s_b, mask_b[None, :, :])
