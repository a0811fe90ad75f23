"""Dual-encoder CLIP heads over one shared frozen ESM-2 backbone: the port
of ``protein_clip_tpu/models/clip.py`` (eval side).

Two head stacks (peptide ``pep`` / receptor ``rec``) plus a learnable scalar
temperature (init 1.0), kept apart from the backbone parameters.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils.device import resolve_device
from . import esm2, heads

Params = dict


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    input_dim: int = 640          # ESM-2 t30 hidden
    embedding_dim: int = 128
    h1: int = 2
    h2: int = 2
    dropout: float = 0.1          # training only
    # FFN activation: 'relu', 'tanh' or 'gelu'
    activation: str = "relu"
    esm: esm2.ESM2Config = dataclasses.field(default_factory=esm2.ESM2Config.t30_150M)


def init_params(cfg: CLIPConfig, generator: torch.Generator,
                dtype=torch.float32, device="cuda") -> Params:
    """Trainable head parameters (the backbone is initialised or loaded apart)."""
    device = resolve_device(device)
    return {
        "pep": heads.init_head(generator, cfg.input_dim, cfg.embedding_dim,
                               cfg.h1, cfg.h2, dtype, device),
        "rec": heads.init_head(generator, cfg.input_dim, cfg.embedding_dim,
                               cfg.h1, cfg.h2, dtype, device),
        "temperature": torch.tensor(1.0, dtype=dtype, device=device),
    }


def abstract_params(cfg: CLIPConfig, dtype=torch.float32) -> Params:
    """The head structure as meta tensors (shapes and dtypes, no data)."""
    return init_params(cfg, torch.Generator(), dtype, device="meta")


def encode_side(params: Params, side: str, hidden: torch.Tensor,
                mask: torch.Tensor, cfg: CLIPConfig) -> torch.Tensor:
    """Head pipeline for one side over precomputed backbone hidden states."""
    return heads.encode_pooled(params[side], hidden, mask, params["temperature"],
                               activation=cfg.activation)


def cosine_similarity_matrix(pep: torch.Tensor, rec: torch.Tensor,
                             temperature: torch.Tensor) -> torch.Tensor:
    """Raw cosine matrix: logits de-scaled by exp(-t)."""
    logits = torch.matmul(pep.float(), rec.float().T)
    return logits * torch.exp(-temperature.float())
