"""Chunked frozen-backbone encoding: the port of
``protein_clip_tpu/train/gradcache.encode_hidden_chunked``.

The backbone is frozen, so it runs once per global batch over microbatches
with no graph, and only the small heads take part in autograd; that gives
the reference's GradCache gradients at half its backbone work. The two-pass
``gradcache_value_and_grad`` of the TPU package serves unfrozen encoders
and is not ported yet (ROADMAP queue 1: the unfrozen modes).
"""

from __future__ import annotations

import torch

from ..models import esm2


def encode_hidden_chunked(esm_params: dict, ids: torch.Tensor, mask: torch.Tensor,
                          cfg: esm2.ESM2Config, num_chunks: int) -> torch.Tensor:
    """Frozen-backbone hidden states (B, T, H) in the compute dtype, from
    ``num_chunks`` backbone forwards of B / num_chunks rows each. Runs under
    ``torch.no_grad``, not ``inference_mode``: the heads' autograd saves
    these tensors for backward, which inference tensors refuse."""
    B = ids.shape[0]
    if B % num_chunks:
        raise ValueError(f"batch {B} not divisible by num_chunks {num_chunks}")
    with torch.no_grad():
        return torch.cat([esm2.forward(esm_params, i, m, cfg)
                          for i, m in zip(ids.chunk(num_chunks), mask.chunk(num_chunks))])
