"""Chunked encoding for contrastive training over a global batch: the port
of ``protein_clip_tpu/train/gradcache.py``.

- ``encode_hidden_chunked``: the frozen backbone runs once per global batch
  over microbatches with no graph, and only the small heads take part in
  autograd; that gives the reference's GradCache gradients at half its
  backbone work.
- ``gradcache_value_and_grad``: the two-pass form for an unfrozen encoder.
  Pass 1 encodes every chunk without a graph, the global loss is
  differentiated with respect to the concatenated embeddings only, and pass
  2 replays each chunk with a graph and feeds it its slice of those
  gradients, so the parameters' gradients accumulate chunk by chunk at one
  chunk's activation memory.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

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


def gradcache_value_and_grad(
    encode_fn: Callable[[Any, Any], torch.Tensor],
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    params: Any,
    chunks_x: Sequence[Any],
    chunks_y: Sequence[Any],
    encode_fn_y: Callable[[Any, Any], torch.Tensor],
) -> torch.Tensor:
    """Two-pass chunked contrastive gradients for an unfrozen encoder.

    ``encode_fn(params, chunk)`` -> (b, D) embeddings; ``loss_fn`` takes the
    two concatenated (B, D) embedding matrices. Returns the loss (detached);
    the gradients of the loss with respect to the parameters that
    ``encode_fn`` reaches accumulate into their ``.grad``, equal (up to the
    order of float sums) to those of the monolithic computation. Each
    chunk's encode must be a function of its chunk alone: pass 2 replays it
    and must reproduce pass 1 (the same dropout masks, for one).
    ``encode_fn`` encodes the x side and ``encode_fn_y`` the y side (a dual
    encoder: one backbone, per-side heads)."""
    sides = ((encode_fn, chunks_x), (encode_fn_y, chunks_y))
    with torch.no_grad():
        embs = [[fn(params, c) for c in chunks] for fn, chunks in sides]
    ex, ey = (torch.cat(e).requires_grad_(True) for e in embs)
    loss = loss_fn(ex, ey)
    grads = torch.autograd.grad(loss, (ex, ey))
    for (fn, chunks), e, g in zip(sides, embs, grads):
        for c, gc in zip(chunks, g.split([len(x) for x in e])):
            fn(params, c).backward(gc)
    return loss.detach()
