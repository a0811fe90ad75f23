"""Masked-language-model objective over the shared ESM-2 stack: the port of
``protein_clip_tpu/models/mlm.py``.

The reference explores MLM in a notebook (character-level masking with '.',
ESM vocab id 29, and a sweep of the fraction of token ids each masking
probability changes) and frames it as an objective over the same encoder.
Here: string- and token-level masking, and the masked cross-entropy
through ``esm2.lm_logits`` (the ESM LM head with its decoder tied to the
token embedding), plain or over packed rows.

``mask_sequence`` and ``changed_fraction`` are pure Python and NumPy and
give the TPU package's results to the bit for the same ``random.Random``;
``mask_tokens`` draws from an explicit ``torch.Generator`` on the ids'
device, so its masks are the port's own (a JAX key's draws cannot be
repeated here): tests feed both packages the same masks.
"""

from __future__ import annotations

import random

import numpy as np
import torch
import torch.nn.functional as F

from ..data.tokenizer import CLS_ID, EOS_ID, MASK_ID, PAD_ID
from . import esm2

IGNORE = -100   # the label of a position the loss does not read


def mask_sequence(seq: str, p: float, mask_char: str = ".",
                  rng: random.Random | None = None) -> str:
    """Each residue replaced by ``mask_char`` with probability p, one draw
    of ``rng`` (the module's ``random`` when None) per residue."""
    rng = rng or random
    return "".join(mask_char if rng.random() < p else c for c in seq)


def changed_fraction(ids_orig, ids_masked, mask) -> float:
    """The fraction of valid token ids that masking changed."""
    valid = np.asarray(mask).astype(bool)
    diff = (np.asarray(ids_orig) != np.asarray(ids_masked)) & valid
    return float(diff.sum() / max(valid.sum(), 1))


def mask_tokens(generator: torch.Generator, input_ids: torch.Tensor,
                attention_mask: torch.Tensor, p: float,
                mask_token_id: int = MASK_ID) -> tuple[torch.Tensor, torch.Tensor]:
    """Token-level masking for training: each valid position that is not
    <pad>, <cls> or <eos> becomes <mask> with probability p (one uniform
    draw of ``generator`` a position, on its device). Returns (masked ids,
    labels): the labels hold the original id where masked, else -100."""
    ids = input_ids.to(torch.int32)
    special = (ids == PAD_ID) | (ids == CLS_ID) | (ids == EOS_ID)
    eligible = (attention_mask > 0) & ~special
    draws = torch.rand(ids.shape, generator=generator, device=generator.device)
    chosen = (draws.to(ids.device) < p) & eligible
    return (torch.where(chosen, mask_token_id, ids),
            torch.where(chosen, ids, IGNORE))


def mlm_loss_terms(esm_params, lm_head, masked_ids: torch.Tensor,
                   attention_mask: torch.Tensor, labels: torch.Tensor, cfg: esm2.ESM2Config,
                   remat: bool = False, segment_ids: torch.Tensor | None = None,
                   positions: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of the cross-entropy at masked positions, their count), both f32:
    the backbone over the masked ids (segment-masked attention, RoPE
    restarts and per-segment token-dropout ratios on packed rows), the LM
    head's f32 logits, an f32 log-softmax; labels -100 are left out."""
    hidden = esm2.forward(esm_params, masked_ids, attention_mask, cfg, remat=remat,
                          segment_ids=segment_ids, positions=positions)
    logp = F.log_softmax(esm2.lm_logits(esm_params, lm_head, hidden, cfg), dim=-1)
    tgt = labels.clamp(0, cfg.vocab_size - 1).long()
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    is_masked = (labels != IGNORE).float()
    return (nll * is_masked).sum(), is_masked.sum()


def mlm_loss(esm_params, lm_head, masked_ids, attention_mask, labels, cfg: esm2.ESM2Config,
             remat: bool = False, segment_ids=None, positions=None) -> torch.Tensor:
    """The mean cross-entropy over the masked positions (0 where none is);
    on packed rows it equals the unpacked loss of the same sequences."""
    s, c = mlm_loss_terms(esm_params, lm_head, masked_ids, attention_mask, labels, cfg,
                          remat=remat, segment_ids=segment_ids, positions=positions)
    return s / c.clamp(min=1.0)
