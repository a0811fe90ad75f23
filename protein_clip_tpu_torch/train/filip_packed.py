"""Packed-row FILIP training: the port of ``protein_clip_tpu/train/filip_packed.py``.

The frozen backbone runs over the packed rows of ``packed_engine`` (K1 over
packed segments on the card, about 95% of the tokens filled); the per-token
head runs on the packed rows, and the tokens scatter back into
per-sequence buffers for the masked max-sim (K4), which needs each
sequence's tokens on one axis. A token's slot is its position counted from
<cls> = 0, so the packed scores equal the one-bucket scores, <cls> and
<eos> included (the reference's FILIP mask keeps them).

Token embeddings are L2-normalised before the scatter (with f32's ``tiny``
under the root), so empty slots stay exact zeros; normalising after would
divide 0 by 0. Zero slots are masked out of the max-sim.

Without scatter tiers a side scatters into one (n, L, D) buffer at its row
width L, and one K4 call scores the (n, n) pairs. With scatter tiers
(``tokenize_packed(scatter_tiers > 1)``: ``{side}_stiers``) each length
tier gets its own (B_t, W_t, D) buffer at its own width, and the (n, n)
scores are assembled from the rectangular K4 blocks of every (pep tier,
rec tier) pair, so a long tail does not widen every block. A tier's
indices pad to a multiple of 8 with the sentinel n: those phantom rows are
all-masked (K4 scores them 0) and are written into an (n + 1, n + 1)
buffer whose last row and column are sliced off. The writes are
``index_put`` without accumulation, whose backward is a gather: the step
adds nothing with atomics and repeats to the bit. Duplicate writes land
only in the sliced-off dump slots.

A side packed in width tiers (``tokenize_packed(tiers > 1)``:
``{side}_packs``) runs the backbone on each pack at a constant number of
tokens a chunk, and scatters each pack's tokens by their rank within the
pack (``local_owner``) into a (n_t, L_t, D) buffer of the pack's own width,
n_t its operm's length: the pack's operm, global indices padded with the
sentinel n, places the pack's rows of every block in the (n + 1, n + 1)
assembly, as a scatter tier's does. A side of one pack (flat, as a narrow
peptide side often is beside a tiered receptor side) keeps the flat path
and its scatter tiers; scatter tiers apply to one-pack sides only, as in
the TPU package.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models import heads
from ..ops.filip import filip_similarity_fused
from ..ops.infonce import filip_loss
from . import packed_engine as pe
from .clip_engine import EngineConfig, _update

__all__ = ["filip_sim_packed", "make_train_step_packed_filip", "make_eval_step_packed_filip"]


def _l2_normalize_tokens(x: torch.Tensor) -> torch.Tensor:
    """x / sqrt(sum x^2 + tiny) along D in f32: a zero token stays zero."""
    x32 = x.float()
    norm = (x32.square().sum(-1, keepdim=True) + torch.finfo(torch.float32).tiny).sqrt()
    return (x32 / norm).to(x.dtype)


def _scatter(flat: torch.Tensor, slot: torch.Tensor, pos: torch.Tensor, keep: torch.Tensor,
             rows: int, width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows, width, D) f32 tokens and their (rows, width) int32 mask: token
    k of ``flat`` at (slot[k], pos[k]) where ``keep``; the others go to the
    dump slot (rows, 0), which is sliced off."""
    o = torch.where(keep, slot, rows).long()
    p = torch.where(keep, pos, 0).long()
    out = flat.new_zeros(rows + 1, width, flat.shape[1], dtype=torch.float32)
    mask = torch.zeros(rows + 1, width, dtype=torch.int32, device=flat.device)
    out = out.index_put((o, p), flat.float())
    mask = mask.index_put((o, p), keep.to(torch.int32))
    return out[:rows], mask[:rows]


def _scatter_tokens_into(x: torch.Tensor, seg: torch.Tensor, pos: torch.Tensor,
                         owner: torch.Tensor, n_seqs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One pack's tokens (R, L, D) into per-sequence (n, L, D) buffers and
    (n, L) masks; gap and pad tokens go to the dump row."""
    R, L, D = x.shape
    return _scatter(x.reshape(R * L, D), owner.reshape(-1), pos.reshape(-1),
                    seg.reshape(-1) > 0, n_seqs, L)


def _scatter_by_tiers(x: torch.Tensor, pk: dict, stiers, n_seqs: int) -> list[tuple]:
    """One flat pack's normalised tokens into per-length-tier buffers:
    [(tokens (B_t, W_t, D), mask (B_t, W_t), operm (B_t,)), ...]. Every
    valid token lands in its sequence's tier, at its local slot there."""
    dev = x.device
    g2t = torch.zeros(n_seqs + 1, dtype=torch.int64, device=dev)   # global -> tier
    g2l = torch.zeros(n_seqs + 1, dtype=torch.int64, device=dev)   # global -> local slot
    for t, st in enumerate(stiers):
        op = st["operm"].long()                                     # sentinels write slot n
        g2t = g2t.index_put((op,), torch.full_like(op, t))
        g2l = g2l.index_put((op,), torch.arange(op.shape[0], device=dev))
    R, L, D = x.shape
    flat = x.reshape(R * L, D)
    own = pk["owner"].reshape(-1).long()
    pos = pk["pos"].reshape(-1)
    valid = (pk["seg"].reshape(-1) > 0) & (own < n_seqs)
    own = own.clamp(0, n_seqs - 1)
    tok_tier = torch.where(valid, g2t[own], -1)
    tok_local = g2l[own]
    return [(*_scatter(flat, tok_local, pos, tok_tier == t, st["operm"].shape[0], st["width"]),
             st["operm"]) for t, st in enumerate(stiers)]


def _scatter_side(x: torch.Tensor, pk: dict, stiers, n_seqs: int) -> list[tuple]:
    """The tier list ``_sim_from_tiers`` takes: per-length-tier buffers when
    the side carries scatter tiers, else one (n, L, D) buffer (operm None)."""
    if stiers:
        return _scatter_by_tiers(x, pk, stiers, n_seqs)
    return [(*_scatter_tokens_into(x, pk["seg"], pk["pos"], pk["owner"], n_seqs), None)]


def _sim_from_tiers(tiers_pep: list, tiers_rec: list, temperature, sim_fn: Callable,
                    n_seqs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(sim_a, sim_b), each (n, n), from both sides' tier lists: one call of
    ``sim_fn`` when neither side carries an operm, else every (pep tier, rec
    tier) block written at its sequences' rows and columns of an (n + 1, n +
    1) buffer (the sentinel n keeps phantom rows in bounds), sliced to (n, n)."""
    if (len(tiers_pep) == 1 and len(tiers_rec) == 1
            and tiers_pep[0][2] is None and tiers_rec[0][2] is None):
        (ha, mask_a, _), (hb, mask_b, _) = tiers_pep[0], tiers_rec[0]
        return sim_fn(ha, hb, mask_a, mask_b, temperature)
    dev = tiers_pep[0][0].device
    every = torch.arange(n_seqs, device=dev)
    sim_a = torch.zeros(n_seqs + 1, n_seqs + 1, device=dev)
    sim_b = torch.zeros(n_seqs + 1, n_seqs + 1, device=dev)
    for ha, mask_a, ixa in tiers_pep:
        ia = (every if ixa is None else ixa.long())[:, None]
        for hb, mask_b, ixb in tiers_rec:
            ib = (every if ixb is None else ixb.long())[None, :]
            sa, sb = sim_fn(ha, hb, mask_a, mask_b, temperature)
            sim_a = sim_a.index_put((ia, ib), sa)
            sim_b = sim_b.index_put((ia, ib), sb)
    return sim_a[:n_seqs, :n_seqs], sim_b[:n_seqs, :n_seqs]


def filip_sim_packed(params, esm_params, batch: dict, mcfg, n_seqs: int, *,
                     rows_per_chunk: int = 16, train: bool = False,
                     generator: torch.Generator | None = None,
                     similarity_fn: Callable | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(sim_a, sim_b), each (n, n), of a packed batch: the frozen backbone
    in chunks of ``rows_per_chunk`` rows (more rows for packs narrower than
    the side's widest) with no graph, the token heads (dropout from
    ``generator`` in train mode, pep then rec, pack by pack), normalised
    tokens scattered flat, by scatter tiers or by width-tier packs, and
    ``similarity_fn`` (default ``filip_similarity_fused``: K4 on CUDA
    tensors) on every block."""
    sim_fn = similarity_fn or filip_similarity_fused
    batch = pe.expand_packed_batch(batch)
    sides = {}
    for side in pe.SIDES:
        packs = pe.side_packs(batch, side)
        t_out = max(p["ids"].shape[1] for p in packs)
        tiers = []
        for pk in packs:
            L = pk["ids"].shape[1]
            h = pe._encode_packed_chunked(esm_params, pk["ids"], pk["seg"], pk["pos"], mcfg.esm,
                                          rows_per_chunk * (t_out // L))
            x = _l2_normalize_tokens(heads.encode_tokens(
                params[side], h.float(), mcfg.activation, dropout_rate=mcfg.dropout,
                train=train, generator=generator))
            if len(packs) == 1:
                tiers = _scatter_side(x, pk, batch.get(f"{side}_stiers"), n_seqs)
            else:
                n_t = pk["operm"].shape[0]
                tiers.append((*_scatter_tokens_into(x, pk["seg"], pk["pos"], pk["local_owner"],
                                                    n_t), pk["operm"]))
        sides[side] = tiers
    return _sim_from_tiers(sides["pep"], sides["rec"], params["temperature"], sim_fn, n_seqs)


def make_train_step_packed_filip(cfg: EngineConfig, similarity_fn: Callable | None = None,
                                 use_dcl: bool | None = None,
                                 rows_per_chunk: int | None = None):
    """The FILIP step over ``tokenize_packed`` batches of ``cfg.batch_size``
    pairs (FILIP accumulates no batches), with ``filip_engine``'s signature."""
    use_dcl = cfg.filip_use_dcl if use_dcl is None else use_dcl
    rows_per_chunk = pe._default_rows_per_chunk(rows_per_chunk)
    n_seqs = cfg.batch_size

    def step(params, opt_state, esm_params, batch, generator):
        pe._validate_packed_batch(batch, n_seqs)
        sim_a, sim_b = filip_sim_packed(params, esm_params, batch, cfg.model, n_seqs,
                                        rows_per_chunk=rows_per_chunk, train=True,
                                        generator=generator, similarity_fn=similarity_fn)
        return _update(filip_loss(sim_a, sim_b, use_dcl), params, opt_state)

    return step


def make_eval_step_packed_filip(cfg: EngineConfig, similarity_fn: Callable | None = None,
                                use_dcl: bool | None = None,
                                rows_per_chunk: int | None = None):
    """The packed train step's scores in eval mode and with no graph; the
    pool is the batch's own sequence count."""
    use_dcl = cfg.filip_use_dcl if use_dcl is None else use_dcl
    rows_per_chunk = pe._default_rows_per_chunk(rows_per_chunk)

    @torch.inference_mode()
    def step(params, esm_params, batch):
        pe._validate_packed_batch(batch, None)
        return filip_loss(*filip_sim_packed(
            params, esm_params, batch, cfg.model, pe.packed_side_count(batch, "pep"),
            rows_per_chunk=rows_per_chunk, similarity_fn=similarity_fn), use_dcl)

    return step
