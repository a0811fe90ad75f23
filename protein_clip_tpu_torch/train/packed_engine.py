"""Packed-row CLIP train step: the port of
``protein_clip_tpu/train/packed_engine.py`` for flat packing.

Both sides of the global batch are packed (``data/packing.py``) into rows of
one width; the frozen backbone runs segment-masked (K1 over packed segments
on the card) with a RoPE restart and a token-dropout ratio per segment, and
each sequence's pooled sum comes from a sum over the tokens it owns.
Embeddings come out in the original pair order, so the InfoNCE diagonal is
untouched. Packing fills about 95% of the tokens, length groups about 80%.

The wire is compact: int8 token ids (the 33-token vocabulary fits) and an
int32 owner permutation per side, pinned and copied by ``data/prefetch.py``.
Segment ids, positions within the segment and each token's owner are
derived on the device from the ids (``expand_packed_batch``): every packed
sequence starts with <cls> and gaps are <pad>, so the segment boundaries
are exact.

Row widths follow the batch's longest sequence (a multiple of 128, at most
``MAX_ROW_LEN``), so 2000-residue chains pack without truncation; row
counts round up to a multiple that halves as the width doubles
(``_row_multiple_for``), so batch shapes repeat.

Not ported here: width-tiered packing (``tiers > 1``, ``--pack-tiers``;
ROADMAP queue 1: width-tiered packing) and FILIP's scatter tiers
(``scatter_tiers > 1``; ROADMAP queue 1: packed FILIP). Both raise
``NotImplementedError``.
"""

from __future__ import annotations

import os
import warnings
from typing import Callable

import numpy as np
import torch

from ..data.packing import pack_sequences
from ..data.tokenizer import CLS_ID, EOS_ID, PAD_ID, EsmTokenizer
from ..models import esm2, heads

SIDES = ("pep", "rec")

# The reference's ingest keeps chains of at most 2000 residues: 2002 tokens
# with <cls> and <eos>; 2048 covers them.
MAX_ROW_LEN = 2048


def _row_len_for(max_len: int, explicit: int | None, cap: int = MAX_ROW_LEN) -> int:
    if explicit is not None:
        return explicit
    return min(cap, max(128, -(-max_len // 128) * 128))


def _row_multiple_for(w: int) -> int:
    """Row-count rounding for rows of width w: a constant quantum of slots
    (16 rows at 512, 8 at 1024, 4 at 2048), so wide rows do not drown in a
    16-row minimum."""
    m = 16
    while m > 4 and m * w > 16 * 512:
        m //= 2
    return m


def scan_order_operm(packed, idx: np.ndarray) -> np.ndarray:
    """Owner permutation: the ``idx`` entry of each segment in row-major
    (row, segment) scan order, the one map the device-side derivation
    (``_expand_pack``) needs; the rest follows from the ids."""
    counts = packed.segment_ids.max(axis=1)
    offsets = np.concatenate(([0], np.cumsum(counts)[:-1]))
    g = offsets[packed.owner_row] + packed.owner_seg - 1
    operm = np.zeros(packed.n_sequences, np.int32)
    operm[g] = idx
    return operm


def _pack_one(encs: list[np.ndarray], idx: np.ndarray, row_len: int) -> dict[str, np.ndarray]:
    """Pack one group: int8 ids and the owner permutation to ``idx``."""
    packed = pack_sequences(encs, row_len, row_multiple=_row_multiple_for(row_len))
    return {"ids": packed.ids.astype(np.int8), "operm": scan_order_operm(packed, idx)}


def check_flat(tiers: int = 1, scatter_tiers: int = 1,
               tier_widths: list[int] | None = None) -> None:
    """Raise on the packing options the port does not run yet."""
    if tiers > 1 or tier_widths is not None:
        raise NotImplementedError(
            f"width-tiered packing (tiers={tiers}, tier_widths={tier_widths}, --pack-tiers) "
            "is not ported yet (ROADMAP queue 1: width-tiered packing); the packed step "
            "takes flat packing, tiers=1")
    if scatter_tiers > 1:
        raise NotImplementedError(
            f"FILIP scatter tiers (scatter_tiers={scatter_tiers}) are not ported yet (ROADMAP "
            "queue 1: packed FILIP); the packed step takes scatter_tiers=1")


def tokenize_packed(tokenizer: EsmTokenizer, peps: list[str], recs: list[str],
                    pep_row_len: int | None = None, rec_row_len: int | None = None,
                    tiers: int = 1, scatter_tiers: int = 1,
                    tier_widths: list[int] | None = None) -> dict[str, torch.Tensor]:
    """Both sides packed into a compact host batch: ``{side}_ids`` (R, L)
    int8 and ``{side}_operm`` (N,) int32.

    Row widths follow each side's longest tokenized sequence (a multiple of
    128, at most MAX_ROW_LEN) unless given. A sequence longer than the row
    is truncated with its <eos> kept, which happens only past the 2048 cap,
    beyond the reference's own ingest filter, and is warned about."""
    check_flat(tiers, scatter_tiers, tier_widths)
    out: dict[str, torch.Tensor] = {}
    for side, seqs, explicit in (("pep", peps, pep_row_len), ("rec", recs, rec_row_len)):
        encs = [tokenizer.encode(s) for s in seqs]
        row_len = _row_len_for(max(len(e) for e in encs), explicit)
        clamped = 0
        for j, e in enumerate(encs):
            if len(e) > row_len:  # keep eos, like the bucket clamp
                encs[j] = np.concatenate((e[: row_len - 1], [EOS_ID]))
                clamped += 1
        if clamped:
            warnings.warn(f"tokenize_packed: {clamped} {side} sequence(s) longer than "
                          f"row_len={row_len} were truncated (eos kept)", stacklevel=2)
        pk = _pack_one(encs, np.arange(len(encs), dtype=np.int32), row_len)
        out[f"{side}_ids"] = torch.from_numpy(pk["ids"])
        out[f"{side}_operm"] = torch.from_numpy(pk["operm"])
    return out


def derive_segments(ids8: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(int32 ids, segment ids, positions within the segment) of packed rows,
    on their device: the segment id is a running count of <cls> on valid
    tokens (0 on <pad>), and positions restart at each <cls>."""
    ids = ids8.to(torch.int32)
    R, L = ids.shape
    valid = ids != PAD_ID
    is_bos = ids == CLS_ID
    seg = torch.cumsum(is_bos.to(torch.int32), 1, dtype=torch.int32) * valid
    ar = torch.arange(L, dtype=torch.int32, device=ids.device).expand(R, L)
    starts = torch.cummax(torch.where(is_bos, ar, 0), 1).values
    pos = torch.where(valid, ar - starts, 0)
    return ids, seg, pos


def _expand_pack(ids8: torch.Tensor, operm: torch.Tensor, dump: int) -> dict[str, torch.Tensor]:
    """int32 ids, segment ids, positions and each token's owner for one pack.
    ``dump`` (the side's sequence count) owns the gap and pad tokens."""
    ids, seg, pos = derive_segments(ids8)
    n_local = operm.shape[0]
    counts = seg.amax(1)
    offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts   # segments before the row
    g = (offsets[:, None] + seg - 1).clamp(0, n_local - 1)
    owner = torch.where(seg > 0, operm[g.long()], dump)
    return {"ids": ids, "seg": seg, "pos": pos, "owner": owner}


def packed_side_count(batch: dict, side: str) -> int:
    """The number of sequences a packed batch carries for one side."""
    return batch[f"{side}_operm"].shape[0]


def expand_packed_batch(batch: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The device-side maps of a compact packed batch: ``{side}_ids``
    (int32), ``_seg``, ``_pos`` and ``_owner``, beside ``{side}_operm``. An
    expanded batch comes back as it is."""
    if "pep_seg" in batch:
        return batch
    out = dict(batch)
    for side in SIDES:
        e = _expand_pack(batch[f"{side}_ids"], batch[f"{side}_operm"],
                         packed_side_count(batch, side))
        out.update({f"{side}_{k}": v for k, v in e.items()})
    return out


def _encode_packed_chunked(esm_params, ids, seg, pos, cfg: esm2.ESM2Config,
                           rows_per_chunk: int) -> torch.Tensor:
    """Frozen-backbone hidden states (R, L, H) of packed rows, from the
    largest number of equal chunks, at most R // rows_per_chunk, that
    divides R. Under ``torch.no_grad``, not ``inference_mode``: the heads'
    autograd saves these tensors."""
    R = ids.shape[0]
    n_chunks = max(1, R // rows_per_chunk)
    while R % n_chunks:
        n_chunks -= 1
    with torch.no_grad():
        return torch.cat([esm2.forward(esm_params, i, (s > 0).to(torch.int32), cfg,
                                       segment_ids=s, positions=p)
                          for i, s, p in zip(ids.chunk(n_chunks), seg.chunk(n_chunks),
                                             pos.chunk(n_chunks))])


def _token_sums(head_params, hidden, owner, n_seqs: int, *, activation: str, **dropout):
    """The per-token head on one pack, summed per owner: (sums (n, D),
    counts (n,)).

    The sum is a product with the (n, R * L) one-hot matrix of the owners:
    gap and pad tokens belong to ``n_seqs``, which has no row, and are
    zeroed first, so a non-finite value there stays out of every sum (as
    the TPU package's dump row keeps it). On the card that product and its backward are cuBLAS GEMMs, which
    add in the same order on every run; a CUDA ``index_add_`` adds with
    atomics in an order that changes between runs, and its deterministic
    mode is a switch of the whole process. The one-hot matrix is 4 n bytes
    a token (33 MB for 256 receptors in rows of 256)."""
    x = heads.encode_tokens(head_params, hidden, activation, **dropout)
    R, L, D = x.shape
    x = x.masked_fill((owner >= n_seqs).reshape(R, L, 1), 0.0)
    ids = torch.arange(n_seqs, device=owner.device, dtype=owner.dtype)
    one_hot = (owner.reshape(1, R * L) == ids[:, None]).to(x.dtype)
    return one_hot @ x.reshape(R * L, D), one_hot.sum(1)


def _pool_packed(head_params, hidden, owner, n_seqs: int, temperature, *, activation: str,
                 dropout_rate: float = 0.0, train: bool = False,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """Per-sequence scaled embeddings (n, D) from packed hidden states: the
    masked mean over each sequence's tokens, then ``heads.finish_pooled``.
    Dropout draws from ``generator`` for the token FFN, then for the pooled
    FFN, where the TPU package splits its key in two."""
    drop = dict(dropout_rate=dropout_rate, train=train, generator=generator)
    sums, cnt = _token_sums(head_params, hidden, owner, n_seqs, activation=activation, **drop)
    return _finish_pool(head_params, sums, cnt, temperature, activation=activation, **drop)


def _finish_pool(head_params, sums, cnt, temperature, *, activation: str, **dropout):
    """Scaled embeddings (n, D) from per-sequence token sums and counts: the
    masked mean, then ``heads.finish_pooled`` (``dropout`` takes its
    keywords)."""
    pooled = sums / cnt.clamp(min=1.0)[:, None]
    return heads.finish_pooled(head_params, pooled, temperature, activation, **dropout)


def _default_rows_per_chunk(rows_per_chunk: int | None) -> int:
    """Rows per backbone chunk: 16 unless ``PCT_ROWS_PER_CHUNK`` or the
    caller names another."""
    if rows_per_chunk is None:
        return int(os.environ.get("PCT_ROWS_PER_CHUNK", "16"))
    return rows_per_chunk


def _validate_packed_batch(batch, n_seqs: int | None) -> None:
    if not isinstance(batch, dict) or "pep_operm" not in batch:
        raise ValueError("packed step needs tokenize_packed batches (cfg.packed=True pairs "
                         "with the packed tokenizer; got another batch)")
    if n_seqs is not None:
        for side in SIDES:
            got = packed_side_count(batch, side)
            if got != n_seqs:
                raise ValueError(f"packed batch has {got} {side} sequences but the step "
                                 f"expects {n_seqs} (cfg.global_batch for training); the "
                                 "owner sums would drop or misroute embeddings")


def _packs_and_hidden(esm_params, batch, mcfg, rows_per_chunk: int):
    """The expanded batch and each side's backbone hidden states in f32."""
    batch = expand_packed_batch(batch)
    hidden = {side: _encode_packed_chunked(esm_params, batch[f"{side}_ids"],
                                           batch[f"{side}_seg"], batch[f"{side}_pos"],
                                           mcfg.esm, rows_per_chunk).float()
              for side in SIDES}
    return batch, hidden


def _pooled_sides(params, batch, hidden, n_seqs: int, mcfg, *, train: bool,
                  generator: torch.Generator | None = None):
    """(pep_emb, rec_emb) in the batch's pair order."""
    return tuple(_pool_packed(params[side], hidden[side], batch[f"{side}_owner"], n_seqs,
                              params["temperature"], activation=mcfg.activation,
                              dropout_rate=mcfg.dropout, train=train, generator=generator)
                 for side in SIDES)


def make_train_step_packed(cfg, loss_fn: Callable | None = None,
                           rows_per_chunk: int | None = None):
    """The global-batch step over ``tokenize_packed`` batches of
    ``cfg.global_batch`` pairs, with ``clip_engine.make_train_step``'s
    signature; ``loss_fn`` defaults to ``clip_engine.default_loss_fn()``."""
    from .clip_engine import _update, default_loss_fn   # clip_engine imports this module

    check_flat(cfg.packed_tiers, cfg.scatter_tiers)
    rows_per_chunk = _default_rows_per_chunk(rows_per_chunk)
    loss_fn = loss_fn or default_loss_fn()
    n_seqs = cfg.global_batch

    def step(params, opt_state, esm_params, batch, generator):
        _validate_packed_batch(batch, n_seqs)
        batch, hidden = _packs_and_hidden(esm_params, batch, cfg.model, rows_per_chunk)
        pep, rec = _pooled_sides(params, batch, hidden, n_seqs, cfg.model, train=True,
                                 generator=generator)
        return _update(loss_fn(pep, rec), params, opt_state)

    return step


def make_eval_step_packed(cfg, loss_fn: Callable | None = None,
                          rows_per_chunk: int | None = None):
    """The packed eval step: the train step's batch path in eval mode and
    with no graph. The pool size is the batch's own (``{side}_operm``), so
    one step serves validation batches of ``cfg.batch_size`` pairs."""
    from .clip_engine import default_loss_fn

    check_flat(cfg.packed_tiers, cfg.scatter_tiers)
    rows_per_chunk = _default_rows_per_chunk(rows_per_chunk)
    loss_fn = loss_fn or default_loss_fn()

    @torch.inference_mode()
    def step(params, esm_params, batch):
        return loss_fn(*embed_packed(params, esm_params, batch, cfg.model, rows_per_chunk))

    return step


@torch.inference_mode()
def embed_packed(params, esm_params, batch, mcfg, rows_per_chunk: int | None = None):
    """(pep_emb, rec_emb) of a packed batch in eval mode, in the batch's pair
    order."""
    _validate_packed_batch(batch, None)
    n_seqs = packed_side_count(batch, "pep")
    batch, hidden = _packs_and_hidden(esm_params, batch, mcfg,
                                      _default_rows_per_chunk(rows_per_chunk))
    return _pooled_sides(params, batch, hidden, n_seqs, mcfg, train=False)
