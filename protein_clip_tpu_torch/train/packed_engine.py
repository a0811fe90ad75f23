"""Packed-row CLIP train step: the port of
``protein_clip_tpu/train/packed_engine.py`` (flat and width-tiered
packing; the single-side MLM wire).

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

With ``tiers`` > 1 (``--pack-tiers``) or explicit ``tier_widths`` each
side packs into row groups of several widths, each sequence into the
narrowest that fits it: the wire carries ``{side}_packs``, one
{ids, operm, nmark} pack per width. The widths come from a dynamic program
over 128-multiples that prices each tier by the rows first-fit-decreasing
would fill (``_tier_widths_data``); they, each tier's row count and its
operm length stick for the rest of the process (``_STICKY_*``, cleared by
``clear_tier_width_cache``), so batch shapes repeat: a later batch that
overflows a tier spills to the next wider one, a width the batch leaves
empty ships a placeholder pack of all-<pad> rows, row counts ratchet up to
their high-water mark with all-<pad> rows, and operms pad to a multiple of
8 with the sentinel n (``nmark``'s length is the real count). The
backbone runs each pack at a constant number of tokens a chunk, and the
token sums of every pack add up before one pooled finish (``_pool_packs``).

With ``scatter_tiers`` > 1 (packed FILIP, ``train/filip_packed.py``) the
backbone rows stay flat-packed and the wire also carries ``{side}_stiers``,
each sequence's length tier (``_tier_widths``), so FILIP's token buffers
and max-sim blocks follow true lengths, not the row width. The CLIP packed
steps pool per sequence and refuse scatter tiers.
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


def _tier_widths(row_len: int, n: int = 4) -> list[int]:
    """The n-way split points of the row length, rounded up to multiples of
    128 (at least 128), with row_len itself always a member; nearby widths
    collapse, so there are at most n: 512 -> [128, 256, 384, 512], 128 ->
    [128], 2048 -> [512, 1024, 1536, 2048]."""
    return sorted({min(row_len, max(128, -(-row_len * q // n) // 128 * 128))
                   for q in range(1, n + 1)} | {row_len})


def _row_multiple_for(w: int) -> int:
    """Row-count rounding for rows of width w: a constant quantum of slots
    (16 rows at 512, 8 at 1024, 4 at 2048), so wide rows do not drown in a
    16-row minimum."""
    m = 16
    while m > 4 and m * w > 16 * 512:
        m //= 2
    return m


# A slot's backbone cost at row width w is about w + 3H (12 H^2 operations a
# layer in the linear layers and FFN against 4 w H in attention): 1920 is
# 3 x 640, t30_150M's H. The chosen widths trade attention against fill
# only, so the optimum is flat in this constant.
_TIER_COST_GAMMA = 1920


def _ffd_rows(lens: list[int], w: int) -> int:
    """The rows first-fit-decreasing packing fills at width w (as
    ``pack_sequences`` packs), which the tier-width program prices."""
    free: list[int] = []
    for L in sorted(lens, reverse=True):
        for i, f in enumerate(free):
            if f >= L:
                free[i] = f - L
                break
        else:
            free.append(w - L)
    return len(free)


def _tier_widths_data(lens: list[int], row_len: int, n: int) -> list[int]:
    """At most n widths, multiples of 128 (and row_len), that minimise the
    modelled backbone cost sum_t rows_t * w_t * (w_t + _TIER_COST_GAMMA),
    rows_t being the rows first-fit-decreasing fills at w_t rounded up to
    ``_row_multiple_for(w_t)``: an exact dynamic program over the buckets
    between consecutive candidate widths (best[b][k]: the least cost of the
    buckets up to b in k tiers; a sequence takes the narrowest chosen width
    that fits it)."""
    cands = sorted({min(row_len, w) for w in range(128, row_len + 127, 128)} | {row_len})
    buckets: list[list[int]] = [[] for _ in cands]
    lo = 0
    for j, c in enumerate(cands):
        buckets[j] = [L for L in lens if lo < L <= c]
        lo = c
    last = max((j for j, b in enumerate(buckets) if b), default=0)
    cands = cands[: last + 1]
    buckets = buckets[: last + 1]
    m = len(cands)

    def tier_cost(a: int, b: int) -> float:
        members = [L for bk in buckets[a: b + 1] for L in bk]
        if not members:
            return 0.0
        w = cands[b]
        mult = _row_multiple_for(w)
        rows = -(-_ffd_rows(members, w) // mult) * mult
        return float(rows) * w * (w + _TIER_COST_GAMMA)

    inf = float("inf")
    best = [[inf] * (n + 1) for _ in range(m)]
    pick: dict[tuple[int, int], int] = {}
    for b in range(m):
        for k in range(1, n + 1):
            c_full = tier_cost(0, b)
            if c_full < best[b][k]:
                best[b][k] = c_full
                pick[(b, k)] = -1
            if k > 1:
                for a in range(b):
                    c = best[a][k - 1] + tier_cost(a + 1, b)
                    if c < best[b][k]:
                        best[b][k] = c
                        pick[(b, k)] = a
    widths = []
    b, k = m - 1, n
    while b >= 0:
        a = pick[(b, k)]
        widths.append(cands[b])
        if a < 0:
            break
        b, k = a, k - 1
    return sorted(set(widths))


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


# The first width choice per (side, row_len, tiers), kept for the rest of
# the process so batch shapes repeat; the high-water row and operm counts
# per (side, row_len, tiers, width), up to which every later pack of that
# width is padded. Written by whoever tokenizes (the loop's prefetch thread,
# one at a time: an epoch's producer ends before the next loader's starts);
# each CLI run starts from a clear cache, and the train-state snapshot
# carries them (``tier_state``), so a resumed run packs as an unbroken one.
_STICKY_TIER_WIDTHS: dict[tuple[str, int, int], list[int]] = {}
_STICKY_TIER_ROWS: dict[tuple[str, int, int, int], int] = {}
_STICKY_TIER_OPERM: dict[tuple[str, int, int, int], int] = {}


def clear_tier_width_cache() -> None:
    """Forget the sticky tier widths, rows and operm lengths."""
    _STICKY_TIER_WIDTHS.clear()
    _STICKY_TIER_ROWS.clear()
    _STICKY_TIER_OPERM.clear()


def tier_state() -> dict:
    """The sticky tier caches as plain lists, for a train-state snapshot."""
    return {"widths": [[*k, list(v)] for k, v in _STICKY_TIER_WIDTHS.items()],
            "rows": [[*k, v] for k, v in _STICKY_TIER_ROWS.items()],
            "operm": [[*k, v] for k, v in _STICKY_TIER_OPERM.items()]}


def restore_tier_state(state: dict) -> None:
    """Replace the sticky tier caches by ``tier_state()``'s."""
    clear_tier_width_cache()
    _STICKY_TIER_WIDTHS.update({tuple(e[:3]): list(e[3]) for e in state["widths"]})
    _STICKY_TIER_ROWS.update({tuple(e[:4]): int(e[4]) for e in state["rows"]})
    _STICKY_TIER_OPERM.update({tuple(e[:4]): int(e[4]) for e in state["operm"]})


def check_flat(tiers: int = 1) -> None:
    """Raise on width-tiered packing where the TPU package refuses it too:
    the unfrozen packed steps take flat packing only."""
    if tiers > 1:
        raise ValueError(f"the packed finetune and LoRA steps (CLIP and FILIP) take flat packing "
                         f"only (packed_tiers=1, got {tiers}), as the TPU package's do: "
                         "width-tiered finetune is not wired there")


def check_clip_packed(cfg) -> None:
    """The CLIP packed steps take no scatter tiers, which only FILIP's token
    max-sim reads."""
    if cfg.scatter_tiers > 1:
        raise NotImplementedError(
            f"scatter_tiers={cfg.scatter_tiers}: scatter tiers lay out FILIP's token max-sim "
            "(train/filip_packed.py); the CLIP packed steps pool per sequence and take "
            "scatter_tiers=1")


def _scatter_tier_wire(encs: list[np.ndarray], row_len: int, n: int) -> tuple[dict, ...]:
    """One entry per width of ``_tier_widths(row_len, n)``, in order, also
    for a width no sequence takes: ``operm``, the global indices of the
    sequences whose narrowest fitting width it is, padded to a multiple of
    8 with the sentinel len(encs) (an empty width ships none), and
    ``width``. The TPU package carries the width as the shape of a zeros
    array, the only static channel of a jitted tree; here it is a plain
    int, which ``data/prefetch.py`` passes through."""
    widths = _tier_widths(row_len, n)
    groups: dict[int, list[int]] = {w: [] for w in widths}
    for j, e in enumerate(encs):
        groups[next(w for w in widths if len(e) <= w)].append(j)
    return tuple({"operm": torch.tensor(g + [len(encs)] * (-len(g) % 8), dtype=torch.int32),
                  "width": w} for w, g in groups.items())


def _side_widths(side: str, encs: list[np.ndarray], row_len: int, max_len: int, tiers: int,
                 tier_widths: list[int] | None) -> list[int]:
    """The row widths of one side: the explicit ones that fit under row_len
    (and one to cover the batch when they do not), the sticky data-aware
    ones (derived again when the batch outgrows the widest), or row_len."""
    if tier_widths is not None:
        widths = sorted({w for w in tier_widths if w <= row_len})
        if not widths or widths[-1] < max_len:
            widths.append(min(row_len, -(-max_len // 128) * 128))
        return widths
    if tiers > 1:
        key = (side, row_len, tiers)
        widths = _STICKY_TIER_WIDTHS.get(key)
        if widths is None or max_len > widths[-1]:
            widths = _tier_widths_data([len(e) for e in encs], row_len, tiers)
            _STICKY_TIER_WIDTHS[key] = widths
        return widths
    return [row_len]


def _spill_to_wider(side: str, row_len: int, tiers: int, widths: list[int], groups: dict,
                    gidx: dict) -> None:
    """Once a tier's row count is sticky, the sequences of a later batch
    that do not fit its rows (first-fit-decreasing) move up to the next
    wider tier, in place; only the widest tier grows."""
    for i, w in enumerate(widths[:-1]):
        cap = _STICKY_TIER_ROWS.get((side, row_len, tiers, w))
        if cap is None or not groups[w]:
            continue
        order = sorted(range(len(groups[w])), key=lambda k: -len(groups[w][k]))
        free = [w] * cap
        keep, spill = [], []
        for k in order:
            L = len(groups[w][k])
            for r in range(cap):
                if free[r] >= L:
                    free[r] -= L
                    keep.append(k)
                    break
            else:
                spill.append(k)
        if spill:
            wn = widths[i + 1]
            groups[wn] += [groups[w][k] for k in spill]
            gidx[wn] += [gidx[w][k] for k in spill]
            keep = sorted(keep)
            groups[w] = [groups[w][k] for k in keep]
            gidx[w] = [gidx[w][k] for k in keep]


def _tier_pack(side: str, row_len: int, tiers: int, w: int, encs: list, idx: list,
               n_total: int) -> dict[str, torch.Tensor]:
    """One width's pack of the tiered wire: its sequences packed (a
    placeholder of ``_row_multiple_for(w)`` all-<pad> rows when it has
    none), rows padded with all-<pad> rows up to the sticky count, the
    operm padded with the sentinel n_total to a multiple of 8 (at least 8)
    and the sticky length, and ``nmark``, zeros of the real count's length."""
    if encs:
        pk = _pack_one(encs, np.asarray(idx, np.int32), w)
        op, ids_t = pk["operm"], pk["ids"]
    else:
        op = np.zeros((0,), np.int32)
        ids_t = np.full((_row_multiple_for(w), w), PAD_ID, np.int8)
    rkey = (side, row_len, tiers, w)
    rows = max(ids_t.shape[0], _STICKY_TIER_ROWS.get(rkey, 0))
    _STICKY_TIER_ROWS[rkey] = rows
    if rows > ids_t.shape[0]:
        ids_t = np.concatenate([ids_t, np.full((rows - ids_t.shape[0], w), PAD_ID, np.int8)])
    n_op = max(-(-op.shape[0] // 8) * 8, 8, _STICKY_TIER_OPERM.get(rkey, 0))
    _STICKY_TIER_OPERM[rkey] = n_op
    if n_op > op.shape[0]:
        op = np.concatenate([op, np.full((n_op - op.shape[0],), n_total, np.int32)])
    return {"ids": torch.from_numpy(ids_t), "operm": torch.from_numpy(op),
            "nmark": torch.zeros(len(idx), dtype=torch.int8)}


def tokenize_packed(tokenizer: EsmTokenizer, peps: list[str], recs: list[str],
                    pep_row_len: int | None = None, rec_row_len: int | None = None,
                    tiers: int = 1, scatter_tiers: int = 1,
                    tier_widths: list[int] | None = None) -> dict[str, torch.Tensor]:
    """Both sides packed into a compact host batch: ``{side}_ids`` (R, L)
    int8 and ``{side}_operm`` (N,) int32, and with ``scatter_tiers`` > 1
    ``{side}_stiers`` (``_scatter_tier_wire``; the rows do not change).
    With ``tiers`` > 1 or ``tier_widths``, a side of more than one width
    carries ``{side}_packs`` instead, one ``_tier_pack`` per width (also
    for a width this batch leaves empty); a side of one width the flat pair.

    Row widths follow each side's longest tokenized sequence (a multiple of
    128, at most MAX_ROW_LEN) unless given; width tiers cap at MAX_ROW_LEN
    (or the given width), so the sticky key does not move with the batch.
    A sequence longer than the row is truncated with its <eos> kept, which
    happens only past the 2048 cap, beyond the reference's own ingest
    filter, and is warned about."""
    out: dict[str, torch.Tensor] = {}
    tiered = tier_widths is not None or tiers > 1
    for side, seqs, explicit in (("pep", peps, pep_row_len), ("rec", recs, rec_row_len)):
        encs = [tokenizer.encode(s) for s in seqs]
        max_len = max(len(e) for e in encs)
        row_len = (explicit if tiered and explicit is not None
                   else MAX_ROW_LEN if tiered else _row_len_for(max_len, explicit))
        clamped = 0
        for j, e in enumerate(encs):
            if len(e) > row_len:  # keep eos, like the bucket clamp
                encs[j] = np.concatenate((e[: row_len - 1], [EOS_ID]))
                clamped += 1
        if clamped:
            warnings.warn(f"tokenize_packed: {clamped} {side} sequence(s) longer than "
                          f"row_len={row_len} were truncated (eos kept)", stacklevel=2)
        widths = _side_widths(side, encs, row_len, max_len, tiers, tier_widths)
        groups: dict[int, list] = {w: [] for w in widths}
        gidx: dict[int, list] = {w: [] for w in widths}
        for j, e in enumerate(encs):
            w = next(w for w in widths if len(e) <= w)
            groups[w].append(e)
            gidx[w].append(j)
        _spill_to_wider(side, row_len, tiers, widths, groups, gidx)
        if len(widths) == 1:
            pk = _pack_one(groups[widths[0]], np.asarray(gidx[widths[0]], np.int32), widths[0])
            out[f"{side}_ids"] = torch.from_numpy(pk["ids"])
            out[f"{side}_operm"] = torch.from_numpy(pk["operm"])
            if scatter_tiers > 1:
                out[f"{side}_stiers"] = _scatter_tier_wire(encs, row_len, scatter_tiers)
        else:
            out[f"{side}_packs"] = tuple(_tier_pack(side, row_len, tiers, w, groups[w], gidx[w],
                                                    len(encs)) for w in widths)
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


def tokenize_packed_rows(tokenizer: EsmTokenizer, seqs: list[str],
                         row_len: int | None = None) -> torch.Tensor:
    """The single-side packed wire of the MLM objective: int8 (R, L) token
    ids and no owner map (the loss is per token; ``derive_segments`` gives
    segments and positions on the device). ``tokenize_packed``'s row-length
    policy: the longest sequence rounded up to 128, at most MAX_ROW_LEN,
    unless given; a longer sequence is truncated with its <eos> kept, and
    warned about."""
    encs = [tokenizer.encode(s) for s in seqs]
    rl = _row_len_for(max(len(e) for e in encs), row_len)
    clamped = 0
    for j, e in enumerate(encs):
        if len(e) > rl:
            encs[j] = np.concatenate((e[: rl - 1], [EOS_ID]))
            clamped += 1
    if clamped:
        warnings.warn(f"tokenize_packed_rows: {clamped} sequence(s) longer than "
                      f"row_len={rl} were truncated (eos kept)", stacklevel=2)
    packed = pack_sequences(encs, rl, row_multiple=_row_multiple_for(rl))
    return torch.from_numpy(packed.ids.astype(np.int8))


def tokenize_packed_rows_sharded(tokenizer: EsmTokenizer, seqs: list[str], n_shards: int,
                                 row_len: int | None = None) -> torch.Tensor:
    """The single-side packed wire dealt over a data mesh: int8 (n_shards *
    r_max, L) rows, shard-major (the TPU package's
    ``tokenize_packed_rows_sharded``). The loss is per token, so the shards
    need neither equal sequence counts nor owner maps: the sequences go
    longest first to the shard with the fewest tokens, each shard packs its
    own, and a short shard fills up to r_max (a multiple of 8) with
    all-<pad> rows, whose segment is 0 everywhere (no attention, nothing to
    mask, no loss). Rank i of the data axis takes rows [i * r_max, (i + 1)
    * r_max). ``tokenize_packed_rows``' row-length and truncation rule."""
    encs = [tokenizer.encode(s) for s in seqs]
    rl = _row_len_for(max(len(e) for e in encs), row_len)
    clamped = 0
    for j, e in enumerate(encs):
        if len(e) > rl:
            encs[j] = np.concatenate((e[: rl - 1], [EOS_ID]))
            clamped += 1
    if clamped:
        warnings.warn(f"tokenize_packed_rows_sharded: {clamped} sequence(s) longer than "
                      f"row_len={rl} were truncated (eos kept)", stacklevel=2)
    order = sorted(range(len(encs)), key=lambda i: -len(encs[i]))
    members: list[list[int]] = [[] for _ in range(n_shards)]
    load = [0] * n_shards
    for i in order:
        s = int(np.argmin(load))
        members[s].append(i)
        load[s] += len(encs[i])
    packs = [pack_sequences([encs[i] for i in m], rl, row_multiple=1).ids
             if m else np.full((0, rl), PAD_ID) for m in members]
    r_max = -(-max(max(p.shape[0] for p in packs), 1) // 8) * 8
    ids = np.full((n_shards, r_max, rl), PAD_ID, np.int8)
    for s, p in enumerate(packs):
        ids[s, : p.shape[0]] = p.astype(np.int8)
    return torch.from_numpy(ids.reshape(n_shards * r_max, rl))


def _expand_pack(ids8: torch.Tensor, operm: torch.Tensor, dump: int) -> dict[str, torch.Tensor]:
    """int32 ids, segment ids, positions and each token's owner for one pack.
    ``dump`` (the side's sequence count) owns the gap and pad tokens.
    ``local_owner`` is a token's sequence rank within the pack (operm's
    index), the pack's operm length for gap and pad tokens: the tier-local
    scatter target of packed FILIP over width tiers."""
    ids, seg, pos = derive_segments(ids8)
    n_local = operm.shape[0]
    counts = seg.amax(1)
    offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts   # segments before the row
    g = (offsets[:, None] + seg - 1).clamp(0, n_local - 1)
    owner = torch.where(seg > 0, operm[g.long()], dump)
    return {"ids": ids, "seg": seg, "pos": pos, "owner": owner, "operm": operm,
            "local_owner": torch.where(seg > 0, g, n_local)}


def packed_side_count(batch: dict, side: str) -> int:
    """The number of sequences a packed batch carries for one side: the sum
    of its packs' ``nmark`` lengths (their operms pad with sentinels), or
    the flat operm's length."""
    if f"{side}_packs" in batch:
        return sum(p["nmark"].shape[0] if "nmark" in p else p["operm"].shape[0]
                   for p in batch[f"{side}_packs"])
    return batch[f"{side}_operm"].shape[0]


def expand_packed_batch(batch: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The device-side maps of a compact packed batch: ``{side}_ids``
    (int32), ``_seg``, ``_pos`` and ``_owner``, beside ``{side}_operm``; or
    each of ``{side}_packs`` expanded (``_expand_pack``, its ``nmark``
    kept). An expanded batch comes back as it is."""
    if "pep_seg" in batch or any(batch.get(f"{s}_packs") and "seg" in batch[f"{s}_packs"][0]
                                 for s in SIDES):
        return batch
    out = dict(batch)
    for side in SIDES:
        n_seqs = packed_side_count(batch, side)
        if f"{side}_packs" in batch:
            out[f"{side}_packs"] = tuple({**_expand_pack(p["ids"], p["operm"], n_seqs),
                                          **({"nmark": p["nmark"]} if "nmark" in p else {})}
                                         for p in batch[f"{side}_packs"])
        else:
            e = _expand_pack(batch[f"{side}_ids"], batch[f"{side}_operm"], n_seqs)
            out.update({f"{side}_{k}": e[k] for k in ("ids", "seg", "pos", "owner")})
    return out


def side_packs(batch: dict, side: str) -> list[dict]:
    """An expanded batch's packs of one side: ``{side}_packs``, or the flat
    pair as one pack of ids, seg, pos and owner."""
    if f"{side}_packs" in batch:
        return list(batch[f"{side}_packs"])
    return [{k: batch[f"{side}_{k}"] for k in ("ids", "seg", "pos", "owner")}]


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


def _pool_packs(head_params, hiddens: list, packs: list, n_seqs: int, temperature, *,
                activation: str, dropout_rate: float = 0.0, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """Width tiers' pooling: the token sums and counts of every pack added
    up, then one ``_finish_pool``: each sequence lives in one pack, so this
    is the pooling of one flat pack of the same sequences. Dropout draws
    from ``generator`` for each pack's token FFN in turn, then for the
    pooled FFN."""
    drop = dict(dropout_rate=dropout_rate, train=train, generator=generator)
    parts = [_token_sums(head_params, h, pk["owner"], n_seqs, activation=activation, **drop)
             for h, pk in zip(hiddens, packs)]
    sums = sum((p[0] for p in parts[1:]), parts[0][0])
    cnt = sum((p[1] for p in parts[1:]), parts[0][1])
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
    if not isinstance(batch, dict) or not any(k in batch for k in ("pep_operm", "pep_packs")):
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
    """Each side's expanded packs and their backbone hidden states in f32,
    as lists over the width tiers (one for flat packing). Every pack runs
    at the same tokens a chunk: rows narrower than the side's widest take
    proportionally more rows a chunk."""
    batch = expand_packed_batch(batch)
    packs = {side: side_packs(batch, side) for side in SIDES}
    hidden = {}
    for side, pks in packs.items():
        l_max = max(p["ids"].shape[1] for p in pks)
        hidden[side] = [_encode_packed_chunked(esm_params, p["ids"], p["seg"], p["pos"], mcfg.esm,
                                               rows_per_chunk * (l_max // p["ids"].shape[1])
                                               ).float()
                        for p in pks]
    return packs, hidden


def _pooled_sides(params, packs, hidden, n_seqs: int, mcfg, *, train: bool,
                  generator: torch.Generator | None = None):
    """(pep_emb, rec_emb) in the batch's pair order, from
    ``_packs_and_hidden``'s packs and hidden states."""
    drop = dict(activation=mcfg.activation, dropout_rate=mcfg.dropout, train=train,
                generator=generator)
    return tuple(_pool_packed(params[side], hidden[side][0], packs[side][0]["owner"], n_seqs,
                              params["temperature"], **drop) if len(packs[side]) == 1
                 else _pool_packs(params[side], hidden[side], packs[side], n_seqs,
                                  params["temperature"], **drop)
                 for side in SIDES)


def make_train_step_packed(cfg, loss_fn: Callable | None = None,
                           rows_per_chunk: int | None = None):
    """The global-batch step over ``tokenize_packed`` batches of
    ``cfg.global_batch`` pairs, with ``clip_engine.make_train_step``'s
    signature; ``loss_fn`` defaults to ``clip_engine.default_loss_fn()``."""
    from .clip_engine import _update, default_loss_fn   # clip_engine imports this module

    check_clip_packed(cfg)
    rows_per_chunk = _default_rows_per_chunk(rows_per_chunk)
    loss_fn = loss_fn or default_loss_fn()
    n_seqs = cfg.global_batch

    def step(params, opt_state, esm_params, batch, generator):
        _validate_packed_batch(batch, n_seqs)
        packs, hidden = _packs_and_hidden(esm_params, batch, cfg.model, rows_per_chunk)
        pep, rec = _pooled_sides(params, packs, hidden, n_seqs, cfg.model, train=True,
                                 generator=generator)
        return _update(loss_fn(pep, rec), params, opt_state)

    return step


def make_eval_step_packed(cfg, loss_fn: Callable | None = None,
                          rows_per_chunk: int | None = None):
    """The packed eval step: the train step's batch path in eval mode and
    with no graph. The pool size is the batch's own (``packed_side_count``),
    so one step serves validation batches of ``cfg.batch_size`` pairs."""
    from .clip_engine import default_loss_fn

    check_clip_packed(cfg)
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
    packs, hidden = _packs_and_hidden(esm_params, batch, mcfg,
                                      _default_rows_per_chunk(rows_per_chunk))
    return _pooled_sides(params, packs, hidden, n_seqs, mcfg, train=False)
