"""Sequence packing: several sequences per row, segment-masked. The port's
copy of ``protein_clip_tpu/data/packing.py`` (NumPy only).

Length-grouped bucketing still pads every sequence to its group's bucket
(about 80% of the tokens filled on Propedia-like lengths). Packing fills
rows to about 95%: first-fit-decreasing places whole tokenized sequences
into rows of a fixed length, and the backbone applies

- block-diagonal attention (tokens attend within their segment only),
- a RoPE position restart at each segment,
- a token-dropout ratio per segment,

and the heads pool per segment, so each packed sequence's embedding is the
one it gets alone (``tests/test_torch_packing.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PackedBatch:
    ids: np.ndarray          # (R, L) int32 token ids, 1 (<pad>) in gaps
    segment_ids: np.ndarray  # (R, L) int32; 0 = empty, 1..K = segment
    positions: np.ndarray    # (R, L) int32; position within the segment
    # back to input order: sequence i is segment owner_seg[i] of row owner_row[i]
    owner_row: np.ndarray    # (N,) int32
    owner_seg: np.ndarray    # (N,) int32
    n_sequences: int

    @property
    def max_segments(self) -> int:
        return int(self.segment_ids.max())


def pack_sequences(encodings: list[np.ndarray], row_len: int,
                   row_multiple: int = 16) -> PackedBatch:
    """First-fit-decreasing packing of tokenized sequences into rows.

    ``encodings``: per-sequence id arrays (<cls> ... <eos>), each at most
    ``row_len`` long. The row count is rounded up to a multiple of
    ``row_multiple`` with all-<pad> rows, so batch shapes repeat."""
    n = len(encodings)
    lengths = [len(e) for e in encodings]
    if max(lengths, default=0) > row_len:
        raise ValueError(f"sequence longer than row_len={row_len}")

    order = sorted(range(n), key=lambda i: -lengths[i])
    rows: list[list[int]] = []
    free: list[int] = []
    for i in order:
        L = lengths[i]
        for r in range(len(rows)):
            if free[r] >= L:
                rows[r].append(i)
                free[r] -= L
                break
        else:
            rows.append([i])
            free.append(row_len - L)

    n_rows = -(-len(rows) // row_multiple) * row_multiple
    ids = np.full((n_rows, row_len), 1, np.int32)       # <pad>
    seg = np.zeros((n_rows, row_len), np.int32)
    pos = np.zeros((n_rows, row_len), np.int32)
    owner_row = np.zeros(n, np.int32)
    owner_seg = np.zeros(n, np.int32)
    for r, members in enumerate(rows):
        cursor = 0
        for k, i in enumerate(members, start=1):
            e = encodings[i]
            ids[r, cursor:cursor + len(e)] = e
            seg[r, cursor:cursor + len(e)] = k
            pos[r, cursor:cursor + len(e)] = np.arange(len(e))
            owner_row[i] = r
            owner_seg[i] = k
            cursor += len(e)
    return PackedBatch(ids, seg, pos, owner_row, owner_seg, n)
