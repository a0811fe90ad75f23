"""bf16 K1's card check on chunks of mostly <pad> rows, emulated on the CPU.

``chip_smoke.check_attention`` holds K1 to |err| <= 2^-5 rms(ref) + 2e-2
|ref|. A pad query's output is the mean of v's column (about 1/sqrt(T) of
a valid query's), so on a chunk whose rows are mostly <pad> (width tiers'
placeholder and ratchet rows, a packed side's last chunk) an rms over the
whole chunk shrinks while the valid rows keep P's bf16 rounding: the card
read 0.0341 rms(ref) on such a chunk once (2 of 16 rows real). The check
takes rms(ref) over the valid queries' outputs (``chip_smoke.least_atol``
with the segment ids); here, over seeded draws of (16, 256) chunks at
t30_150M's NH 20 and DH 32 with 0, 2, 14 and 16 of 16 rows real, K1's
arithmetic (``test_torch_attention.emulate_k1``: the online softmax, P
rounded to bf16 after the rescale) passes that form with room, and a K1
that drops the last 64-key tile fails it on every chunk whose last tile
holds a valid key.

    python tests/test_torch_attention_pad.py 40     # the readings over 40 draws a chunk kind
"""

import sys

import numpy as np
import pytest
import torch

import chip_smoke
from protein_clip_tpu_torch.ops import attention
from test_torch_attention import emulate_k1

B, T, NH, DH = 16, 256, 20, 32
REAL_ROWS = (0, 2, 14, 16)


def chunk(rng: np.random.Generator, real: int) -> torch.Tensor:
    """(16, 256) segment ids: ``real`` rows packed with segments of 40-249
    tokens (a row of one segment where none fits), the rest all <pad>."""
    seg = np.zeros((B, T), np.int32)
    for b in range(real):
        pos, sid = 0, 1
        while True:
            n = int(rng.integers(40, 250))
            if pos + n > T:
                break
            seg[b, pos:pos + n] = sid
            pos, sid = pos + n, sid + 1
        if sid == 1:
            seg[b, :T - 3] = 1
    return torch.from_numpy(seg)


def draw(s: int, real: int):
    """Draw s of a chunk kind: (q, k, v) in bf16 as chip_smoke.qkv draws
    them, and the segment ids."""
    g = torch.Generator().manual_seed(s)
    q = (DH ** -0.5 * torch.randn(B, T, NH, DH, generator=g)).bfloat16()
    k = torch.randn(B, T, NH, DH, generator=g).bfloat16()
    v = torch.randn(B, T, NH, DH, generator=g).bfloat16()
    return q, k, v, chunk(np.random.default_rng(1000 + s), real)


def drop_last_key_tile(q, k, v, seg):
    """K1 with its swept key loop one tile short: the plain version with the
    last 64 keys masked for every query that keeps another key."""
    allowed, _ = attention._probs(q, k, seg)
    cut = allowed.clone()
    cut[..., T - 64:] = False
    keep = cut.any(-1, keepdim=True)
    cut = torch.where(keep, cut, allowed)
    s = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
    p = torch.softmax(torch.where(cut, s, torch.finfo(torch.float32).min), -1).bfloat16()
    return torch.einsum("bnqk,bknd->bqnd", p.float(), v.float()).bfloat16()


def readings(s: int, real: int) -> dict:
    """The least passing atol (rms(ref) units) of the emulated K1 in both
    forms (the valid queries' rms, the chunk's), and of the planted fault
    where the chunk's last key tile holds a valid key (else None: dropping
    that tile changes nothing)."""
    q, k, v, seg = draw(s, real)
    want = attention.attention_reference(q, k, v, seg)
    got, _ = emulate_k1(q.float(), k.float(), v.float(), seg)
    seen = bool((seg[:, T - 64:] > 0).any())
    return {"valid": chip_smoke.least_atol(got, want, chip_smoke.RTOL, seg)[1],
            "chunk": chip_smoke.least_atol(got, want, chip_smoke.RTOL)[1],
            "fault": chip_smoke.least_atol(drop_last_key_tile(q, k, v, seg), want,
                                           chip_smoke.RTOL, seg)[1] if seen else None}


@pytest.mark.parametrize("s", range(3))
@pytest.mark.parametrize("real", REAL_ROWS)
def test_k1_form_on_mostly_pad_chunks(real, s):
    """The emulated kernel within 3/4 of ATOL_RMS of the valid queries'
    rms; the dropped-tile fault past ATOL_RMS wherever the last key tile
    holds a valid key (every chunk of 14 or 16 real rows); a chunk of <pad>
    alone equal to its plain version (both bf16(1/T) times v's column
    sum)."""
    r = readings(s, real)
    assert r["valid"] <= 0.75 * chip_smoke.ATOL_RMS, r
    assert r["fault"] is not None or real in (0, 2), r
    if r["fault"] is not None:
        assert r["fault"] > chip_smoke.ATOL_RMS, r
    if not real:
        assert r["valid"] <= 0 and r["chunk"] <= 0, r


def test_chunk_wide_rms_is_the_fragile_scale():
    """On chunks of 2 real rows in 16 the chunk-wide rms asks for more than
    the valid rows' (the pad rows' small outputs shrink it); on full chunks
    the two are close."""
    sparse = [readings(s, 2) for s in range(3)]
    full = [readings(s, 16) for s in range(2)]
    assert all(r["chunk"] > 1.4 * r["valid"] for r in sparse), sparse
    assert all(r["chunk"] < 1.3 * r["valid"] for r in full), full


def main(draws: int) -> None:
    torch.set_num_threads(4)
    for real in REAL_ROWS:
        got = [readings(s, real) for s in range(draws)]
        rows = np.array([[r["valid"], r["chunk"]] for r in got])
        faults = [r["fault"] for r in got if r["fault"] is not None]
        print(f"{real:2d} of 16 rows real, {draws} draws: valid rows' rms max "
              f"{rows[:, 0].max():.5f} median {np.median(rows[:, 0]):.5f}; chunk-wide rms max "
              f"{rows[:, 1].max():.5f} median {np.median(rows[:, 1]):.5f}; dropped last key "
              f"tile on the {len(faults)} draws whose last tile holds a valid key: min "
              f"{min(faults, default=float('nan')):.5f} (limit {chip_smoke.ATOL_RMS})",
              flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 40)
