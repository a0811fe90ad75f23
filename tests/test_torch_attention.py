"""The plain version of kernel K1 (``ops.attention.attention_reference``,
what ``fused_attention`` runs on CPU tensors) against the JAX package's
Pallas kernel in interpret mode and its ``_eager_reference``.

Same numpy inputs, float32, every position compared (fully padded query
rows included: they softmax to a uniform average of v). Tolerance 1e-5
absolute: the same float32 algorithm, summed in another order. The kernel
comparisons run at every ESM-2 head dim (t30_150M's 32, and 16, 24, 64,
128: the other families'), which the CUDA kernels take.

Below them, K1's second output and its tile arithmetic before the card
sees them: ``attention_reference_lse`` against JAX's logsumexp of the
masked scores, and an emulation of the kernel (online softmax over 64-key
tiles, ex2 form, pad queries in closed form, tiles skipped by segment
ranges) against ``_eager_reference`` with the card's tolerance, skipping
equal to visiting every tile to the bit.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protein_clip_tpu.ops.attention_pallas import _eager_reference, fused_attention as jax_fused
from protein_clip_tpu_torch.ops import attention

ATOL = 1e-5
# ESM-2's head dims, t30_150M's first: its cases keep the ids they had
# before the kernels took the others.
HEAD_DIMS = (32, 16, 24, 64, 128)


def over_head_dims(names: str, cases, short=None) -> pytest.MarkDecorator:
    """parametrize ``names`` and ``dh`` over cases x HEAD_DIMS (the cases
    ``short`` takes at the other head dims: the rest are slow in interpret
    mode): a case at head dim 32 keeps its own id, the others add
    "-dh<n>"."""
    params = []
    for case in cases:
        case = case if isinstance(case, tuple) else (case,)
        base = "-".join(map(str, case))
        params += [pytest.param(*case, dh, id=base if dh == 32 else f"{base}-dh{dh}")
                   for dh in HEAD_DIMS if dh == 32 or short is None or short(*case)]
    return pytest.mark.parametrize(f"{names},dh", params)


def _qkv(rng, B, T, NH=4, DH=32):
    q = rng.normal(size=(B, T, NH, DH)).astype(np.float32) * 0.3
    k = rng.normal(size=(B, T, NH, DH)).astype(np.float32) * 0.3
    v = rng.normal(size=(B, T, NH, DH)).astype(np.float32)
    return q, k, v


def _padded(B, T):
    seg = np.ones((B, T), np.int32)
    seg[0, T // 2:] = 0
    seg[-1, T - 5:] = 0
    return seg


def _packed(B, T):
    seg = np.zeros((B, T), np.int32)
    seg[:, : T // 4] = 1
    seg[:, T // 4 + 3: T // 2] = 2   # 3-token gap of zeros before it
    seg[:, T // 2: T - 7] = 3        # trailing gap
    return seg


CASES = {"padded": _padded, "packed": _packed}


def _both(q, k, v, seg):
    got = attention.fused_attention(*(torch.from_numpy(a) for a in (q, k, v, seg))).numpy()
    return got, [jnp.asarray(a) for a in (q, k, v, seg)]


@over_head_dims("kind", sorted(CASES))
def test_plain_matches_pallas_kernel_interpret(kind, dh):
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, 2, 128, DH=dh)
    seg = CASES[kind](2, 128)
    got, jargs = _both(q, k, v, seg)
    np.testing.assert_allclose(got, np.asarray(jax_fused(*jargs)), atol=ATOL)


@pytest.mark.parametrize("kind", sorted(CASES))
@pytest.mark.parametrize("T", [32, 100, 256])
def test_plain_matches_eager_reference(kind, T):
    rng = np.random.default_rng(T)
    q, k, v = _qkv(rng, 2, T)
    seg = CASES[kind](2, T)
    got, jargs = _both(q, k, v, seg)
    np.testing.assert_allclose(got, np.asarray(_eager_reference(*jargs)), atol=ATOL)


def test_fully_padded_rows_are_uniform_means():
    """A query row with no allowed key averages v over all T keys."""
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, 1, 16)
    seg = np.zeros((1, 16), np.int32)
    seg[0, :6] = 1
    got, _ = _both(q, k, v, seg)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[0, 6:], np.broadcast_to(v[0].mean(0), (10, 4, 32)),
                               atol=ATOL)


def test_segments_block_cross_attention():
    """Per segment, the packed result equals that segment run alone."""
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, 1, 64)
    seg = np.zeros((1, 64), np.int32)
    seg[0, :20], seg[0, 20:45] = 1, 2
    packed, _ = _both(q, k, v, seg)
    for lo, hi in ((0, 20), (20, 45)):
        solo, _ = _both(q[:, lo:hi], k[:, lo:hi], v[:, lo:hi], np.ones((1, hi - lo), np.int32))
        np.testing.assert_allclose(packed[:, lo:hi], solo, atol=ATOL)


def test_bf16_plain_matches_eager_reference_bf16():
    """bf16 operands: both keep f32 scores and softmax and round P and the
    output to bf16 (tolerance: 2 bf16 ulps of unit-scale outputs)."""
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 2, 64)
    seg = _padded(2, 64)
    t = [torch.from_numpy(a).bfloat16() for a in (q, k, v)]
    got = attention.fused_attention(*t, torch.from_numpy(seg)).float().numpy()
    jargs = [jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in t]
    want = np.asarray(_eager_reference(*jargs, jnp.asarray(seg)).astype(jnp.float32))
    np.testing.assert_allclose(got, want, atol=2 ** -6)


def test_cpu_tensors_take_the_plain_version_without_launching():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 8))
    seg = torch.ones(1, 8, dtype=torch.int32)
    before = attention.launches["attention_fwd"]
    out = attention.fused_attention(q, k, v, seg)
    assert attention.launches["attention_fwd"] == before
    torch.testing.assert_close(out, attention.attention_reference(q, k, v, seg),
                               rtol=0, atol=0)


def test_other_devices_are_refused():
    q = torch.empty(1, 8, 2, 32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        attention.fused_attention(q, q, q, torch.empty(1, 8, dtype=torch.int32, device="meta"))


# ---------------------------------------------------------------------------
# K1's second output and its tile arithmetic
# ---------------------------------------------------------------------------

LOG2E = 1.4426950408889634
TILE = 64   # the kernels' tile of queries or keys


@pytest.mark.parametrize("kind", sorted(CASES) + ["fully_padded"])
@pytest.mark.parametrize("T", [1, 63, 65, 200])
def test_reference_lse_matches_jax_logsumexp(kind, T):
    """``attention_reference_lse`` (K1's statistics: the base-2 log-sum-exp
    of each query's masked scores) against log2(e) times JAX's logsumexp of
    ``_eager_reference``'s masked scores. f32, tolerance 1e-5 absolute on
    values of a few units (the same sums in another order); a pad query
    reads -inf in both (f32-min times log2(e))."""
    rng = np.random.default_rng(10 + T)
    q, k, _ = _qkv(rng, 2, T)
    seg = CASES[kind](2, T) if kind in CASES else np.ones((2, T), np.int32)
    if kind == "fully_padded":
        seg[1] = 0
    got = attention.attention_reference_lse(torch.from_numpy(q), torch.from_numpy(k),
                                            torch.from_numpy(seg)).numpy()
    jq, jk, js = jnp.asarray(q), jnp.asarray(k), jnp.asarray(seg)
    scores = jnp.einsum("bqnd,bknd->bnqk", jq, jk, preferred_element_type=jnp.float32)
    allowed = (js[:, None, :, None] == js[:, None, None, :]) & (js[:, None, None, :] > 0)
    masked = jnp.where(allowed, scores, jnp.finfo(jnp.float32).min)
    want = np.asarray(jax.nn.logsumexp(masked, axis=-1) * LOG2E)
    assert np.array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, atol=1e-5)


def _tile_ranges(seg_row, T):
    """Per 64-token tile: (smallest nonzero segment id, largest id, has a
    pad), the empty range being (inf, 0), as csrc/attention.cuh keeps it."""
    out = []
    for j in range(0, T, TILE):
        ids = seg_row[j:j + TILE]
        valid = ids[ids > 0]
        out.append((int(valid.min()) if len(valid) else np.inf,
                    int(valid.max()) if len(valid) else 0, bool((ids <= 0).any())))
    return out


def _overlaps(a, b):
    return a[0] <= b[1] and b[0] <= a[1]


def pad_weight(T):
    """A pad query's softmax weight as the kernels use it: 1/T in bf16."""
    return torch.tensor(1.0 / T).bfloat16().float()


def emulate_k1(q, k, v, seg, skip=True):
    """K1's arithmetic in f32 (torch): per 64-query tile an online softmax
    over the 64-key tiles it meets, masked scores -inf, P = 2^(s log2(e) -
    m log2(e)), O rescaled by 2^((m_old - m) log2(e)) before += bf16(P).V;
    O / l in bf16 and lse = m log2(e) + log2(l). A pad query takes the
    closed form bf16(1/T) times the column sum of v, and lse -inf.
    ``skip=False`` visits every key tile."""
    B, T, NH, DH = q.shape
    out = torch.zeros(B, T, NH, DH)
    lse = torch.zeros(B, NH, T)
    for b in range(B):
        ranges = _tile_ranges(seg[b].numpy(), T)
        for i, q0 in enumerate(range(0, T, TILE)):
            qs = slice(q0, min(T, q0 + TILE))
            sq = seg[b, qs]
            pad = sq <= 0
            m = torch.full((NH, len(sq)), -math.inf)
            l = torch.zeros(NH, len(sq))
            acc = torch.zeros(NH, len(sq), DH)
            for j, k0 in enumerate(range(0, T, TILE)):
                if skip and not _overlaps(ranges[i], ranges[j]):
                    continue
                ks = slice(k0, min(T, k0 + TILE))
                sk = seg[b, ks]
                ok = (sq[:, None] == sk[None, :]) & (sk[None, :] > 0)
                s = torch.einsum("qnd,knd->nqk", q[b, qs], k[b, ks])
                s = torch.where(ok, s, -math.inf)
                mn = torch.maximum(m, s.amax(-1))
                ml = torch.where(mn == -math.inf, 0.0, mn * LOG2E)
                c = torch.exp2(m * LOG2E - ml)
                p = torch.exp2(s * LOG2E - ml[..., None])
                m, l = mn, l * c + p.sum(-1)
                acc = acc * c[..., None] + torch.einsum(
                    "nqk,knd->nqd", p.bfloat16().float(), v[b, ks])
            rows = (acc / l[..., None]).permute(1, 0, 2)
            out[b, qs] = torch.where(pad[:, None, None], pad_weight(T) * v[b].sum(0), rows)
            lse[b, :, qs] = torch.where(pad, -math.inf, m * LOG2E + torch.log2(l))
    return out.bfloat16(), lse


@pytest.mark.parametrize("kind", ["padded", "fully_padded", "packed"])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 200])
def test_k1_tile_arithmetic_matches_eager_reference(kind, T):
    """The emulation of K1 against JAX's ``_eager_reference`` on bf16
    inputs, with K1's card tolerance (chip_smoke.py: |err| <= 2^-5 rms(ref)
    + 2e-2 |ref|: P rounded to bf16 after the online form's rescale against
    before it, and bf16 outputs); its statistics against
    ``attention_reference_lse`` (1e-5: the same f32 sums in tiles); and
    tile skipping equal to visiting every tile, to the bit."""
    rng = np.random.default_rng(20 + T)
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(rng, 2, T))
    seg = _segments(T, kind)
    got, lse = emulate_k1(q.float(), k.float(), v.float(), seg)
    want = np.asarray(_eager_reference(
        *(jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in (q, k, v)),
        jnp.asarray(seg.numpy())).astype(jnp.float32))
    err = np.abs(got.float().numpy() - want)
    rms = float(np.sqrt(np.square(want).mean()))
    assert (err <= 2 ** -5 * rms + 2e-2 * np.abs(want)).all(), float(err.max())
    ref_lse = attention.attention_reference_lse(q, k, seg)
    assert torch.equal(torch.isinf(lse), torch.isinf(ref_lse))
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-5)
    full, full_lse = emulate_k1(q.float(), k.float(), v.float(), seg, skip=False)
    assert torch.equal(got, full) and torch.equal(lse, full_lse)


def _segments(T, kind):
    """(2, T) segments for the tile emulations: "padded" (lengths T/2 and
    T - 5, at least 1), "fully_padded" (a row of length T/3 and a row of
    pads), "packed" (three segments and gaps, boundaries inside tiles)."""
    seg = np.zeros((2, T), np.int32)
    if kind == "padded":
        seg[0, :max(1, T // 2)] = 1
        seg[1, :max(1, T - 5)] = 1
    elif kind == "fully_padded":
        seg[0, :max(1, T // 3)] = 1
    else:
        seg[:, : max(1, T // 4)] = 1
        seg[:, T // 4 + 3: T // 2] = 2
        seg[:, T // 2: T - 7] = 3
    return torch.from_numpy(seg)
