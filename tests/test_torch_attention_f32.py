"""The arithmetic of the card's f32 attention kernels, K1-f32 and K5-f32
(``csrc/attention_fwd_f32.cu``, ``csrc/attention_bwd_f32.cu``: 3xTF32 on
the tensor cores), emulated in numpy, against the JAX package's Pallas
kernel and its VJP kernel in interpret mode (``fused_attention``,
``_attention_bwd_call``), in f32 at every ESM-2 head dim, with
chip_smoke.py's limit: |err| <= F32_ATOL_RMS rms(ref) + F32_RTOL |ref|.

The emulation: every operand split into hi = tf32(x) and lo = tf32(x - hi)
(the kernels' tf32_rna), a product hi.lo + lo.hi + hi.hi summed in f32 into
a fresh partial per stage of KS streamed rows (64, or 32 at head dim 128);
K1-f32's online softmax over those stages with rounded exponents
(2^(f32(s log2 e) - f32(m log2 e))), O rescaled and the stage's P.V added;
its closed forms: a pad query takes f32(1/T) times v's column sum, a query
with one allowed key (itself) takes v. K5-f32: delta = dO . O in f32, P
from K1-f32's statistics; launch 1 counts each query's allowed keys and
gives a query with one dq = 0, its delta marked +inf for launch 2, which
then gives it dS = 0; the pads' dv in closed form. Skipped tiles are left out of the emulation: a stage whose keys are
all masked leaves O, l and m as they were, bit for bit.

With one TF32 product (hi.hi alone) the same emulation must fail the limit
at every head dim, on segments of 2-8 tokens (a query averages over a few
keys, so P's and v's roundings do not average out): chip_smoke.py holds
the kernels' plain-TF32 fault (attention_f32_tf32) on the same kind of
rows (short_segments).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chip_smoke import F32_ATOL_RMS, F32_RTOL
from protein_clip_tpu.ops.attention_pallas import _attention_bwd_call
from protein_clip_tpu.ops.attention_pallas import fused_attention as jax_fused

HEAD_DIMS = (16, 24, 32, 64, 128)
B, T, NH = 2, 100, 2
LOG2E = np.float32(1.4426950408889634)
KINDS = ("padded", "packed", "short")


def _tf32(x):
    """f32 -> tf32 as the kernels round (tf32_rna), low 13 bits cleared."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)


def _mm(a, b, products):
    """a (M, K) . b (K, N) in f32 as the kernels multiply: 3xTF32 (the two
    small products first) or plain TF32 (products=1), into a fresh partial."""
    ah, bh = _tf32(a), _tf32(b)
    part = ah @ bh
    if products == 3:
        part = (ah @ _tf32(b - bh) + _tf32(a - ah) @ bh) + part
    return part.astype(np.float32)


def _stage_rows(dh):
    return 32 if dh > 64 else 64


def _f32(x):
    return np.asarray(x, np.float32)


def emulate_k1_f32(q, k, v, seg, products=3):
    """K1-f32's output and base-2 log-sum-exp statistics."""
    Bq, Tq, NHq, DH = q.shape
    ks_rows = _stage_rows(DH)
    out = np.zeros_like(q)
    lse = np.zeros((Bq, NHq, Tq), np.float32)
    w_pad = np.float32(1) / np.float32(Tq)
    with np.errstate(all="ignore"):
        for b in range(Bq):
            sq = seg[b]
            pad = sq <= 0
            for h in range(NHq):
                qh, kh, vh = q[b, :, h], k[b, :, h], v[b, :, h]
                m = np.full(Tq, -np.inf, np.float32)
                l = np.zeros(Tq, np.float32)
                cnt = np.zeros(Tq, np.int64)
                acc = np.zeros((Tq, DH), np.float32)
                for k0 in range(0, Tq, ks_rows):
                    ks = slice(k0, min(Tq, k0 + ks_rows))
                    ok = (sq[:, None] == seg[b, ks][None, :]) & (seg[b, ks][None, :] > 0)
                    s = np.where(ok, _mm(qh, kh[ks].T, products), -np.inf).astype(np.float32)
                    cnt += ok.sum(1)
                    mn = np.maximum(m, s.max(1))
                    ml = np.where(mn == -np.inf, np.float32(0), _f32(mn * LOG2E))
                    c = np.exp2(_f32(m * LOG2E) - ml).astype(np.float32)
                    p = np.exp2(_f32(s * LOG2E) - ml[:, None]).astype(np.float32)
                    m = mn
                    l = _f32(l * c + p.sum(1, dtype=np.float32))
                    acc = _f32(acc * c[:, None] + _mm(p, vh[ks], products))
                rows = _f32(acc * _f32(np.float32(1) / l)[:, None])
                rows = np.where((cnt == 1)[:, None], vh, rows)
                out[b, :, h] = np.where(pad[:, None], w_pad * vh.sum(0, dtype=np.float32), rows)
                lse[b, h] = np.where(pad, -np.inf, _f32(m * LOG2E) + np.log2(l))
    return out, lse


def emulate_k5_f32(q, k, v, seg, do, products=3):
    """K5-f32's (dq, dk, dv), fed the emulated K1-f32's output and
    statistics."""
    out, lse = emulate_k1_f32(q, k, v, seg, products)
    delta = np.sum(do * out, axis=-1, dtype=np.float32)
    Tq, rows = q.shape[1], _stage_rows(q.shape[-1])
    dq, dk, dv = (np.zeros_like(q) for _ in range(3))
    w_pad = np.float32(1) / np.float32(Tq)
    with np.errstate(all="ignore"):
        for b in range(q.shape[0]):
            sq = seg[b]
            for h in range(q.shape[2]):
                qh, kh, vh, doh = q[b, :, h], k[b, :, h], v[b, :, h], do[b, :, h]
                L, D = lse[b, h], delta[b, :, h]
                cnt = np.zeros(Tq, np.int64)
                for k0 in range(0, Tq, rows):      # launch 1: per query, over key stages
                    ks = slice(k0, min(Tq, k0 + rows))
                    ok = (sq[:, None] == sq[ks][None, :]) & (sq[ks][None, :] > 0)
                    s = _mm(qh, kh[ks].T, products)
                    dp = _mm(doh, vh[ks].T, products)
                    p = np.where(ok, np.exp2(_f32(s * LOG2E) - L[:, None]), 0).astype(np.float32)
                    cnt += ok.sum(1)
                    ds = np.where(ok, p * (dp - D[:, None]), 0).astype(np.float32)
                    dq[b, :, h] += _mm(ds, kh[ks], products)
                dq[b, cnt == 1, h] = 0
                marked = np.where(cnt == 1, np.inf, D).astype(np.float32)
                for q0 in range(0, Tq, rows):      # launch 2: per key, over query stages
                    qs = slice(q0, min(Tq, q0 + rows))
                    ok = (sq[:, None] == sq[qs][None, :]) & (sq[:, None] > 0)
                    st = _mm(kh, qh[qs].T, products)
                    dpt = _mm(vh, doh[qs].T, products)
                    e = np.exp2(_f32(st * LOG2E) - L[qs][None, :]).astype(np.float32)
                    pt = np.where(ok, e, 0).astype(np.float32)
                    keep = ok & np.isfinite(marked[qs])[None, :]
                    dst = np.where(keep, e * (dpt - marked[qs][None, :]), 0).astype(np.float32)
                    dv[b, :, h] += _mm(pt, doh[qs], products)
                    dk[b, :, h] += _mm(dst, qh[qs], products)
                if (sq <= 0).any():
                    dv[b, :, h] += w_pad * doh[sq <= 0].sum(0, dtype=np.float32)
    return dq, dk, dv


def _segments(kind, seed):
    """(B, T) int32: "padded" (lengths 37 and T), "packed" (segments of
    9-40 tokens and gap zeros), "short" (segments of 2-8 tokens, a gap
    zero between some), "one_token" (segments of 1 token between longer
    ones, and a pad row)."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((B, T), np.int32)
    if kind == "padded":
        seg[0, :37] = 1
        seg[1] = 1
        return seg
    lengths = {"packed": (9, 41), "short": (2, 9), "one_token": (1, 2)}[kind]
    for b in range(B if kind != "one_token" else B - 1):
        pos, sid = 0, 1
        while pos < T:
            n = int(rng.integers(*lengths)) if kind != "one_token" or sid % 2 else 5
            seg[b, pos:pos + n] = sid
            pos += n + int(rng.integers(0, 2))
            sid += 1
    return seg


@functools.cache
def _case(dh, kind):
    """The numpy inputs (q scaled by dh^-0.5, as the model feeds the kernel)."""
    rng = np.random.default_rng(dh * 10 + KINDS.index(kind) if kind in KINDS else dh)
    q = (rng.normal(size=(B, T, NH, dh)) * dh ** -0.5).astype(np.float32)
    k, v, do = (rng.normal(size=(B, T, NH, dh)).astype(np.float32) for _ in range(3))
    return q, k, v, _segments(kind, dh), do


_pallas_bwd = jax.jit(_attention_bwd_call)


@functools.cache
def _jax_fwd(dh, kind):
    q, k, v, seg, _ = _case(dh, kind)
    return np.asarray(jax_fused(*(jnp.asarray(a) for a in (q, k, v, seg))))


@functools.cache
def _jax_bwd(dh, kind):
    q, k, v, seg, do = _case(dh, kind)
    return [np.asarray(g) for g in _pallas_bwd(*(jnp.asarray(a) for a in (q, k, v, seg, do)))]


def _over_limit(got, want):
    """The largest |got - want| over chip_smoke.py's f32 limit."""
    limit = F32_ATOL_RMS * np.sqrt(np.mean(np.square(want))) + F32_RTOL * np.abs(want)
    return float((np.abs(got - want) / limit).max())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_emulated_k1_f32_matches_the_pallas_kernel(dh, kind):
    q, k, v, seg, _ = _case(dh, kind)
    got, lse = emulate_k1_f32(q, k, v, seg)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert _over_limit(got, _jax_fwd(dh, kind)) <= 1


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_emulated_k5_f32_matches_the_pallas_vjp(dh, kind):
    got = emulate_k5_f32(*_case(dh, kind))
    for g, w in zip(got, _jax_bwd(dh, kind)):
        assert np.isfinite(g).all()
        assert _over_limit(g, w) <= 1


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_emulated_plain_tf32_fails_the_limit(dh):
    """One TF32 product a k-step fails on segments of 2-8 tokens, forward
    and backward alike."""
    q, k, v, seg, do = _case(dh, "short")
    assert _over_limit(emulate_k1_f32(q, k, v, seg, products=1)[0], _jax_fwd(dh, "short")) > 1
    got = emulate_k5_f32(q, k, v, seg, do, products=1)
    assert max(_over_limit(g, w) for g, w in zip(got, _jax_bwd(dh, "short"))) > 1


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_one_allowed_key_is_exact(dh):
    """A query whose segment is itself alone: O = v and dq = dk = 0 to the
    bit, as the softmax and its gradient give them (the plain versions'
    exact zeros, which an rms-scaled limit cannot hold)."""
    q, k, v, seg, do = _case(dh, "one_token")
    alone = np.zeros((B, T), bool)
    for b in range(B):
        ids, counts = np.unique(seg[b], return_counts=True)
        alone[b] = np.isin(seg[b], ids[(counts == 1) & (ids > 0)])
    assert alone.sum() >= 10
    out, _ = emulate_k1_f32(q, k, v, seg)
    assert np.array_equal(out[alone], v[alone])
    dq, dk, dv = emulate_k5_f32(q, k, v, seg, do)
    assert not dq[alone].any() and not dk[alone].any()
    assert np.isfinite(dv).all()
