"""The plain version of kernel K1 (``ops.attention.attention_reference``,
what ``fused_attention`` runs on CPU tensors) against the JAX package's
Pallas kernel in interpret mode and its ``_eager_reference``.

Same numpy inputs, float32, every position compared (fully padded query
rows included: they softmax to a uniform average of v). Tolerance 1e-5
absolute: the same float32 algorithm, summed in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protein_clip_tpu.ops.attention_pallas import _eager_reference, fused_attention as jax_fused
from protein_clip_tpu_torch.ops import attention

ATOL = 1e-5


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


@pytest.mark.parametrize("kind", sorted(CASES))
def test_plain_matches_pallas_kernel_interpret(kind):
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, 2, 128)
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
    before = attention.fused_attention.launches
    out = attention.fused_attention(q, k, v, seg)
    assert attention.fused_attention.launches == before
    torch.testing.assert_close(out, attention.attention_reference(q, k, v, seg),
                               rtol=0, atol=0)


def test_other_devices_are_refused():
    q = torch.empty(1, 8, 2, 32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        attention.fused_attention(q, q, q, torch.empty(1, 8, dtype=torch.int32, device="meta"))
