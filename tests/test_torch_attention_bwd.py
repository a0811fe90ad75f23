"""The plain version of kernel K5 (``ops.attention.attention_reference_bwd``,
what the backward of ``fused_attention`` runs on CPU tensors) against the
VJP of the JAX package's Pallas ``fused_attention``, whose backward kernel
runs in interpret mode on the CPU.

Same numpy inputs, float32, head_dim 32, NH = 4, every position compared:
padded rows, rows with every query fully padded (each with a nonzero
cotangent: their uniform softmax feeds dv but, after the re-mask of dS,
neither dq nor dk), and packed segments with gap zeros. Tolerance 1e-5
absolute on gradients of order 1: the same float32 algorithm, summed in
another order (the Pallas kernel walks query blocks and T-minor tiles).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protein_clip_tpu.ops.attention_pallas import fused_attention as jax_fused
from protein_clip_tpu_torch.ops import attention

ATOL = 1e-5
B, NH, DH = 2, 4, 32


def _inputs(T, kind, seed):
    rng = np.random.default_rng(seed)
    q, k = (rng.normal(size=(B, T, NH, DH)).astype(np.float32) * 0.3 for _ in range(2))
    v, do = (rng.normal(size=(B, T, NH, DH)).astype(np.float32) for _ in range(2))
    seg = np.ones((B, T), np.int32)
    if kind == "padded":
        seg[0, T // 2:] = 0
        seg[1, T - 5:] = 0
    elif kind == "fully_padded":
        seg[0, T // 3:] = 0
        seg[1] = 0               # no valid token: every query row is uniform
    else:                        # packed: three segments, gap zeros between
        seg[:] = 0
        seg[:, : T // 4] = 1
        seg[:, T // 4 + 3: T // 2] = 2
        seg[:, T // 2: T - 7] = 3
    return q, k, v, seg, do


def _jax_grads(q, k, v, seg, do):
    _, vjp = jax.vjp(lambda a, b, c: jax_fused(a, b, c, jnp.asarray(seg)),
                     *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


KINDS = ["padded", "fully_padded", "packed"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("T", [64, 128, 200])
def test_plain_bwd_matches_pallas_bwd_interpret(T, kind):
    q, k, v, seg, do = _inputs(T, kind, T)
    got = attention.attention_reference_bwd(*(torch.from_numpy(a) for a in (q, k, v, seg, do)))
    for name, g, w in zip(("dq", "dk", "dv"), got, _jax_grads(q, k, v, seg, do)):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, err_msg=name)


def test_fully_padded_rows_feed_dv_only():
    """A row with no valid token: P is uniform (1/T), so dv is the mean of
    dO over the queries for every key, and dq and dk are exactly 0."""
    q, k, v, seg, do = _inputs(64, "fully_padded", 1)
    dq, dk, dv = attention.attention_reference_bwd(
        *(torch.from_numpy(a) for a in (q, k, v, seg, do)))
    assert not dq[1].any() and not dk[1].any()
    np.testing.assert_allclose(dv[1].numpy(), np.broadcast_to(do[1].mean(0), (64, NH, DH)),
                               atol=ATOL)


@pytest.mark.parametrize("kind", KINDS)
def test_function_backward_on_cpu_is_the_plain_bwd(kind):
    """``fused_attention`` through ``torch.autograd.grad`` on CPU tensors:
    the JAX gradients, with no kernel launched in either direction."""
    q, k, v, seg, do = _inputs(128, kind, 7)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    launches = (attention.fused_attention.launches, attention.fused_attention_bwd.launches)
    out = attention.fused_attention(tq, tk, tv, torch.from_numpy(seg))
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    assert (attention.fused_attention.launches,
            attention.fused_attention_bwd.launches) == launches
    for name, g, w in zip(("dq", "dk", "dv"), grads, _jax_grads(q, k, v, seg, do)):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, err_msg=name)
