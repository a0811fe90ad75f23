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

Below them, an emulation of K5's tile arithmetic (P from K1's statistics,
delta = rowsum(P * dP) in its own sweep, pad queries' dv in closed form,
tiles skipped by segment ranges) against the plain backward and the Pallas
backward on bf16 inputs with the card's tolerance, and the reading that
chose delta's form.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
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


# ---------------------------------------------------------------------------
# K5's tile arithmetic: P from K1's statistics, the pad-query branch, delta,
# and tile skipping by segment ranges (csrc/attention_bwd.cu)
# ---------------------------------------------------------------------------

from test_torch_attention import (  # noqa: E402
    LOG2E, TILE, _overlaps, _segments, _tile_ranges, pad_weight)

# K5's card tolerance (chip_smoke.py): |err| <= 2^-5 rms(ref) + 2e-2 |ref|
# per gradient, the bf16 rounding of P and dS at f32 values that differ by
# the order of their sums.
ATOL_RMS = chip_smoke.ATOL_RMS


def _tile(q, k, v, do, seg, lse, b, qs, ks):
    """One (query tile, key tile) of row b: P from the statistics (0 where
    not allowed), dP and the allowed mask, (NH, queries, keys) each."""
    sq, sk = seg[b, qs], seg[b, ks]
    ok = (sq[:, None] == sk[None, :]) & (sk[None, :] > 0)
    s = torch.einsum("qnd,knd->nqk", q[b, qs], k[b, ks])
    p = torch.where(ok, torch.exp2(s * LOG2E - lse[b, :, qs, None]), 0.0)
    return p, torch.einsum("qnd,knd->nqk", do[b, qs], v[b, ks]), ok


def emulate_k5(q, k, v, seg, do, lse, skip=True, out=None):
    """K5's two launches in f32 (torch), on f32 tensors of bf16 values and
    K1's statistics ``lse``. Launch 1, per 64-query tile over the key tiles
    it meets: delta = rowsum(P * dP) tile by tile (or, given ``out``,
    rowsum(dO * out)), then dS = P (dP - delta) where allowed, in bf16, and
    dq += dS . k. Launch 2, per 64-key tile over the query tiles that meet
    it: dv += bf16(P^T) . dO and dk += dS^T . q; then every key's dv +=
    bf16(1/T) times the pad queries' sum of dO (their uniform P in closed
    form). ``skip=False`` visits every tile pair."""
    B, T, NH, _ = q.shape
    dq, dk, dv = (torch.zeros(B, T, NH, 32) for _ in range(3))
    delta = torch.zeros(B, NH, T)
    tiles = [slice(j, min(T, j + TILE)) for j in range(0, T, TILE)]
    for b in range(B):
        ranges = _tile_ranges(seg[b].numpy(), T)
        for i, qs in enumerate(tiles):
            live = [j for j in range(len(tiles)) if not skip or _overlaps(ranges[i], ranges[j])]
            for j in live:
                p, dp, _ = _tile(q, k, v, do, seg, lse, b, qs, tiles[j])
                delta[b, :, qs] += (p * dp).sum(-1)
            if out is not None:
                delta[b, :, qs] = (do[b, qs] * out[b, qs]).sum(-1).T
            for j in live:
                p, dp, ok = _tile(q, k, v, do, seg, lse, b, qs, tiles[j])
                ds = torch.where(ok, p * (dp - delta[b, :, qs, None]), 0.0).bfloat16().float()
                dq[b, qs] += torch.einsum("nqk,knd->qnd", ds, k[b, tiles[j]])
        for j, ks in enumerate(tiles):
            for i, qs in enumerate(tiles):
                if skip and not _overlaps(ranges[i], ranges[j]):
                    continue
                p, dp, ok = _tile(q, k, v, do, seg, lse, b, qs, ks)
                dv[b, ks] += torch.einsum("nqk,qnd->knd", p.bfloat16().float(), do[b, qs])
                ds = torch.where(ok, p * (dp - delta[b, :, qs, None]), 0.0).bfloat16().float()
                dk[b, ks] += torch.einsum("nqk,qnd->knd", ds, q[b, qs])
        dv[b] += pad_weight(T) * do[b][seg[b] <= 0].sum(0)
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def _bf16_inputs(T, kind, seed):
    rng = np.random.default_rng(seed)
    q, k = (torch.from_numpy(rng.normal(size=(B, T, NH, DH)).astype(np.float32) * 0.3).bfloat16()
            for _ in range(2))
    v, do = (torch.from_numpy(rng.normal(size=(B, T, NH, DH)).astype(np.float32)).bfloat16()
             for _ in range(2))
    seg = _segments(T, kind)
    return q, k, v, seg, do, attention.attention_reference_lse(q, k, seg)


def _least_atol(got, want):
    """The least atol, in units of rms(want), that passes |err| <= atol +
    RTOL |want| (the card check's, chip_smoke.least_atol)."""
    return chip_smoke.least_atol(got, want)[1]


@pytest.mark.parametrize("kind", ["padded", "fully_padded", "packed"])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 200])
def test_k5_tile_arithmetic_matches_plain_and_pallas(kind, T):
    """The emulation of K5 against ``attention_reference_bwd`` and against
    the VJP through JAX's Pallas ``_bwd_kernel`` in interpret mode, both on
    bf16 inputs, with K5's card tolerance; tile skipping equal to visiting
    every tile pair, to the bit."""
    q, k, v, seg, do, lse = _bf16_inputs(T, kind, 30 + T)
    f = [x.float() for x in (q, k, v)]
    got = emulate_k5(*f, seg, do.float(), lse)
    plain = attention.attention_reference_bwd(q, k, v, seg, do)
    _, vjp = jax.vjp(lambda a, b, c: jax_fused(a, b, c, jnp.asarray(seg.numpy())),
                     *(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)))
    pallas = [torch.from_numpy(np.array(g.astype(jnp.float32)))
              for g in vjp(jnp.asarray(do.float().numpy(), jnp.bfloat16))]
    for name, g, w, j in zip(("dq", "dk", "dv"), got, plain, pallas):
        assert _least_atol(g, w) <= ATOL_RMS, name
        assert _least_atol(g, j) <= ATOL_RMS, name
    full = emulate_k5(*f, seg, do.float(), lse, skip=False)
    for g, h in zip(got, full):
        assert torch.equal(g, h)


def test_delta_from_the_bf16_output_breaks_the_tolerance():
    """Why K5's launch 1 sums delta = rowsum(P * dP) in a sweep of its own:
    rowsum(dO * O) from K1's bf16 output would save that sweep, but O's
    bf16 rounding moves delta by more than dS's rounding hides. Printed per
    case: each form's least passing atol (rms units; the tolerance is
    2^-5) and the key-bias gradient's gap, |sum over tokens of dk - the
    plain version's| over the largest |dk| (a per-query error e in delta
    adds -e P to dS, whose row sums then miss 0: the key bias, which
    softmax ignores, loses its cancellation). The f32 form passes every
    case; the bf16 form fails at least one."""
    worst = {"f32": 0.0, "bf16": 0.0}
    for T, kind in ((1, "padded"), (64, "padded"), (65, "packed"), (200, "packed")):
        q, k, v, seg, do, lse = _bf16_inputs(T, kind, 40 + T)
        f = [x.float() for x in (q, k, v)]
        out = attention.attention_reference(q, k, v, seg).float()
        plain = attention.attention_reference_bwd(q, k, v, seg, do)
        bias_ref = plain[1].float().sum(1)
        for form, o in (("f32", None), ("bf16", out)):
            got = emulate_k5(*f, seg, do.float(), lse, out=o)
            need = max(_least_atol(g, w) for g, w in zip(got, plain))
            bias = float((got[1].float().sum(1) - bias_ref).abs().max()) / max(
                float(plain[1].float().abs().max()), 1e-30)
            print(f"T={T} {kind}: delta from {form}: least passing atol {need:.4g} rms(ref), "
                  f"key-bias gap {bias:.4g} of max|dk|")
            worst[form] = max(worst[form], need)
    assert worst["f32"] <= ATOL_RMS < worst["bf16"]
