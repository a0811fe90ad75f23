"""The port's FILIP heads and masked max-sim against the JAX package's, on
the CPU in float32, with inputs made from a numpy seed.

The JAX ``filip_similarity_fused`` runs its Pallas kernel in interpret mode
here, as ``tests/test_pallas_filip.py`` runs it; the port's wrapper runs its
plain version on CPU tensors. Both are means of f32 dot products of unit
vectors summed in another order: atol 2e-6. The lax oracle
``models/filip.filip_similarity`` does not clamp a max over no valid token
to 0, so it is compared only on pairs whose rows both have a valid token.

The CUDA kernel K4 computes its products in 3xTF32 on the tensor cores.
A numpy emulation of that arithmetic (the same split into a rounded tf32
hi and lo, three products accumulated in f32) is held against the JAX
kernel within ``chip_smoke.K4_ATOL``, the tolerance the card's check uses,
and plain TF32 is shown to fail it on the check's short inputs of norm 2.
``chip_smoke.maxsim_work``, which K4's bound on the card is computed from,
is held against a count by hand.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from protein_clip_tpu.models import filip as jfilip
from protein_clip_tpu.models import heads as jheads
from protein_clip_tpu.ops import filip_pallas as jops
from protein_clip_tpu_torch.models import filip, heads
from protein_clip_tpu_torch.ops import filip as ops
from protein_clip_tpu_torch.train import checkpoint

ATOL = 2e-6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _tokens(seed, Ba, Bb, TA, TB, D=128, empty_rows=False, holes=False):
    """Unit tokens and masks with padded rows; ``empty_rows``: an a-row and
    a b-row with no valid token; ``holes``: tokens 64-127 masked in every
    row of both sides but the first (an all-zero tile mid-row)."""
    rng = np.random.default_rng(seed)
    ha = _unit(rng.normal(size=(Ba, TA, D)))
    hb = _unit(rng.normal(size=(Bb, TB, D)))
    ma = np.ones((Ba, TA), np.int32)
    mb = np.ones((Bb, TB), np.int32)
    ma[1 % Ba, TA // 2:] = 0
    ma[2 % Ba, 3:] = 0
    mb[0, TB - 10:] = 0
    mb[3 % Bb, 5:] = 0
    if holes:
        ma[1:, 64:128] = 0
        mb[1:, 64:128] = 0
    if empty_rows:
        ma[Ba - 1] = 0
        mb[Bb - 2] = 0
    return ha, hb, ma, mb


CASES = {
    "square": (4, 4, 32, 64, False, False),
    "rectangular_ta_ne_tb": (3, 5, 40, 72, False, False),
    "tb_1024": (2, 3, 64, 1024, False, False),
    "all_masked_rows": (4, 5, 32, 64, True, False),
    "zero_tile_mid_row": (3, 4, 200, 260, False, True),
    "zero_tile_and_masked_rows": (4, 5, 192, 130, True, True),
}


def _both(case, t):
    Ba, Bb, TA, TB, empty, holes = CASES[case]
    ha, hb, ma, mb = _tokens(len(case), Ba, Bb, TA, TB, empty_rows=empty, holes=holes)
    got = ops.filip_similarity_fused(torch.from_numpy(ha), torch.from_numpy(hb),
                                     torch.from_numpy(ma), torch.from_numpy(mb), t)
    want = jops.filip_similarity_fused(jnp.asarray(ha), jnp.asarray(hb), jnp.asarray(ma),
                                       jnp.asarray(mb), jnp.asarray(t, jnp.float32))
    return (ha, hb, ma, mb), [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("t", [1.0, 0.7])
@pytest.mark.parametrize("case", list(CASES))
def test_fused_matches_jax_fused_and_lax(case, t):
    launches = ops.filip_similarity_fused.launches
    (ha, hb, ma, mb), got, want = _both(case, t)
    assert ops.filip_similarity_fused.launches == launches  # the CPU runs no kernel
    for g, w in zip(got, want):
        assert g.shape == w.shape == (ha.shape[0], hb.shape[0]) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
    lax = jfilip.filip_similarity(jnp.asarray(ha), jnp.asarray(hb), jnp.asarray(ma),
                                  jnp.asarray(mb), jnp.asarray(t, jnp.float32))
    both = (ma.sum(1) > 0)[:, None] & (mb.sum(1) > 0)[None, :]
    for g, w in zip(got, lax):
        np.testing.assert_allclose(g[both], np.asarray(w)[both], atol=ATOL, rtol=0)
    if not both.all():  # the clamp: a row with no valid token scores 0, not -inf
        for g in got:
            assert np.isfinite(g).all() and (g[~both] == 0).all()


@pytest.mark.parametrize("case", list(CASES))
def test_fused_floors_the_temperature_like_jax(case):
    """t = 1e-5 divides by the floor 1e-4; the scores scale by 1e4, so
    relative 1e-5."""
    _, got, want = _both(case, 1e-5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=0)
    assert ops.clamped_temperature(1e-5) == jops.clamped_temperature(1e-5) == 1e-4
    assert ops.clamped_temperature(0.7) == jops.clamped_temperature(0.7)


def test_maxsim_reference_is_the_raw_score():
    ha, hb, ma, mb = (torch.from_numpy(a) for a in _tokens(7, 3, 4, 20, 33))
    raw = ops.maxsim_reference(ha, hb, ma, mb)
    fused = ops.filip_similarity_fused(ha, hb, ma, mb, torch.tensor(0.5))
    for r, f in zip(raw, fused):
        torch.testing.assert_close(r / 0.5, f, atol=0, rtol=0)


def _tf32(x):
    """f32 -> tf32 as the kernel rounds (cvt.rna: to nearest, ties away from
    zero, on the magnitude's bits), in f32 with the low 13 bits cleared."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)


def _emulated_maxsim(ha, hb, ma, mb, products=3):
    """K4's arithmetic in numpy: each operand split into hi = tf32(x) and
    lo = tf32(x - hi); hi.hi + hi.lo + lo.hi (products=3), or hi.hi alone
    (plain TF32), accumulated in f32; then the masked max-sim with the clamp
    and the means (raw scores, t = 1)."""
    (Ba, TA, D), (Bb, TB, _) = ha.shape, hb.shape
    a, b = ha.reshape(-1, D), hb.reshape(-1, D)
    ah, bh = _tf32(a), _tf32(b)
    s = ah @ bh.T
    if products == 3:
        s = s + ah @ _tf32(b - bh).T + _tf32(a - ah) @ bh.T
    s = s.reshape(Ba, TA, Bb, TB).transpose(0, 2, 1, 3)              # (Ba, Bb, TA, TB)
    valid = (ma[:, None, :, None] * mb[None, :, None, :]) > 0
    s = np.where(valid, s, np.float32(np.finfo(np.float32).min))
    row, col = s.max(3), s.max(2)
    row = np.where(row <= np.finfo(np.float32).min, 0, row)
    col = np.where(col <= np.finfo(np.float32).min, 0, col)
    oa = (row * ma[:, None, :]).sum(2) / np.maximum(ma.sum(1), 1e-6)[:, None]
    ob = (col * mb[None, :, :]).sum(2) / np.maximum(mb.sum(1), 1e-6)[None, :]
    return oa.astype(np.float32), ob.astype(np.float32)


def _jax_raw(ha, hb, ma, mb):
    return [np.asarray(w) for w in jops.filip_similarity_fused(
        jnp.asarray(ha), jnp.asarray(hb), jnp.asarray(ma), jnp.asarray(mb),
        jnp.asarray(1.0, jnp.float32))]


@pytest.mark.parametrize("Ba,Bb,TA,TB", [(2, 3, 130, 257), (1, 5, 64, 512)])
def test_3xtf32_emulation_matches_jax_within_the_card_tolerance(Ba, Bb, TA, TB):
    ha, hb, ma, mb = _tokens(Ba + TB, Ba, Bb, TA, TB, empty_rows=Ba > 1, holes=True)
    got = _emulated_maxsim(ha, hb, ma, mb)
    for g, w in zip(got, _jax_raw(ha, hb, ma, mb)):
        assert np.abs(g - w).max() <= chip_smoke.K4_ATOL / 10


def test_plain_tf32_fails_the_card_tolerance_on_short_rows_of_norm_two():
    """chip_smoke.py's K4_SHORT_SHAPES inputs in small: tokens of norm 2,
    1-4 valid tokens a row. There plain TF32 misses K4_ATOL (the planted
    fault maxsim_tf32), and 3xTF32 meets it by far."""
    rng = np.random.default_rng(5)
    Ba, Bb, TA, TB = 4, 24, 16, 64
    ha = chip_smoke.K4_SHORT_SCALE * _unit(rng.normal(size=(Ba, TA, 128)))
    hb = chip_smoke.K4_SHORT_SCALE * _unit(rng.normal(size=(Bb, TB, 128)))
    ma = (np.arange(TA)[None] < rng.integers(1, 5, (Ba, 1))).astype(np.int32)
    mb = (np.arange(TB)[None] < rng.integers(1, 5, (Bb, 1))).astype(np.int32)
    want = _jax_raw(ha, hb, ma, mb)
    gap = {k: max(np.abs(g - w).max() for g, w in zip(_emulated_maxsim(ha, hb, ma, mb, k), want))
           for k in (1, 3)}
    assert gap[3] <= chip_smoke.K4_ATOL / 10 < chip_smoke.K4_ATOL < gap[1]


def test_maxsim_bound_counts_allowed_pairs_and_valid_tokens():
    """chip_smoke.maxsim_work on masks small enough to count by hand: 0/1
    masks, then signed ones (a pair is allowed where ma * mb > 0)."""
    ma = torch.tensor([[1, 1, 0], [0, 0, 0]], dtype=torch.int32)         # Ba 2, TA 3
    mb = torch.tensor([[1, 0], [1, 1], [0, 0]], dtype=torch.int32)       # Bb 3, TB 2
    work = chip_smoke.maxsim_work(ma, mb, 8)
    # pairs: a-row 0's 2 valid tokens against the 3 valid b-tokens; a-row 1 none
    assert work["pairs"] == 6
    assert work["flops"] == 3 * 2 * 8 * 6
    # 5 valid tokens of 8 floats, 12 mask values, 2 x (2 x 3) outputs
    assert work["bytes"] == 4 * 8 * 5 + 4 * 12 + 8 * 6
    signed = chip_smoke.maxsim_work(torch.tensor([[1, -1, 0]]), torch.tensor([[-1, -1, 1]]), 4)
    assert signed["pairs"] == 1 * 1 + 1 * 2                  # (+, +) and (-, -) pairs
    assert signed["bytes"] == 4 * 4 * 5 + 4 * 6 + 8
    ms, by, _ = chip_smoke.maxsim_bound(ma, mb, 8)
    assert by == "bytes" and ms == 1e3 * (work["bytes"] / chip_smoke.H100_BYTES_PER_S)


@pytest.mark.parametrize("t", [1.0, 0.7])
def test_plain_similarity_matches_lax(t):
    ha, hb, ma, mb = _tokens(3, 3, 4, 16, 24, D=32)
    got = filip.filip_similarity(torch.from_numpy(ha), torch.from_numpy(hb),
                                 torch.from_numpy(ma), torch.from_numpy(mb), t)
    want = jfilip.filip_similarity(jnp.asarray(ha), jnp.asarray(hb), jnp.asarray(ma),
                                   jnp.asarray(mb), jnp.asarray(t, jnp.float32))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


@pytest.mark.parametrize("activation", ["relu", "tanh", "gelu"])
@pytest.mark.parametrize("h1", [1, 2, 3])
def test_encode_tokens_matches(activation, h1):
    rng = np.random.default_rng(h1)
    hidden = rng.normal(size=(3, 12, 64)).astype(np.float32)
    jp = jheads.init_head(jax.random.key(h1), 64, 32, h1, 2)
    want = np.asarray(jheads.encode_tokens(jp, jnp.asarray(hidden), activation=activation))
    got = heads.encode_tokens(checkpoint.from_numpy_tree(_np(jp), "cpu"),
                              torch.from_numpy(hidden), activation=activation)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("side", ["pep", "rec"])
def test_encode_side_tokens_matches(side):
    rng = np.random.default_rng(11)
    hidden = rng.normal(size=(2, 9, 64)).astype(np.float32)
    jcfg = jfilip.FILIPConfig(input_dim=64, embedding_dim=32)
    cfg = filip.FILIPConfig(input_dim=64, embedding_dim=32)
    jp = jfilip.init_params(jax.random.key(2), jcfg)
    want = np.asarray(jfilip.encode_side_tokens(jp, side, jnp.asarray(hidden), jcfg))
    got = filip.encode_side_tokens(checkpoint.from_numpy_tree(_np(jp), "cpu"), side,
                                   torch.from_numpy(hidden), cfg)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, atol=1e-6)


def test_init_params_structure_matches():
    jcfg = jfilip.FILIPConfig(input_dim=64, embedding_dim=32, h1=3, h2=1)
    cfg = filip.FILIPConfig(input_dim=64, embedding_dim=32, h1=3, h2=1)
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jfilip.init_params(jax.random.key(0), jcfg))
    got = filip.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), got) == jshapes
    assert float(got["temperature"]) == 1.0


def test_init_params_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        filip.init_params(filip.FILIPConfig(input_dim=64), torch.Generator())
