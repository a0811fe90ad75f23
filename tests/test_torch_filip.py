"""The port's FILIP heads and masked max-sim against the JAX package's, on
the CPU in float32, with inputs made from a numpy seed.

The JAX ``filip_similarity_fused`` runs its Pallas kernel in interpret mode
here, as ``tests/test_pallas_filip.py`` runs it; the port's wrapper runs its
plain version on CPU tensors. Both are means of f32 dot products of unit
vectors summed in another order: atol 2e-6. The lax oracle
``models/filip.filip_similarity`` does not clamp a max over no valid token
to 0, so it is compared only on pairs whose rows both have a valid token.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


def _tokens(seed, Ba, Bb, TA, TB, D=128, empty_rows=False):
    rng = np.random.default_rng(seed)
    ha = _unit(rng.normal(size=(Ba, TA, D)))
    hb = _unit(rng.normal(size=(Bb, TB, D)))
    ma = np.ones((Ba, TA), np.int32)
    mb = np.ones((Bb, TB), np.int32)
    ma[1 % Ba, TA // 2:] = 0
    ma[2 % Ba, 3:] = 0
    mb[0, TB - 10:] = 0
    mb[3 % Bb, 5:] = 0
    if empty_rows:
        ma[Ba - 1] = 0
        mb[Bb - 2] = 0
    return ha, hb, ma, mb


CASES = {
    "square": (4, 4, 32, 64, False),
    "rectangular_ta_ne_tb": (3, 5, 40, 72, False),
    "tb_1024": (2, 3, 64, 1024, False),
    "all_masked_rows": (4, 5, 32, 64, True),
}


def _both(case, t):
    Ba, Bb, TA, TB, empty = CASES[case]
    ha, hb, ma, mb = _tokens(len(case), Ba, Bb, TA, TB, empty_rows=empty)
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
