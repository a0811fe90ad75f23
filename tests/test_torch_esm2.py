"""The port's ESM-2 against the JAX package's, on weights carried across.

Inputs come from a numpy seed; the JAX parameters go through
``checkpoint.from_numpy_tree``; both run in float32 on the CPU, where both
take the eager attention form. Tolerance: 2e-5 absolute on the final
hidden states (float32 matmuls summed in different orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protein_clip_tpu.models import esm2 as jesm2
from protein_clip_tpu_torch.models import esm2
from protein_clip_tpu_torch.train.checkpoint import from_numpy_tree

ATOL = 2e-5
# head_dim 32 like every served family (ESM2Config.tiny has 16)
SMALL = dict(hidden_size=128, num_layers=2, num_heads=4, intermediate_size=256)


def _configs(**over):
    return (jesm2.ESM2Config(**SMALL, **over),
            esm2.ESM2Config(**SMALL, **over))


def _carry(jparams):
    return from_numpy_tree(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)


def _batch(rng, B, T, lengths, mask_frac=0.0):
    ids = np.full((B, T), 1, np.int32)
    mask = np.zeros((B, T), np.int32)
    for b, n in enumerate(lengths):
        body = rng.integers(4, 24, n - 2)
        body[rng.random(n - 2) < mask_frac] = 32  # <mask>
        ids[b, :n] = np.concatenate(([0], body, [2]))
        mask[b, :n] = 1
    return ids, mask


def _forward_both(jcfg, cfg, ids, mask, seed=0):
    jparams = jesm2.init_params(jax.random.key(seed), jcfg)
    want = np.asarray(jesm2.forward(jparams, jnp.asarray(ids), jnp.asarray(mask), jcfg))
    got = esm2.forward(_carry(jparams), torch.from_numpy(ids), torch.from_numpy(mask), cfg)
    return got.numpy(), want


@pytest.mark.parametrize("gelu", ["erf", "tanh"])
def test_forward_padded_batch_matches(gelu):
    rng = np.random.default_rng(0)
    jcfg, cfg = _configs(gelu=gelu)
    assert cfg.head_dim == 32
    ids, mask = _batch(rng, 3, 40, [40, 23, 7])
    got, want = _forward_both(jcfg, cfg, ids, mask)
    assert got.shape == (3, 40, 128)
    np.testing.assert_allclose(got, want, atol=ATOL)  # every position, pads too


def test_forward_mask_token_dropout_matches():
    """<mask> tokens on unpadded rows: the token-dropout rescale over the
    true length."""
    rng = np.random.default_rng(1)
    jcfg, cfg = _configs()
    ids, mask = _batch(rng, 2, 32, [32, 32], mask_frac=0.2)
    assert (ids == 32).sum() > 0
    got, want = _forward_both(jcfg, cfg, ids, mask, seed=1)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_forward_tiny_config_matches():
    """ESM2Config.tiny (head_dim 16), the config the serving tests use."""
    rng = np.random.default_rng(2)
    jcfg, cfg = jesm2.ESM2Config.tiny(), esm2.ESM2Config.tiny()
    ids, mask = _batch(rng, 2, 24, [24, 10], mask_frac=0.1)
    got, want = _forward_both(jcfg, cfg, ids, mask, seed=2)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_embed_matches():
    rng = np.random.default_rng(3)
    jcfg, cfg = _configs()
    ids, mask = _batch(rng, 3, 20, [20, 12, 5], mask_frac=0.3)
    jparams = jesm2.init_params(jax.random.key(3), jcfg)
    want = np.asarray(jesm2.embed(jparams, jnp.asarray(ids), jnp.asarray(mask), jcfg))
    got = esm2.embed(_carry(jparams), torch.from_numpy(ids), torch.from_numpy(mask), cfg)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_rope_tables_match():
    for T, dh in ((7, 32), (64, 16)):
        jc, js = jesm2._rope_tables(T, dh)
        c, s = esm2._rope_tables(T, dh, torch.float32, "cpu")
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("family", ["t6_8M", "t12_35M", "t30_150M", "t33_650M",
                                    "t36_3B", "t48_15B", "tiny"])
def test_config_families_match(family):
    j = getattr(jesm2.ESM2Config, family)()
    p = getattr(esm2.ESM2Config, family)()
    for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
              "intermediate_size", "layer_norm_eps", "pad_token_id",
              "mask_token_id", "token_dropout"):
        assert getattr(p, f) == getattr(j, f), f
    assert p.head_dim == j.head_dim


def test_init_params_structure_matches():
    jcfg, cfg = _configs()
    jshapes = jax.tree.map(lambda a: tuple(a.shape),
                           jesm2.init_params(jax.random.key(0), jcfg))
    params = esm2.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    shapes = jax.tree.map(lambda t: tuple(t.shape), params)
    assert shapes == jshapes
    abstract = esm2.abstract_params(cfg)
    assert jax.tree.map(lambda t: tuple(t.shape), abstract) == jshapes
    assert all(t.is_meta for t in jax.tree.leaves(abstract))
    w = params["layers"]["attn"]["q"]["w"]
    assert abs(float(w.std()) - 0.02) < 2e-3
    assert float(params["layers"]["attn"]["ln"]["w"].min()) == 1.0


def test_bf16_forward_close_to_f32():
    """bf16 compute path on the CPU (eager attention): finite, and close to
    the f32 result at bf16 tolerance."""
    rng = np.random.default_rng(4)
    _, cfg = _configs()
    ids, mask = _batch(rng, 2, 32, [32, 17])
    params = esm2.init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    f32 = esm2.forward(params, torch.from_numpy(ids), torch.from_numpy(mask), cfg)
    cfg16 = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
    bf16 = esm2.forward(jax.tree.map(torch.Tensor.bfloat16, params), torch.from_numpy(ids),
                        torch.from_numpy(mask), cfg16)
    assert bf16.dtype == torch.bfloat16 and torch.isfinite(bf16).all()
    np.testing.assert_allclose(bf16.float().numpy(), f32.numpy(), atol=0.1)
