"""The port's CLIP heads, checkpoints and retrieval against the JAX
package's, on parameters carried across as numpy (float32, CPU).
Tolerance 1e-5 absolute on unit-scale embeddings."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from protein_clip_tpu.eval import embed as jax_eval
from protein_clip_tpu.models import clip as jclip
from protein_clip_tpu.models import heads as jheads
from protein_clip_tpu.train import checkpoint as jckpt
from protein_clip_tpu_torch.eval import embed as port_eval
from protein_clip_tpu_torch.models import clip, esm2, heads
from protein_clip_tpu_torch.train import checkpoint

ATOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _hidden(rng, B=3, T=12, H=64):
    hidden = rng.normal(size=(B, T, H)).astype(np.float32)
    mask = np.ones((B, T), np.int32)
    mask[1, 7:] = 0
    mask[2, 1:] = 0
    return hidden, mask


@pytest.mark.parametrize("activation", ["relu", "tanh", "gelu"])
@pytest.mark.parametrize("h1,h2", [(1, 1), (2, 2), (3, 2)])
def test_encode_pooled_matches(activation, h1, h2):
    rng = np.random.default_rng(h1 * 10 + h2)
    hidden, mask = _hidden(rng)
    jp = jheads.init_head(jax.random.key(h1), 64, 32, h1, h2)
    temp = np.float32(0.7)
    want = np.asarray(jheads.encode_pooled(jp, jnp.asarray(hidden), jnp.asarray(mask),
                                           jnp.asarray(temp), activation=activation))
    got = heads.encode_pooled(checkpoint.from_numpy_tree(_np(jp), "cpu"),
                              torch.from_numpy(hidden),
                              torch.from_numpy(mask), torch.tensor(temp),
                              activation=activation)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_encode_side_and_cosine_matrix_match():
    rng = np.random.default_rng(5)
    hidden, mask = _hidden(rng)
    jcfg = jclip.CLIPConfig(input_dim=64, embedding_dim=32)
    cfg = clip.CLIPConfig(input_dim=64, embedding_dim=32)
    jp = jclip.init_params(jax.random.key(5), jcfg)
    p = checkpoint.from_numpy_tree(_np(jp), "cpu")
    embs = {}
    for side in ("pep", "rec"):
        want = np.asarray(jclip.encode_side(jp, side, jnp.asarray(hidden), jnp.asarray(mask),
                                            jcfg))
        got = clip.encode_side(p, side, torch.from_numpy(hidden), torch.from_numpy(mask), cfg)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
        embs[side] = (got, want)
    want = np.asarray(jclip.cosine_similarity_matrix(embs["pep"][1], embs["rec"][1],
                                                     jp["temperature"]))
    got = clip.cosine_similarity_matrix(embs["pep"][0], embs["rec"][0], p["temperature"])
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_masked_mean_matches_with_empty_row():
    rng = np.random.default_rng(6)
    h = rng.normal(size=(2, 5, 3)).astype(np.float32)
    mask = np.array([[1, 1, 0, 0, 0], [0, 0, 0, 0, 0]], np.int32)
    want = np.asarray(jheads.masked_mean(jnp.asarray(h), jnp.asarray(mask)))
    got = heads.masked_mean(torch.from_numpy(h), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_init_params_structure_matches():
    jcfg = jclip.CLIPConfig(input_dim=64, embedding_dim=32, h1=3, h2=1)
    cfg = clip.CLIPConfig(input_dim=64, embedding_dim=32, h1=3, h2=1)
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jclip.init_params(jax.random.key(0), jcfg))
    got = clip.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), got) == jshapes
    assert jax.tree.map(lambda t: tuple(t.shape), clip.abstract_params(cfg)) == jshapes
    bound = 1 / 64 ** 0.5
    assert float(got["pep"]["projection"]["w"].abs().max()) <= bound
    assert float(got["temperature"]) == 1.0


def test_npz_written_by_jax_loads_in_port(tmp_path):
    jcfg = jclip.CLIPConfig(input_dim=64, embedding_dim=32)
    jp = jclip.init_params(jax.random.key(1), jcfg)
    jckpt.export_npz(tmp_path / "h.npz", jp)
    cfg = clip.CLIPConfig(input_dim=64, embedding_dim=32)
    got = checkpoint.load_npz(tmp_path / "h.npz", clip.abstract_params(cfg), "cpu")
    flat_want = jckpt._flatten(jp)
    flat_got = checkpoint._flatten(got)
    assert set(flat_got) == set(flat_want)
    for key, arr in flat_want.items():
        np.testing.assert_array_equal(flat_got[key].numpy(), arr)


def test_npz_written_by_port_loads_in_jax(tmp_path):
    cfg = esm2.ESM2Config.tiny()
    params = esm2.init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    checkpoint.export_npz(tmp_path / "esm.npz", params)
    from protein_clip_tpu.models import esm2 as jesm2
    like = jesm2.init_params(jax.random.key(0), jesm2.ESM2Config.tiny())
    got = jckpt.load_npz(tmp_path / "esm.npz", like)
    for key, arr in jckpt._flatten(got).items():
        np.testing.assert_array_equal(arr, checkpoint._flatten(params)[key].numpy())


def test_bf16_roundtrips(tmp_path):
    """bf16 tensors are written as float32; a bfloat16 array written by the
    JAX package reads back bit for bit."""
    t = torch.randn(4, 3).bfloat16()
    checkpoint.export_npz(tmp_path / "a.npz", {"x": {"w": t}})
    back = checkpoint.load_npz(tmp_path / "a.npz",
                               {"x": {"w": torch.empty(4, 3, dtype=torch.bfloat16)}}, "cpu")
    assert back["x"]["w"].dtype == torch.bfloat16
    assert torch.equal(back["x"]["w"], t)
    jckpt.export_npz(tmp_path / "b.npz", {"w": jnp.asarray(t.float().numpy(), jnp.bfloat16)})
    raw = checkpoint.read_npz(tmp_path / "b.npz")["w"]
    got = checkpoint.to_tensor(raw, "cpu")
    assert got.dtype == torch.bfloat16 and torch.equal(got, t)
    assert checkpoint.to_tensor(raw.view(ml_dtypes.bfloat16), "cpu").dtype == torch.bfloat16


def test_from_numpy_tree_casts_floats_only():
    tree = {"a": np.ones((2,), np.float32), "b": {"c": np.arange(3, dtype=np.int32)}}
    got = checkpoint.from_numpy_tree(tree, "cpu", torch.bfloat16)
    assert got["a"].dtype == torch.bfloat16 and got["b"]["c"].dtype == torch.int32


def test_load_npz_rejects_missing_keys_and_bad_shapes(tmp_path):
    checkpoint.export_npz(tmp_path / "c.npz", {"a": torch.zeros(2)})
    with pytest.raises(KeyError):
        checkpoint.load_npz(tmp_path / "c.npz", {"b": torch.zeros(2)}, "cpu")
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load_npz(tmp_path / "c.npz", {"a": torch.zeros(3)}, "cpu")


def test_nearest_partners_matches():
    rng = np.random.default_rng(7)
    qe = rng.normal(size=(5, 16)).astype(np.float32)
    ce = rng.normal(size=(40, 16)).astype(np.float32)
    for got, want in zip(port_eval.nearest_partners(qe, ce, k=7),
                         jax_eval.nearest_partners(qe, ce, k=7)):
        np.testing.assert_array_equal(got, want)
