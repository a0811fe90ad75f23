"""The port's int8 w8a8 backbone (``--esm-dtype int8``) against the JAX
package's, on the CPU: ``esm2.quantize_params``, the ``w_q`` branch of
``_dense``, the forward, CLIP embeddings, a frozen train step, ``cli.embed``
and the CLI's handling of the mode. Mirrors ``tests/test_quantized.py``.

Parameters go across as numpy; inputs come from a numpy seed. Tolerances:
- ``w_q`` equal to the bit, ``w_s`` within 1 f32 ulp (the same f32 max and
  division; reading: no entry differs by more than 1 ulp).
- ``_dense`` and the forward in f32: the s32 products are exact, so only
  the order of f32 operations differs. ``_dense`` within 1e-6 relative to
  the output's largest entry; the forward within 1e-5 relative L2 (reading:
  1.4e-7 on the tiny config).
- int8 against f32 as the JAX test holds it: cosine > 0.999, relative
  L2 < 0.05; CLIP embeddings per row cosine > 0.99.
- The train step's loss within 1e-4 relative of the JAX step's. Dynamic
  activation quantisation is discontinuous: an activation whose x / xs lies
  within the frameworks' f32 noise of a half-integer rounds the other way.
  Reading: one rec sequence of this batch has such a tie (1.9e-6 from x.5),
  its hidden states move by 2.2e-2 while the other 7 agree within 9e-7, and
  the loss moves by 1.57e-5 relative.
- ``cli.embed`` (bf16 activations, as int8 runs): within 2e-2 absolute on
  unit-scale embeddings (bf16 rounds at other points in the two frameworks;
  reading in the test's assertion message).
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protein_clip_tpu.cli import common as jcommon
from protein_clip_tpu.cli import embed as jembed
from protein_clip_tpu.data.tokenizer import EsmTokenizer as JaxTokenizer
from protein_clip_tpu.models import clip as jclip
from protein_clip_tpu.models import esm2 as jesm2
from protein_clip_tpu.train import clip_engine as jengine
from protein_clip_tpu.train import optimizer as jopt
from protein_clip_tpu.train.checkpoint import export_npz as jax_export_npz
from protein_clip_tpu_torch.cli import common, embed, main
from protein_clip_tpu_torch.data.tokenizer import EsmTokenizer
from protein_clip_tpu_torch.models import clip, esm2
from protein_clip_tpu_torch.train import checkpoint, clip_engine, optimizer
from protein_clip_tpu_torch.train.checkpoint import export_npz, from_numpy_tree

AAS = list("LAGVSERTIDPKQNFYMHWC")
TINY_INT8 = ["--esm-config", "tiny", "--esm-dtype", "int8", "--device", "cpu"]
QUANTIZED = [("attn", "q"), ("attn", "k"), ("attn", "v"), ("attn", "o"),
             ("ffn", "wi"), ("ffn", "wo")]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cos(a, b):
    a = np.asarray(a, np.float64).reshape(-1)
    b = np.asarray(b, np.float64).reshape(-1)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, port config, JAX f32 params, port f32 params)."""
    jcfg, cfg = jesm2.ESM2Config.tiny(gelu="erf"), esm2.ESM2Config.tiny(gelu="erf")
    jparams = jesm2.init_params(jax.random.key(0), jcfg)
    return jcfg, cfg, jparams, from_numpy_tree(_np(jparams), "cpu", torch.float32)


def _ids(rng, B, T):
    ids = rng.integers(4, 24, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[-1, T // 2:] = 0
    ids[-1, T // 2:] = 1
    return ids, mask


def test_quantize_params_matches_jax(tiny):
    _, _, jparams, params = tiny
    jq, q = _np(jesm2.quantize_params(jparams)), esm2.quantize_params(params)
    for group, name in QUANTIZED:
        got, want = q["layers"][group][name], jq["layers"][group][name]
        assert set(got) == {"w_q", "w_s", "b"} and got["w_q"].dtype == torch.int8
        assert got["w_q"].shape == want["w_q"].shape
        np.testing.assert_array_equal(got["w_q"].numpy(), want["w_q"])
        assert got["w_s"].dtype == torch.float32
        ulps = np.abs(got["w_s"].numpy().view(np.int32) - want["w_s"].view(np.int32))
        assert ulps.max() <= 1, (group, name, int((ulps > 0).sum()))
        assert torch.equal(got["b"], params["layers"][group][name]["b"])
    # embeddings, LayerNorms and the final LN are untouched
    assert q["embed"]["word"] is params["embed"]["word"]
    assert q["layers"]["attn"]["ln"] is params["layers"]["attn"]["ln"]
    assert q["final_ln"] is params["final_ln"]


def test_quantize_params_rounds_half_to_even():
    """w / s lands on x.5 exactly: both packages round to the even integer."""
    w = np.zeros((1, 4, 3), np.float32)
    w[0, :, 0] = [127.0, 2.5, -0.5, 1.5]       # s = 1: 2.5 -> 2, -0.5 -> 0, 1.5 -> 2
    w[0, :, 1] = [254.0, 5.0, 3.0, 1.0]        # s = 2: 2.5, 1.5, 0.5
    w[0, :, 2] = 1e-20                         # below the 1e-12 scale floor
    tree = {"embed": {}, "final_ln": {}, "layers": {"attn": {}, "ffn": {"wi": {
        "w": w, "b": np.zeros((1, 3), np.float32)}}}}
    got = esm2.quantize_params(from_numpy_tree(tree, "cpu"))["layers"]["ffn"]["wi"]
    want = _np(jesm2.quantize_params(jax.tree.map(jnp.asarray, tree)))["layers"]["ffn"]["wi"]
    np.testing.assert_array_equal(got["w_q"].numpy(), want["w_q"])
    np.testing.assert_array_equal(got["w_q"][0, :, 0].numpy(), [127, 2, 0, 2])
    np.testing.assert_array_equal(got["w_q"][0, :, 1].numpy(), [127, 2, 2, 0])
    np.testing.assert_array_equal(got["w_s"].numpy(), want["w_s"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_w_q_branch_matches_jax(tiny, dtype):
    _, _, jparams, params = tiny
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 17, 64)).astype(np.float32)
    x[0, 3] = 0.0                               # a zero token: the 1e-6 floor
    x[1, 4] *= 1e3
    jlp = jax.tree.map(lambda a: a[1], jesm2.quantize_params(jparams)["layers"]["attn"]["q"])
    lp = {k: v[1] for k, v in esm2.quantize_params(params)["layers"]["attn"]["q"].items()}
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                          torch.bfloat16)
    jlp = {**jlp, "b": jlp["b"].astype(jdt)}
    lp = {**lp, "b": lp["b"].to(tdt)}
    want = np.asarray(jesm2._dense(jnp.asarray(x, jdt), jlp), np.float32)
    got = esm2._dense(torch.from_numpy(x).to(tdt), lp)
    assert got.dtype == tdt and got.shape == (3, 17, 64)
    # f32: the same operations in the same order; bf16: plus one rounding
    tol = 1e-6 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol * np.abs(want).max())


def test_forward_matches_jax_and_tracks_f32(tiny):
    jcfg, cfg, jparams, params = tiny
    ids, mask = _ids(np.random.default_rng(2), 4, 32)
    want = np.asarray(jesm2.forward(jesm2.quantize_params(jparams), jnp.asarray(ids),
                                    jnp.asarray(mask), jcfg))
    qparams = esm2.quantize_params(params)
    got = esm2.forward(qparams, torch.from_numpy(ids), torch.from_numpy(mask), cfg).numpy()
    assert np.isfinite(got).all()
    valid = mask.astype(bool)
    rel = np.linalg.norm(got[valid] - want[valid]) / np.linalg.norm(want[valid])
    assert rel <= 1e-5, rel
    # int8 leaves pass through the layer split untouched
    assert esm2._layers(qparams["layers"], cfg.num_layers)[1]["ffn"]["wo"]["w_q"].dtype \
        == torch.int8
    h32 = esm2.forward(params, torch.from_numpy(ids), torch.from_numpy(mask), cfg).numpy()
    h32_jax = np.asarray(jesm2.forward(jparams, jnp.asarray(ids), jnp.asarray(mask), jcfg))
    for h8, ref in ((got, h32), (want, h32_jax)):
        assert _cos(ref[valid], h8[valid]) > 0.999
        assert np.linalg.norm(h8[valid] - ref[valid]) / np.linalg.norm(ref[valid]) < 0.05


def test_clip_embeddings_close_to_f32(tiny):
    _, cfg, _, params = tiny
    mcfg = clip.CLIPConfig(input_dim=cfg.hidden_size, embedding_dim=16, h1=2, h2=2, esm=cfg)
    heads = clip.init_params(mcfg, torch.Generator().manual_seed(1), device="cpu")
    rng = np.random.default_rng(3)
    ids = {s: torch.from_numpy(rng.integers(4, 24, (6, 24)).astype(np.int32))
           for s in ("pep", "rec")}
    batch = {"pep_ids": ids["pep"], "pep_mask": torch.ones(6, 24, dtype=torch.int32),
             "rec_ids": ids["rec"], "rec_mask": torch.ones(6, 24, dtype=torch.int32)}
    with torch.no_grad():
        f32 = clip.forward(heads, params, batch, mcfg, train=False)
        q8 = clip.forward(heads, esm2.quantize_params(params), batch, mcfg, train=False)
    for a, b in zip(f32, q8):
        for i in range(6):
            assert _cos(a[i].numpy(), b[i].numpy()) > 0.99


def test_int8_defaults_to_tanh_gelu(monkeypatch):
    monkeypatch.delenv("PCT_GELU", raising=False)
    for dtype, flags, want in (("bfloat16", {}, "erf"), ("float32", {}, "erf"),
                               ("bfloat16", {"fast_gelu": True}, "tanh"),
                               ("int8", {}, "tanh"), ("int8", {"exact_gelu": True}, "erf")):
        assert common.esm_config("tiny", dtype, **flags).gelu == want
        assert jcommon.esm_config("tiny", dtype, **flags).gelu == want
    cfg = common.esm_config("tiny", "int8")
    assert cfg.compute_dtype == torch.bfloat16   # activations stay bf16


def test_load_esm_quantizes_random_and_npz_weights(tmp_path):
    cfg = common.esm_config("tiny", "int8")
    params = esm2.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                              device="cpu")
    export_npz(tmp_path / "esm.npz", params)
    for weights in (None, str(tmp_path / "esm.npz")):
        args = argparse.Namespace(esm_dtype="int8", esm_weights=weights)
        q = common.load_esm(args, cfg, torch.device("cpu"))
        for group, name in QUANTIZED:
            lp = q["layers"][group][name]
            assert lp["w_q"].dtype == torch.int8 and lp["w_s"].dtype == torch.float32
            assert lp["b"].dtype == torch.bfloat16 and "w" not in lp
        assert q["embed"]["word"].dtype == torch.bfloat16
    want = esm2.quantize_params(params)["layers"]["ffn"]["wi"]["w_q"]
    assert torch.equal(q["layers"]["ffn"]["wi"]["w_q"], want)


def _pairs(seed, n):
    rng = np.random.default_rng(seed)
    return (["".join(rng.choice(AAS, int(k))) for k in rng.integers(5, 25, n)],
            ["".join(rng.choice(AAS, int(k))) for k in rng.integers(20, 60, n)])


def test_frozen_train_step_against_int8_matches_jax(tiny):
    jcfg, cfg, jparams, params = tiny
    jmcfg = jclip.CLIPConfig(input_dim=64, embedding_dim=16, dropout=0.0, esm=jcfg)
    mcfg = clip.CLIPConfig(input_dim=64, embedding_dim=16, dropout=0.0, esm=cfg)
    jheads = jclip.init_params(jax.random.key(2), jmcfg)
    tx = jopt.adam(1e-3)
    jstep = jengine.make_train_step(jengine.EngineConfig(
        model=jmcfg, batch_size=4, accumulated_batches=2, num_chunks=2, length_groups=1), tx)
    step = clip_engine.make_train_step(clip_engine.EngineConfig(
        model=mcfg, batch_size=4, accumulated_batches=2, num_chunks=2, length_groups=1))
    heads = from_numpy_tree(_np(jheads), "cpu")
    peps, recs = _pairs(4, 8)
    _, _, jloss = jstep(jheads, tx.init(jheads), jesm2.quantize_params(jparams),
                        jengine.tokenize_pair_batch(JaxTokenizer(), peps, recs),
                        jax.random.key(0))
    _, _, loss = step(heads, optimizer.adam(1e-3).init(heads), esm2.quantize_params(params),
                      clip_engine.tokenize_pair_batch(EsmTokenizer(), peps, recs), None)
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)


def test_cli_embed_int8_matches_jax(tmp_path):
    jcfg = jcommon.esm_config("tiny", "float32")
    mcfg = jclip.CLIPConfig(input_dim=jcfg.hidden_size, esm=jcfg)
    jax_export_npz(tmp_path / "heads.npz", jclip.init_params(jax.random.key(3), mcfg))
    jax_export_npz(tmp_path / "esm.npz", jesm2.init_params(jax.random.key(4), jcfg))
    rng = np.random.default_rng(5)
    seqs = ["".join(rng.choice(AAS, int(n))) for n in rng.integers(5, 40, 9)]
    (tmp_path / "x.fasta").write_text("".join(f">s{i}\n{s}\n" for i, s in enumerate(seqs)))
    argv = ["--esm-config", "tiny", "--esm-dtype", "int8", "--checkpoint",
            str(tmp_path / "heads.npz"), "--esm-weights", str(tmp_path / "esm.npz"),
            "--fasta", str(tmp_path / "x.fasta"), "--side", "rec"]
    assert jembed.main(argv + ["--out", str(tmp_path / "jax.npz")]) == 0
    assert embed.main(argv + ["--device", "cpu", "--out", str(tmp_path / "port.npz")]) == 0
    with np.load(tmp_path / "jax.npz") as j, np.load(tmp_path / "port.npz") as p:
        assert list(p["ids"]) == list(j["ids"])
        got, want = p["embeddings"], j["embeddings"]
    err = np.abs(got - want).max()
    assert got.shape == (9, 128) and err <= 2e-2, err
    assert min(_cos(a, b) for a, b in zip(got, want)) > 0.999


@pytest.mark.parametrize("flags", [["--finetune"], ["--lora-rank", "4"]])
def test_unfrozen_modes_refuse_int8(tmp_path, flags):
    """The JAX package fails on both (a float0 gradient of the int8 leaves
    under --finetune, a KeyError on 'w' in init_lora); the port refuses
    before loading anything."""
    with pytest.raises(NotImplementedError, match=f"{flags[0]} with --esm-dtype int8"):
        main.main(TINY_INT8 + ["--runs-dir", str(tmp_path / "runs")] + flags)
    assert not (tmp_path / "runs").exists()


def test_checkpoints_under_int8(tmp_path):
    """A finetuned {heads, esm} checkpoint serves its own backbone in the
    compute dtype; LoRA adapters need a bf16 or f32 base and raise."""
    cfg = common.esm_config("tiny", "int8")
    mcfg = clip.CLIPConfig(input_dim=cfg.hidden_size, esm=cfg)
    own = esm2.init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
    heads = clip.init_params(mcfg, torch.Generator().manual_seed(8), device="cpu")
    export_npz(tmp_path / "ft.npz", {"heads": heads, "esm": own})
    q = esm2.quantize_params(esm2.cast_params(own, torch.bfloat16))
    got_heads, got_esm = common.load_clip_checkpoint(tmp_path / "ft.npz", mcfg, q,
                                                     torch.device("cpu"))
    assert got_esm["layers"]["attn"]["q"]["w"].dtype == torch.bfloat16
    assert torch.equal(got_esm["layers"]["attn"]["q"]["w"],
                       own["layers"]["attn"]["q"]["w"].bfloat16())
    assert torch.equal(checkpoint._flatten(got_heads)["temperature"], heads["temperature"])
    export_npz(tmp_path / "lora.npz", {"heads": heads, "lora": {"attn/q": {
        "a": torch.zeros(2, 64, 4), "b": torch.zeros(2, 4, 64)}}})
    with pytest.raises(NotImplementedError, match="LoRA"):
        common.load_clip_checkpoint(tmp_path / "lora.npz", mcfg, q, torch.device("cpu"))
