"""Pretrained ESM-2 from a HF checkpoint directory in the port, against the
JAX package on the CPU.

Tiny seeded ``EsmModel`` and ``EsmForMaskedLM`` directories (this host's
transformers, ``tests/test_esm2_parity.make_hf_tiny``'s config) are saved
as safetensors, as ``pytorch_model.bin``, sharded, with bf16-stored weights,
and as safetensors beside a different ``.bin``. The port reads them without
transformers (``checkpoint.read_hf_checkpoint``); its ``cli.common.load_esm``
must give JAX's ``load_esm`` (``EsmModel.from_pretrained``) to the bit, in
f32 and after the bf16 cast; the f32 forward on those weights must match
JAX's within 2e-5 (f32 sums in another order, as tests/test_torch_esm2.py),
and ``embed --esm-dtype float32`` JAX's within 1e-5 (as
tests/test_torch_serve.py); the two ``convert_esm_weights`` tools must write
equal npz files; a checkpoint of another family raises naming the key.
"""

import dataclasses
import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from protein_clip_tpu.cli import common as jcommon
from protein_clip_tpu.cli import embed as jembed
from protein_clip_tpu.models import clip as jclip
from protein_clip_tpu.models import esm2 as jesm2
from protein_clip_tpu.train.checkpoint import export_npz as jax_export_npz
from protein_clip_tpu_torch.cli import common, embed
from protein_clip_tpu_torch.models import esm2
from protein_clip_tpu_torch.tools import convert_esm_weights
from protein_clip_tpu_torch.train import checkpoint
from test_esm2_parity import make_hf_tiny

REPO = Path(__file__).resolve().parent.parent
ATOL_FORWARD = 2e-5
ATOL_EMBED = 1e-5
FORMATS = ("safetensors", "bin", "sharded", "bf16", "mlm", "both")


def _mlm_tiny(seed=1):
    from transformers import EsmForMaskedLM

    torch.manual_seed(seed)
    return EsmForMaskedLM(make_hf_tiny().config).eval()


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """The directory holding one checkpoint directory per format (FORMATS)."""
    root = tmp_path_factory.mktemp("hf")
    base = make_hf_tiny(seed=0)
    other = make_hf_tiny(seed=7)
    mlm = _mlm_tiny()
    base.save_pretrained(root / "safetensors")
    base.save_pretrained(root / "bin", safe_serialization=False)
    base.save_pretrained(root / "sharded", max_shard_size="60KB")
    base.to(torch.bfloat16).save_pretrained(root / "bf16")
    base.float()
    mlm.save_pretrained(root / "mlm")
    # both formats: from_pretrained reads the safetensors
    other.save_pretrained(root / "both", safe_serialization=False)
    base.save_pretrained(root / "both")
    assert (root / "both" / "pytorch_model.bin").exists()
    assert len(list((root / "sharded").glob("model-*.safetensors"))) > 1
    return root


def _args(weights, dtype="float32"):
    return embed.build_argparser().parse_args(
        ["--esm-config", "tiny", "--esm-dtype", dtype, "--device", "cpu",
         "--esm-weights", str(weights), "--checkpoint", "x", "--fasta", "x", "--out", "x"])


def _flat_np(tree):
    return {k: (v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float32))
            for k, v in checkpoint._flatten(tree).items()}


def _jax_flat(tree):
    return {k: np.asarray(v).astype(np.float32)
            for k, v in checkpoint._flatten(jax.tree.map(np.asarray, tree)).items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_load_esm_matches_jax_to_the_bit(hf_dirs, fmt, dtype):
    args = _args(hf_dirs / fmt, dtype)
    got = common.load_esm(args, common.esm_config("tiny", dtype), torch.device("cpu"))
    want = jcommon.load_esm(args, jcommon.esm_config("tiny", dtype))
    flat, jflat = _flat_np(got), _jax_flat(want)
    assert flat.keys() == jflat.keys()
    want_dtype = torch.float32 if dtype == "float32" else torch.bfloat16
    for key, leaf in checkpoint._flatten(got).items():
        assert leaf.dtype == want_dtype, key
        np.testing.assert_array_equal(flat[key], jflat[key], err_msg=key)


def test_reader_skips_what_the_backbone_does_not_read(hf_dirs):
    sd = checkpoint.read_hf_checkpoint(hf_dirs / "mlm")
    assert set(sd) == set(esm2.hf_shapes(esm2.ESM2Config.tiny()))
    with_head = checkpoint.read_hf_checkpoint(hf_dirs / "mlm", lm_head=True)
    assert {k for k in with_head if k.startswith("lm_head.")} >= {
        "lm_head.dense.weight", "lm_head.dense.bias", "lm_head.layer_norm.weight",
        "lm_head.layer_norm.bias", "lm_head.bias"}
    mlm = _mlm_tiny()
    for key, arr in with_head.items():
        ref = mlm.state_dict()[key if key.startswith("lm_head.") else f"esm.{key}"]
        np.testing.assert_array_equal(arr, ref.numpy(), err_msg=key)


def test_f32_forward_on_hf_weights_matches_jax(hf_dirs):
    args = _args(hf_dirs / "mlm")
    params = common.load_esm(args, common.esm_config("tiny", "float32"), torch.device("cpu"))
    jcfg = jcommon.esm_config("tiny", "float32")
    jparams = jcommon.load_esm(args, jcfg)
    rng = np.random.default_rng(3)
    ids = rng.integers(4, 24, (3, 20)).astype(np.int32)
    ids[:, 0] = 0
    mask = np.ones((3, 20), np.int32)
    for b, n in enumerate((20, 13, 6)):
        ids[b, n - 1] = 2
        ids[b, n:] = 1
        mask[b, n:] = 0
    got = esm2.forward(params, torch.from_numpy(ids), torch.from_numpy(mask),
                       common.esm_config("tiny", "float32"))
    want = np.asarray(jesm2.forward(jparams, ids, mask, jcfg))
    valid = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[valid], want[valid], atol=ATOL_FORWARD)


def test_cli_embed_float32_from_a_hf_directory_matches_jax(hf_dirs, tmp_path):
    """``embed --esm-dtype float32 --esm-weights <HF dir>`` through the port's
    load_esm against the JAX package's ``embed`` on the same directory."""
    cfg = jcommon.esm_config("tiny", "float32")
    heads = jclip.init_params(jax.random.key(3), jclip.CLIPConfig(input_dim=64, esm=cfg))
    jax_export_npz(tmp_path / "heads.npz", heads)
    rng = np.random.default_rng(0)
    seqs = ["".join(rng.choice(list("LAGVSERTIDPKQNFYMHWC"), n)) for n in (5, 17, 30, 9)]
    (tmp_path / "x.fasta").write_text("".join(f">s{i}\n{s}\n" for i, s in enumerate(seqs)))
    argv = ["--esm-config", "tiny", "--esm-dtype", "float32", "--esm-weights",
            str(hf_dirs / "mlm"), "--checkpoint", str(tmp_path / "heads.npz"), "--fasta",
            str(tmp_path / "x.fasta"), "--side", "pep"]
    assert embed.main(argv + ["--device", "cpu", "--out", str(tmp_path / "port.npz")]) == 0
    assert jembed.main(argv + ["--out", str(tmp_path / "jax.npz")]) == 0
    got, want = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert list(got["ids"]) == list(want["ids"])
    np.testing.assert_allclose(got["embeddings"], want["embeddings"], atol=ATOL_EMBED)


def _jax_convert_tool():
    spec = importlib.util.spec_from_file_location("jax_convert_esm_weights",
                                                  REPO / "tools" / "convert_esm_weights.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("fmt,lm_head", [("safetensors", False), ("mlm", True)])
def test_both_convert_tools_write_equal_npz(hf_dirs, tmp_path, monkeypatch, fmt, lm_head):
    extra = ["--lm-head"] if lm_head else []
    assert convert_esm_weights.main(["--hf", str(hf_dirs / fmt), "--out",
                                     str(tmp_path / "port.npz"), "--config", "tiny", *extra]) == 0
    monkeypatch.setattr(sys, "argv", ["convert_esm_weights.py", "--hf", str(hf_dirs / fmt),
                                      "--out", str(tmp_path / "jax.npz"), "--config", "tiny",
                                      *extra])
    _jax_convert_tool().main()
    for stem in ("", "_lm_head") if lm_head else ("",):
        got = checkpoint.read_npz(tmp_path / f"port{stem}.npz")
        want = checkpoint.read_npz(tmp_path / f"jax{stem}.npz")
        assert got.keys() == want.keys()
        for key in got:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # the npz loads through --esm-weights as the directory does
    from_npz = common.load_esm(_args(tmp_path / "port.npz"), common.esm_config("tiny", "float32"),
                               torch.device("cpu"))
    from_dir = common.load_esm(_args(hf_dirs / fmt), common.esm_config("tiny", "float32"),
                               torch.device("cpu"))
    for key, leaf in checkpoint._flatten(from_dir).items():
        assert torch.equal(leaf, checkpoint._flatten(from_npz)[key]), key


def test_convert_tool_refuses_a_hub_id(tmp_path):
    with pytest.raises(FileNotFoundError, match="network"):
        convert_esm_weights.main(["--hf", "facebook/esm2_t30_150M_UR50D", "--out",
                                  str(tmp_path / "x.npz")])


@pytest.mark.parametrize("family,match", [
    ("t6_8M", r"embeddings\.word_embeddings\.weight has shape \(33, 64\).*\(33, 320\)"),
    ("deeper", r"encoder\.layer\.2\.attention\.self\.query\.weight"),
], ids=["t6_8M", "deeper"])
def test_another_family_raises_naming_the_key(hf_dirs, family, match):
    cfg = (dataclasses.replace(esm2.ESM2Config.tiny(), num_layers=3) if family == "deeper"
           else getattr(esm2.ESM2Config, family)())
    with pytest.raises((ValueError, KeyError), match=match):
        esm2.convert_hf_state_dict(checkpoint.read_hf_checkpoint(hf_dirs / "safetensors"), cfg)


def test_a_directory_without_weights_raises(tmp_path):
    (tmp_path / "config.json").write_text("{}")
    with pytest.raises(FileNotFoundError, match="model.safetensors or pytorch_model.bin"):
        checkpoint.read_hf_checkpoint(tmp_path)
