"""The PCT_GELU A/B knob in the port, against the JAX package: the gelu that
``cli/common.esm_config`` resolves and the default of ``ESM2Config.gelu``,
and a forward built under PCT_GELU=tanh.

The forward runs both packages in float32 on the CPU on weights carried
across, at ``test_torch_esm2.py``'s tolerance (2e-5 absolute on the final
hidden states: float32 matmuls summed in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protein_clip_tpu.cli import common as jcommon
from protein_clip_tpu.models import esm2 as jesm2
from protein_clip_tpu_torch.cli import common
from protein_clip_tpu_torch.models import esm2
from protein_clip_tpu_torch.train.checkpoint import from_numpy_tree

ATOL = 2e-5


@pytest.mark.parametrize("dtype,flags,want", [
    ("bfloat16", {}, "tanh"),
    ("float32", {}, "tanh"),
    ("bfloat16", {"exact_gelu": True}, "erf"),
    ("bfloat16", {"fast_gelu": True}, "tanh"),
    ("int8", {}, "tanh"),
    ("int8", {"exact_gelu": True}, "erf"),
])
def test_esm_config_reads_pct_gelu_as_the_jax_package(monkeypatch, dtype, flags, want):
    monkeypatch.setenv("PCT_GELU", "tanh")
    got = common.esm_config("tiny", dtype, **flags).gelu
    assert got == jcommon.esm_config("tiny", dtype, **flags).gelu == want


@pytest.mark.parametrize("env,want", [(None, "erf"), ("tanh", "tanh"), ("erf", "erf")])
def test_config_default_reads_pct_gelu_at_construction(monkeypatch, env, want):
    if env is None:
        monkeypatch.delenv("PCT_GELU", raising=False)
    else:
        monkeypatch.setenv("PCT_GELU", env)
    cfg = esm2.ESM2Config.tiny()
    assert cfg.gelu == jesm2.ESM2Config.tiny().gelu == want
    # read once: a later change of the knob leaves a built config alone
    monkeypatch.setenv("PCT_GELU", "erf" if want == "tanh" else "tanh")
    assert cfg.gelu == want
    # an explicit gelu= wins over the knob
    assert esm2.ESM2Config.tiny(gelu="erf").gelu == "erf"


def test_forward_under_pct_gelu_tanh_matches_jax(monkeypatch):
    monkeypatch.setenv("PCT_GELU", "tanh")
    small = dict(hidden_size=128, num_layers=2, num_heads=4, intermediate_size=256)
    jcfg = jesm2.ESM2Config(**small)
    cfg = common.esm_config("tiny", "float32")
    cfg = esm2.ESM2Config(**small, compute_dtype=cfg.compute_dtype, gelu=cfg.gelu)
    assert cfg.gelu == jcfg.gelu == "tanh"
    rng = np.random.default_rng(3)
    ids = rng.integers(4, 24, (3, 40)).astype(np.int32)
    mask = np.ones((3, 40), np.int32)
    mask[1, 25:] = 0
    ids[1, 25:] = 1
    jparams = jesm2.init_params(jax.random.key(0), jcfg)
    want = np.asarray(jesm2.forward(jparams, jnp.asarray(ids), jnp.asarray(mask), jcfg))
    params = from_numpy_tree(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    got = esm2.forward(params, torch.from_numpy(ids), torch.from_numpy(mask), cfg).numpy()
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], atol=ATOL)
