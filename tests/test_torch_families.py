"""Every ESM-2 family in the port: the configs against the JAX package's,
the attention kernels' config check at each head dim, and the forward and
the packed finetune step at the families' widths against JAX's on the CPU.

The CUDA kernels K1 and K5 take bf16 and float32 at head dims 16 (t6_8M,
tiny), 24 (t12_35M, in the 32-wide tiles), 32 (t30_150M), 64 (t33_650M,
t36_3B) and 128 (t48_15B); any other head dim or dtype raises. On the CPU both
packages run the eager attention, so the comparisons here hold the port's
model code at each width: 2-layer backbones at the widths of t6_8M, t12_35M
and t33_650M and a head-dim-128 one (hidden 256, 2 heads), float32, weights
carried across as numpy; padded rows and packed rows (segments, gaps,
per-segment positions). Tolerance 2e-5 absolute on the final hidden states
(float32 matmuls summed in other orders), as tests/test_torch_esm2.py. The
packed finetune step at head dim 64 (hidden 128, 2 heads) is held to JAX's
over two steps as tests/test_torch_finetune.py holds it at head dim 16 over
three.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from protein_clip_tpu.cli import common as jcommon
from protein_clip_tpu.models import clip as jclip
from protein_clip_tpu.models import esm2 as jesm2
from protein_clip_tpu.train import finetune as jfinetune
from protein_clip_tpu_torch.cli import common
from protein_clip_tpu_torch.models import clip, esm2
from protein_clip_tpu_torch.ops import attention
from protein_clip_tpu_torch.train import finetune
from protein_clip_tpu_torch.train.checkpoint import from_numpy_tree
from test_torch_finetune import (LRS, Capturing, assert_grads_close, assert_within_adam_bound,
                                 jax_capture, np_tree, packed_cfgs, port_params,
                                 run_packed_steps)

ATOL = 2e-5
FAMILIES = ["t6_8M", "t12_35M", "t30_150M", "t33_650M", "t36_3B", "t48_15B", "tiny"]
HEAD_DIMS = {"t6_8M": 16, "t12_35M": 24, "t30_150M": 32, "t33_650M": 64, "t36_3B": 64,
             "t48_15B": 128, "tiny": 16}
# 2 layers at each head dim's width: (hidden, heads, FFN)
WIDTHS = {"t6_8M": (320, 20, 1280), "t12_35M": (480, 20, 1920), "t33_650M": (1280, 20, 5120),
          "dh128": (256, 2, 512)}


@pytest.mark.parametrize("name", FAMILIES)
def test_esm_config_matches_the_jax_family(name):
    """The port's ``esm_config`` gives the JAX package's hidden size, heads,
    FFN width, depth and head dim, and keeps the fused attention."""
    got = common.esm_config(name, "bfloat16")
    want = jcommon.esm_config(name, "bfloat16")
    fields = ("hidden_size", "num_heads", "intermediate_size", "num_layers", "head_dim")
    assert {f: getattr(got, f) for f in fields} == {f: getattr(want, f) for f in fields}
    assert got.head_dim == HEAD_DIMS[name]
    assert got.attention_impl == "fused" and got.compute_dtype == torch.bfloat16


@pytest.mark.parametrize("dh", attention.HEAD_DIMS)
def test_check_config_takes_bf16_at_every_kernel_head_dim(dh):
    attention.check_config(torch.bfloat16, dh)


@pytest.mark.parametrize("dh", attention.HEAD_DIMS)
def test_check_config_takes_float32_at_every_kernel_head_dim(dh):
    attention.check_config(torch.float32, dh)


@pytest.mark.parametrize("dtype,dh", [(torch.float32, 48), (torch.float16, 32),
                                      (torch.bfloat16, 48), (torch.bfloat16, 8)])
def test_check_config_refuses_float32_and_other_head_dims(dtype, dh):
    """Float32 and bf16 at a head dim the kernels lack, and another dtype at
    one they take."""
    with pytest.raises(NotImplementedError, match=f"not {dtype} at head_dim {dh}"):
        attention.check_config(dtype, dh)


def _operands(dh, B=2, T=70, NH=3, dtype=torch.bfloat16):
    q = torch.zeros(B, T, NH, dh, dtype=dtype)
    return torch.ones(B, T, dtype=torch.int32), q, q.clone(), q.clone()


@pytest.mark.parametrize("dh", [48, 8, 256])
def test_the_wrappers_check_refuses_an_unknown_head_dim(dh):
    """``_check``, which the wrappers run on CUDA tensors before a launch,
    refuses a head dim the kernels do not take (called here on CPU bf16
    tensors of the same shapes)."""
    with pytest.raises(NotImplementedError, match=f"head_dim {dh}"):
        attention._check(*_operands(dh))


@pytest.mark.parametrize("dh", attention.HEAD_DIMS)
def test_the_wrappers_check_takes_every_kernel_head_dim(dh):
    seg, q, k, v = _operands(dh)
    attention._check(seg, q, k, v, q.clone())


@pytest.mark.parametrize("dh", attention.HEAD_DIMS)
def test_the_wrappers_check_takes_float32_at_every_kernel_head_dim(dh):
    seg, q, k, v = _operands(dh, dtype=torch.float32)
    attention._check(seg, q, k, v, q.clone())


def test_the_wrappers_check_refuses_mixed_dtypes():
    seg, q, k, v = _operands(32, dtype=torch.float32)
    with pytest.raises(TypeError, match="v must be torch.float32 like q"):
        attention._check(seg, q, k, v.bfloat16())
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        attention._check(seg, *(t.half() for t in (q, k, v)))


def _configs(width: str):
    hidden, heads, ffn = WIDTHS[width]
    kw = dict(hidden_size=hidden, num_layers=2, num_heads=heads, intermediate_size=ffn)
    return jesm2.ESM2Config(**kw), esm2.ESM2Config(**kw)


def _padded(rng, T=40, lengths=(40, 23, 7)):
    ids = np.full((len(lengths), T), 1, np.int32)
    mask = np.zeros((len(lengths), T), np.int32)
    for b, n in enumerate(lengths):
        ids[b, :n] = np.concatenate(([0], rng.integers(4, 24, n - 2), [2]))
        mask[b, :n] = 1
    return ids, mask, {}


def _packed(rng, T=48, rows=((20, 21), (30, 10, 5))):
    """Rows of several sequences, each <cls> .. <eos> with its own segment
    id and positions from 0, and gap zeros (<pad>) after them."""
    ids = np.full((len(rows), T), 1, np.int32)
    seg = np.zeros((len(rows), T), np.int32)
    pos = np.zeros((len(rows), T), np.int32)
    for b, lengths in enumerate(rows):
        at = 0
        for s, n in enumerate(lengths):
            ids[b, at:at + n] = np.concatenate(([0], rng.integers(4, 24, n - 2), [2]))
            seg[b, at:at + n] = s + 1
            pos[b, at:at + n] = np.arange(n)
            at += n + 1
    return ids, (seg > 0).astype(np.int32), {"segment_ids": seg, "positions": pos}


@pytest.mark.parametrize("kind", ["padded", "packed"])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_forward_matches_jax_at_the_family_width(width, kind):
    """2 layers at the width (and head dim) of each family the kernels now
    take: the port's forward against JAX's on the same numpy weights and
    tokens, every position within 2e-5 (f32, the eager attention on both)."""
    rng = np.random.default_rng(len(width))
    jcfg, cfg = _configs(width)
    ids, mask, packed = (_padded if kind == "padded" else _packed)(rng)
    jparams = jesm2.init_params(jax.random.key(3), jcfg)
    want = np.asarray(jesm2.forward(jparams, jnp.asarray(ids), jnp.asarray(mask), jcfg,
                                    **{k: jnp.asarray(v) for k, v in packed.items()}))
    params = from_numpy_tree(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    got = esm2.forward(params, torch.from_numpy(ids), torch.from_numpy(mask), cfg,
                       **{k: torch.from_numpy(v) for k, v in packed.items()}).numpy()
    assert got.shape == (*ids.shape, cfg.hidden_size)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_packed_finetune_steps_at_head_dim_64_match_jax():
    """Two packed finetune steps (4 rows a chunk) on a 2-layer backbone of
    two heads of 64, t33_650M's head dim, against JAX's make_train_step_packed
    (tests/test_torch_finetune.py's check at the tiny config's head dim 16,
    over three): losses within 1e-5 relative, the first step's gradients
    within 1e-5 of each leaf's largest, the parameters within Adam's bound
    after the second step."""
    kw = dict(hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256)
    heads = dict(input_dim=128, embedding_dim=16, h1=2, h2=2, dropout=0.0)
    jmcfg = jclip.CLIPConfig(esm=jesm2.ESM2Config(**kw), **heads)
    mcfg = clip.CLIPConfig(esm=esm2.ESM2Config(**kw), **heads)
    assert mcfg.esm.head_dim == 64
    jesm = jesm2.init_params(jax.random.key(1), jmcfg.esm)
    jheads = jclip.init_params(jax.random.key(2), jmcfg)
    jcfg, cfg = packed_cfgs(jmcfg, mcfg, **LRS)
    tx = optax.chain(jax_capture(), jfinetune.make_optimizer(jcfg))
    jstep = jfinetune.make_train_step_packed(jcfg, tx, rows_per_chunk=4)
    step = finetune.make_train_step_packed(cfg, rows_per_chunk=4)
    jp = jfinetune.init_params(jesm, jheads)
    params = port_params(jesm, jheads)
    params, grads, losses, jp, jgrads, jlosses = run_packed_steps(
        jstep, step, jp, tx.init(jp), params, Capturing(finetune.make_optimizer(cfg), params),
        {}, {}, 60, steps=2)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert_grads_close(grads[0], jgrads[0])
    esm_moved = max(float(np.abs(g).max()) for g in jax.tree.leaves(np_tree(jgrads[0]["esm"])))
    assert esm_moved > 1e-6, "backbone gradients must be nonzero"
    assert_within_adam_bound(params, jp, grads, jgrads,
                             {"esm": LRS["backbone_lr"], "heads": LRS["learning_rate"]})

