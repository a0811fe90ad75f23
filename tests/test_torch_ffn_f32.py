"""K6 in f32 in the port against the JAX package, on the CPU: the f32
``ops/ffn.dense_gelu`` (its plain version on CPU tensors; on the card it
launches K6-f32, ``csrc/ffn_gelu_f32.cu``), and the paths that reach it
under ``PCT_FFN_PALLAS=1`` with an f32 backbone: ``models/esm2._wi_gelu`` in
a forward, ``cli.embed --esm-dtype float32``, and the packed finetune and
LoRA (``--lora-ffn``) steps.

The JAX side runs its Pallas kernel (``ffn_pallas._call``) in interpret mode,
as ``tests/test_ffn_pallas.py`` does, wherever its ``fits`` takes the shape;
its gate needs a TPU, so ``ffn_pallas.enabled`` is made true here, as
``tests/test_torch_ffn.py`` does. Inputs come from numpy seeds; parameters
cross over through ``checkpoint.from_numpy_tree``.

Tolerances, float32 on both sides (sums in other orders):
- the forward at t30_150M's and t33_650M's wi widths, at unit output
  scale: per output 2e-6 (the JAX package's own f32 tolerance,
  ``tests/test_ffn_pallas.py``, at its H = 128) plus one probabilistic
  rounding bound of an f32 sum of H terms, sqrt(H) 2^-24 (|x| @ |W| + |b|).
  2e-6 alone does not hold at these widths: against a float64 evaluation
  the port reads 2.6e-6 and JAX's kernel 3.1-4.2e-6 (outputs up to 4.6,
  where an f32 ulp is 4.8e-7), and the two 4.05e-6 apart; the added term
  is 2.4e-5 at the typical output of H = 640. The other gelu mode moves
  outputs by up to 4.7e-4, a dropped bias by 0.1 times its normal draw;
- the gradients through each package's custom VJP (both replay the eager
  composition): every gradient within GRAD_RTOL (1e-5) of its largest entry;
- a 2-layer backbone under the gate: 2e-5 absolute on the valid tokens, as
  ``tests/test_torch_ffn.py`` holds the bf16-era gated forward;
- ``cli.embed``: 1e-5 absolute, as ``tests/test_torch_hf_weights.py`` holds
  the f32 embed;
- one packed finetune and one packed LoRA step: the loss within 1e-5
  relative and every gradient within 1e-5 of its leaf's largest entry, as
  ``tests/test_torch_finetune.py`` holds the packed steps;
- the card kernel's arithmetic (3xTF32: ``csrc/mma_gemm.cuh``'s F32
  operand type), emulated in numpy, against JAX's kernel in f32 within
  chip_smoke.py's limit for K6-f32 on the card, F32_ATOL_RMS rms(ref) +
  F32_RTOL |ref| (2^-12 each), at each ESM-2 family's wi; the same
  emulation with one TF32 product (plain TF32) must fail that limit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from protein_clip_tpu.cli import embed as jembed
from protein_clip_tpu.models import clip as jclip
from protein_clip_tpu.models import esm2 as jesm2
from protein_clip_tpu.ops import ffn_pallas
from protein_clip_tpu.train import checkpoint as jckpt
from protein_clip_tpu.train import clip_engine as jengine
from protein_clip_tpu.train import finetune as jfinetune
from protein_clip_tpu.train import lora as jlora
from protein_clip_tpu_torch.cli import embed
from protein_clip_tpu_torch.models import clip, esm2
from protein_clip_tpu_torch.ops import ffn
from protein_clip_tpu_torch.train import checkpoint, clip_engine, finetune, lora
from chip_smoke import F32_ATOL_RMS, F32_RTOL, FFN_WIDTHS
from test_torch_finetune import (RTOL, Capturing, assert_grads_close, jax_capture, np_tree,
                                 port_params, run_packed_steps)

F32_ATOL, GRAD_RTOL, FORWARD_ATOL, EMBED_ATOL = 2e-6, 1e-5, 2e-5, 1e-5
F32_EPS = 2.0 ** -24
# (N, H, M): 256 tokens through the wi of t30_150M and of t33_650M
WI_SHAPES = ((256, 640, 2560), (256, 1280, 5120))
# A backbone whose wi JAX's kernel takes (H % 128, M a multiple of 512, and
# B * T a multiple of 256): head dim 32, as t30_150M's
GATED = dict(hidden_size=128, num_layers=2, num_heads=4, intermediate_size=512, gelu="erf")


def _xwb(seed, N, H, M):
    """x, W at unit output scale (W / sqrt(H)) and a bias of 0.1."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N, H)).astype(np.float32),
            (rng.normal(size=(H, M)) / np.sqrt(H)).astype(np.float32),
            (rng.normal(size=(M,)) * 0.1).astype(np.float32))


@pytest.fixture
def gate(monkeypatch):
    """PCT_FFN_PALLAS=1 in both packages; calls (x's shape) of the port's
    dense_gelu and of JAX's Pallas kernel (counted while JAX traces)."""
    monkeypatch.setenv("PCT_FFN_PALLAS", "1")
    monkeypatch.delenv("PCT_GELU", raising=False)
    monkeypatch.setattr(ffn_pallas, "enabled", lambda: True)
    calls = {"port": [], "jax": []}
    port_fn, jax_fn = ffn.dense_gelu, ffn_pallas._call

    def port(*args):
        calls["port"].append(tuple(args[0].shape))
        return port_fn(*args)

    def jax_call(*args):
        calls["jax"].append(tuple(args[0].shape))
        return jax_fn(*args)

    monkeypatch.setattr(ffn, "dense_gelu", port)
    monkeypatch.setattr(ffn_pallas, "_call", jax_call)
    return calls


@pytest.mark.parametrize("mode", ["erf", "tanh"])
@pytest.mark.parametrize("N,H,M", WI_SHAPES, ids=["t30_150M", "t33_650M"])
def test_f32_forward_matches_the_pallas_kernel(N, H, M, mode):
    arrays = _xwb(N + H, N, H, M)
    want = np.asarray(ffn_pallas._call(*(jnp.asarray(a) for a in arrays), mode))
    got = ffn.dense_gelu(*(torch.from_numpy(a) for a in arrays), mode)
    assert got.dtype == torch.float32
    x, w, b = (np.abs(a.astype(np.float64)) for a in arrays)
    limit = F32_ATOL + np.sqrt(H) * F32_EPS * (x @ w + b)
    err = np.abs(got.numpy() - want)
    assert (err <= limit).all(), float((err / limit).max())


def test_f32_grads_match_the_custom_vjp():
    """dx, dW and db for one cotangent at t30_150M's wi against JAX's
    custom VJP (its forward the Pallas kernel in interpret mode)."""
    N, H, M = WI_SHAPES[0]
    arrays = _xwb(3, N, H, M)
    g = np.random.default_rng(4).normal(size=(N, M)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, c, d: ffn_pallas.dense_gelu(a, c, d, "erf"),
                     *(jnp.asarray(a) for a in arrays))
    want = vjp(jnp.asarray(g))
    inputs = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    got = torch.autograd.grad(ffn.dense_gelu(*inputs, "erf"), inputs, torch.from_numpy(g))
    for a, w in zip(got, want):
        w = np.asarray(w)
        assert a.dtype == torch.float32
        err = float(np.abs(a.numpy() - w).max())
        assert err <= GRAD_RTOL * float(np.abs(w).max()), (err, float(np.abs(w).max()))


@pytest.mark.parametrize("packed", [False, True], ids=["padded", "packed"])
def test_gated_f32_forward_matches_jax(gate, packed):
    """Two f32 layers under both gates, padded rows (one cut short) and
    packed rows (two segments and a gap): each layer's wi + gelu goes
    through the port's dense_gelu and JAX's Pallas kernel."""
    jcfg, cfg = jesm2.ESM2Config(**GATED), esm2.ESM2Config(**GATED)
    assert cfg.compute_dtype == torch.float32
    rng = np.random.default_rng(6)
    ids = rng.integers(4, 24, (2, 128)).astype(np.int32)
    mask = np.ones((2, 128), np.int32)
    mask[1, 90:] = 0
    ids[1, 90:] = 1
    kw, jkw = {}, {}
    if packed:
        seg = mask.copy()
        seg[0, 60:] = 2
        seg[0, 59] = 0
        pos = np.tile(np.arange(128, dtype=np.int32), (2, 1))
        pos[0, 60:] -= 60
        kw = dict(segment_ids=torch.from_numpy(seg), positions=torch.from_numpy(pos))
        jkw = dict(segment_ids=jnp.asarray(seg), positions=jnp.asarray(pos))
    jparams = jesm2.init_params(jax.random.key(0), jcfg)
    want = np.asarray(jesm2.forward(jparams, jnp.asarray(ids), jnp.asarray(mask), jcfg, **jkw))
    params = checkpoint.from_numpy_tree(np_tree(jparams), "cpu", torch.float32)
    got = esm2.forward(params, torch.from_numpy(ids), torch.from_numpy(mask), cfg, **kw)
    # JAX traces its scanned layer once; the port calls once a layer
    assert gate["port"] == [(256, 128)] * 2 and gate["jax"] == [(256, 128)]
    valid = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[valid], want[valid], atol=FORWARD_ATOL)


def test_gated_cli_embed_float32_matches_jax(gate, tmp_path):
    """``PCT_FFN_PALLAS=1 embed --esm-config tiny --esm-dtype float32
    --device cpu`` against JAX's ``embed`` under its gate, on the same esm
    and heads npz. The tiny wi (64 x 128) is one JAX's kernel does not
    take, so JAX runs its eager composition there; the port routes every
    layer through dense_gelu, whose f32 plain version is that composition."""
    jcfg = jesm2.ESM2Config.tiny()
    jckpt.export_npz(tmp_path / "esm.npz", jesm2.init_params(jax.random.key(2), jcfg))
    jckpt.export_npz(tmp_path / "heads.npz", jclip.init_params(
        jax.random.key(3), jclip.CLIPConfig(input_dim=64, esm=jcfg)))
    rng = np.random.default_rng(0)
    seqs = ["".join(rng.choice(list("LAGVSERTIDPKQNFYMHWC"), n)) for n in (5, 17, 30, 9, 44)]
    (tmp_path / "x.fasta").write_text("".join(f">s{i}\n{s}\n" for i, s in enumerate(seqs)))
    argv = ["--esm-config", "tiny", "--esm-dtype", "float32", "--esm-weights",
            str(tmp_path / "esm.npz"), "--checkpoint", str(tmp_path / "heads.npz"), "--fasta",
            str(tmp_path / "x.fasta"), "--side", "rec"]
    assert embed.main(argv + ["--device", "cpu", "--out", str(tmp_path / "port.npz")]) == 0
    assert gate["port"] and all(shape[1] == 64 for shape in gate["port"])
    assert jembed.main(argv + ["--out", str(tmp_path / "jax.npz")]) == 0
    got, want = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert list(got["ids"]) == list(want["ids"])
    np.testing.assert_allclose(got["embeddings"], want["embeddings"], atol=EMBED_ATOL)


def _gated_cfgs(**kw):
    """(JAX, port) packed engine configs over the GATED backbone, dropout 0,
    16-d heads, global batch 8 (the packed rows of test_torch_finetune's
    pairs: 16 rows of 128 and 16 of 256, which JAX's kernel takes)."""
    jmcfg = jclip.CLIPConfig(input_dim=128, embedding_dim=16, h1=2, h2=2, dropout=0.0,
                             esm=jesm2.ESM2Config(**GATED))
    mcfg = clip.CLIPConfig(input_dim=128, embedding_dim=16, h1=2, h2=2, dropout=0.0,
                           esm=esm2.ESM2Config(**GATED))
    kw = dict(batch_size=4, accumulated_batches=2, packed=True, **kw)
    return jengine.EngineConfig(model=jmcfg, **kw), clip_engine.EngineConfig(model=mcfg, **kw)


def _assert_step_matches(gate, out):
    _, grads, losses, _, jgrads, jlosses = out
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL)
    assert_grads_close(grads[0], jgrads[0])
    # pass 1 and pass 2 of each side's chunk: every layer's wi through both
    # kernels (JAX traces each once; the port calls per chunk and pass)
    assert {s[0] for s in gate["port"]} == {2048, 4096} and {s[0] for s in gate["jax"]} == {
        2048, 4096}


def test_gated_f32_packed_finetune_step_matches_jax(gate):
    """One packed finetune step (f32 master backbone, 16 rows a chunk) under
    both gates, from the same weights and batch."""
    lrs = dict(learning_rate=1e-3, backbone_lr=1e-4)
    jcfg, cfg = _gated_cfgs(**lrs)
    jesm = jesm2.init_params(jax.random.key(1), jcfg.model.esm)
    jheads = jclip.init_params(jax.random.key(2), jcfg.model)
    tx = optax.chain(jax_capture(), jfinetune.make_optimizer(jcfg))
    jp = jfinetune.init_params(jesm, jheads)
    params = port_params(jesm, jheads)
    out = run_packed_steps(jfinetune.make_train_step_packed(jcfg, tx, rows_per_chunk=16),
                           finetune.make_train_step(cfg), jp, tx.init(jp), params,
                           Capturing(finetune.make_optimizer(cfg), params), {}, {}, 40,
                           steps=1)
    _assert_step_matches(gate, out)
    assert max(float(g.abs().max()) for k, g in out[1][0].items()
               if k.startswith("esm/layers/ffn/wi")) > 1e-8


def test_gated_f32_packed_lora_ffn_step_matches_jax(gate):
    """One packed LoRA step at rank 8 with adapters on the FFN too
    (``--lora-ffn``: wi and wo), under both gates; the adapters' B moved off
    zero so that every adapter gradient is generic."""
    lrs = dict(learning_rate=1e-3, backbone_lr=1e-3)
    jcfg, cfg = _gated_cfgs(**lrs)
    jesm = jesm2.init_params(jax.random.key(1), jcfg.model.esm)
    zero = jlora.init_lora(jax.random.key(3), jesm, 8, jlora.ATTN_TARGETS + jlora.FFN_TARGETS)
    adapters = {name: {"a": ab["a"],
                       "b": 0.01 * jax.random.normal(jax.random.key(i), ab["b"].shape)}
                for i, (name, ab) in enumerate(zero.items())}
    assert "ffn/wi" in adapters
    jparams = jlora.init_params(adapters, jclip.init_params(jax.random.key(2), jcfg.model))
    tx = optax.chain(jax_capture(), jlora.make_optimizer(jcfg))
    params = checkpoint.from_numpy_tree(np_tree(jparams), "cpu")
    esm = checkpoint.from_numpy_tree(np_tree(jesm), "cpu")
    out = run_packed_steps(jlora.make_train_step_packed(jcfg, tx, rows_per_chunk=16),
                           lora.make_train_step(cfg), jparams, tx.init(jparams), params,
                           Capturing(lora.make_optimizer(cfg), params), esm, jesm, 60, steps=1)
    _assert_step_matches(gate, out)
    assert max(float(g.abs().max()) for k, g in out[1][0].items()
               if k.startswith("lora/ffn/wi")) > 1e-8


# K6-f32's arithmetic on the card, emulated: EMU_N tokens (JAX's kernel
# takes N in blocks of 256) through each family's wi, its first EMU_M
# output columns (each column's sum is its own: H, not M, is what the
# arithmetic sees).
EMU_N, EMU_M = 256, 1024
K_TILE = 32   # the main loop's k-tile: 128 bytes of f32


def _tf32(x):
    """f32 -> tf32 as the kernel rounds (tf32_rna: to nearest, ties away
    from zero, on the magnitude's bits), in f32 with the low 13 bits
    cleared."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)


def _emulated_k6_f32(x, w, b, mode, products=3):
    """K6-f32's arithmetic in numpy: x and W each split into hi = tf32(v)
    and lo = tf32(v - hi); per k-tile of K_TILE, hi.hi + hi.lo + lo.hi
    (products=3), or hi.hi alone (plain TF32), summed in f32 into a fresh
    partial that is then added to the f32 sum; the bias, then gelu in f32
    (the plain version's, as ``csrc/gelu.cuh``)."""
    xh, wh = _tf32(x), _tf32(w)
    xl, wl = _tf32(x - xh), _tf32(w - wh)
    acc = np.zeros((x.shape[0], w.shape[1]), np.float32)
    for k in range(0, x.shape[1], K_TILE):
        s = slice(k, k + K_TILE)
        part = xh[:, s] @ wh[s]
        if products == 3:
            part = part + xh[:, s] @ wl[s] + xl[:, s] @ wh[s]
        acc = acc + part
    return ffn._gelu_f32(torch.from_numpy(acc + b), mode).numpy()


@functools.cache
def _wi_case(H, M, mode):
    """(x, W, b) at EMU_N tokens and the first EMU_M columns of a (H, M)
    wi, and JAX's f32 output: its Pallas kernel in interpret mode where
    ``ffn_pallas.fits`` takes the shape, else ``_eager``, the composition
    the kernel stands for."""
    m = min(M, EMU_M)
    arrays = _xwb(H + m, EMU_N, H, m)
    fn = ffn_pallas._call if ffn_pallas.fits(EMU_N, H, m) else ffn_pallas._eager
    return arrays, np.asarray(fn(*(jnp.asarray(a) for a in arrays), mode))


def _over_limit(got, want):
    """The largest |got - want| over chip_smoke.py's K6-f32 limit."""
    limit = F32_ATOL_RMS * np.sqrt(np.mean(np.square(want))) + F32_RTOL * np.abs(want)
    return float((np.abs(got - want) / limit).max())


@pytest.mark.parametrize("mode", ["erf", "tanh"])
@pytest.mark.parametrize("H,M", FFN_WIDTHS,
                         ids=["t6_8M", "t12_35M", "t30_150M", "t33_650M", "t36_3B", "t48_15B"])
def test_emulated_3xtf32_matches_the_pallas_kernel(H, M, mode):
    arrays, want = _wi_case(H, M, mode)
    got = _emulated_k6_f32(*arrays, mode)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert _over_limit(got, want) <= 1


@pytest.mark.parametrize("H,M", FFN_WIDTHS,
                         ids=["t6_8M", "t12_35M", "t30_150M", "t33_650M", "t36_3B", "t48_15B"])
def test_emulated_plain_tf32_fails_the_limit(H, M):
    arrays, want = _wi_case(H, M, "erf")
    assert _over_limit(_emulated_k6_f32(*arrays, "erf", products=1), want) > 1
