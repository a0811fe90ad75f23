"""K6's plain path in the port (``ops/ffn.dense_gelu`` on CPU tensors, the
``_wi_gelu`` route of ``models/esm2``) against the JAX package's
``ops/ffn_pallas``: the Pallas kernel in interpret mode (``_call``, as
``tests/test_ffn_pallas.py`` runs it), the eager composition ``_eager``, and
gradients through ``dense_gelu``'s custom VJP.

Tolerances, as ``tests/test_ffn_pallas.py`` states them: float32 2e-6
absolute (the same op order, products summed in other orders); bfloat16 0.05
absolute (a couple of bf16 ulps on O(1) activations). Largest bf16 readings:
0.015625 against the interpret-mode kernel (one bf16 ulp at 2.05; its
interpreted dot rounds elsewhere, and 28% of the outputs differ by an ulp),
0.00098 against ``_eager`` (one ulp at 0.064; 0.02% differ). Gradients 1e-3
absolute and relative. Inputs come from a numpy seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protein_clip_tpu.models import esm2 as jesm2
from protein_clip_tpu.ops import ffn_pallas
from protein_clip_tpu_torch.models import esm2
from protein_clip_tpu_torch.ops import ffn
from protein_clip_tpu_torch.train.checkpoint import from_numpy_tree

F32_ATOL, BF16_ATOL, GRAD_TOL = 2e-6, 0.05, 1e-3


def _xwb(seed, N=512, H=128, M=512):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N, H)).astype(np.float32),
            (rng.normal(size=(H, M)) * 0.1).astype(np.float32),
            (rng.normal(size=(M,)) * 0.1).astype(np.float32))


def _port(arrays, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _jax(arrays, dtype):
    return [jnp.asarray(a, dtype) for a in arrays]


@pytest.mark.parametrize("mode", ["erf", "tanh"])
@pytest.mark.parametrize("jax_fn", ["pallas_interpret", "eager"])
def test_forward_f32_matches_jax(mode, jax_fn):
    arrays = _xwb(0)
    fn = ffn_pallas._call if jax_fn == "pallas_interpret" else ffn_pallas._eager
    want = np.asarray(fn(*_jax(arrays, jnp.float32), mode))
    got = ffn.dense_gelu(*_port(arrays, torch.float32), mode)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL)


@pytest.mark.parametrize("mode", ["erf", "tanh"])
@pytest.mark.parametrize("jax_fn", ["pallas_interpret", "eager"])
def test_forward_bf16_matches_jax(mode, jax_fn):
    arrays = _xwb(1)
    fn = ffn_pallas._call if jax_fn == "pallas_interpret" else ffn_pallas._eager
    want = np.asarray(fn(*_jax(arrays, jnp.bfloat16), mode), np.float32)
    got = ffn.dense_gelu(*_port(arrays, torch.bfloat16), mode)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    assert err.max() <= BF16_ATOL, err.max()
    if jax_fn == "eager":
        # the same rounding points as _eager: all but a few outputs agree to
        # the bit (the interpret-mode kernel rounds elsewhere: 28% differ)
        assert (err > 0).mean() < 1e-2, (err > 0).mean()


@pytest.mark.parametrize("mode", ["erf", "tanh"])
def test_grads_match_jax_custom_vjp(mode):
    arrays = _xwb(2)

    def jloss(a, c, d):
        return jnp.sum(ffn_pallas.dense_gelu(a, c, d, mode) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*_jax(arrays, jnp.float32))
    inputs = [t.requires_grad_(True) for t in _port(arrays, torch.float32)]
    (ffn.dense_gelu(*inputs, mode) ** 2).sum().backward()
    for t, w in zip(inputs, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=GRAD_TOL, rtol=GRAD_TOL)


def test_backward_is_the_plain_composition():
    """dense_gelu's gradients are autograd's through dense_gelu_reference,
    to the bit, also for an input that needs none."""
    x, w, b = _port(_xwb(3, N=64, H=32, M=48), torch.float32)
    g = torch.from_numpy(np.random.default_rng(4).normal(size=(64, 48)).astype(np.float32))
    got_inputs = [x.clone(), w.clone().requires_grad_(True), b.clone().requires_grad_(True)]
    ffn.dense_gelu(*got_inputs, "erf").backward(g)
    want_inputs = [x.clone(), w.clone().requires_grad_(True), b.clone().requires_grad_(True)]
    ffn.dense_gelu_reference(*want_inputs, "erf").backward(g)
    assert got_inputs[0].grad is None
    for a, c in zip(got_inputs[1:], want_inputs[1:]):
        assert torch.equal(a.grad, c.grad)


def test_fits_takes_every_t30_150m_shape():
    for n in (64, 128, 512, 2048, 32 * 320, 256 * 192):
        assert ffn.fits(n, 640, 2560)
    assert not ffn.fits(64, 644, 2560) and not ffn.fits(64, 640, 2564)
    assert not ffn.fits(0, 640, 2560)


def _routed(monkeypatch):
    """Count the port's dense_gelu calls (the CPU runs no kernel to count)."""
    calls = []
    plain = ffn.dense_gelu

    def counted(*args):
        calls.append(args[0].shape)
        return plain(*args)

    monkeypatch.setattr(ffn, "dense_gelu", counted)
    return calls


@pytest.mark.parametrize("mode", ["erf", "tanh"])
def test_wi_gelu_under_the_gate_matches_jax(monkeypatch, mode):
    monkeypatch.setenv("PCT_FFN_PALLAS", "1")
    monkeypatch.setattr(ffn_pallas, "enabled", lambda: True)
    jcfg = jesm2.ESM2Config.tiny(gelu=mode)
    cfg = esm2.ESM2Config.tiny(gelu=mode)
    rng = np.random.default_rng(5)
    h = rng.normal(size=(4, 128, cfg.hidden_size)).astype(np.float32)
    w = (rng.normal(size=(cfg.hidden_size, 512)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(512,)) * 0.1).astype(np.float32)
    want = np.asarray(jesm2._wi_gelu(jnp.asarray(h), {"w": jnp.asarray(w),
                                                      "b": jnp.asarray(b)}, jcfg))
    calls = _routed(monkeypatch)
    got = esm2._wi_gelu(torch.from_numpy(h), {"w": torch.from_numpy(w),
                                              "b": torch.from_numpy(b)}, cfg)
    assert calls == [(4 * 128, cfg.hidden_size)]
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL)


@pytest.mark.parametrize("gate", ["0", "1"])
def test_wi_gelu_explicit_gelu_wins_over_pct_gelu(monkeypatch, gate):
    """An explicit gelu= wins over a stale PCT_GELU with the gate on and off,
    so the gate changes speed only. (The JAX package's _wi_gelu reads
    PCT_GELU first under its gate; the port does not copy that.)"""
    monkeypatch.setenv("PCT_FFN_PALLAS", gate)
    monkeypatch.setenv("PCT_GELU", "tanh")
    cfg = esm2.ESM2Config.tiny(gelu="erf")
    modes = []
    plain = ffn.dense_gelu
    monkeypatch.setattr(ffn, "dense_gelu", lambda *a: modes.append(a[3]) or plain(*a))
    torch.manual_seed(0)
    h = torch.randn(2, 8, cfg.hidden_size)
    wi = {"w": torch.randn(cfg.hidden_size, 128), "b": torch.zeros(128)}
    got = esm2._wi_gelu(h, wi, cfg)
    assert modes == (["erf"] if gate == "1" else [])
    want = esm2._gelu(esm2._dense(h, wi), "erf")
    torch.testing.assert_close(got, want, atol=F32_ATOL, rtol=0)
    assert not torch.allclose(got, esm2._gelu(esm2._dense(h, wi), "tanh"), atol=F32_ATOL, rtol=0)


def test_gate_off_and_int8_tree_take_the_plain_route(monkeypatch):
    cfg = esm2.ESM2Config.tiny()
    calls = _routed(monkeypatch)
    h = torch.randn(2, 8, cfg.hidden_size)
    wi = {"w": torch.randn(cfg.hidden_size, 128), "b": torch.zeros(128)}
    monkeypatch.delenv("PCT_FFN_PALLAS", raising=False)
    esm2._wi_gelu(h, wi, cfg)
    monkeypatch.setenv("PCT_FFN_PALLAS", "1")
    qwi = esm2.quantize_params({"embed": {}, "final_ln": {}, "layers": {
        "attn": {}, "ffn": {"wi": {k: v[None] for k, v in wi.items()}}}})["layers"]["ffn"]["wi"]
    esm2._wi_gelu(h, {k: v[0] for k, v in qwi.items()}, cfg)
    assert calls == []


def test_two_layer_forward_under_the_gate_matches_jax(monkeypatch):
    """A tiny two-layer backbone, both packages under PCT_FFN_PALLAS=1 (the
    JAX kernel in interpret mode: B*T = 256 and M = 512 fit its blocks);
    every layer's wi + gelu goes through the port's dense_gelu."""
    monkeypatch.setenv("PCT_FFN_PALLAS", "1")
    monkeypatch.setattr(ffn_pallas, "enabled", lambda: True)
    small = dict(hidden_size=128, num_layers=2, num_heads=4, intermediate_size=512, gelu="erf")
    jcfg, cfg = jesm2.ESM2Config(**small), esm2.ESM2Config(**small)
    rng = np.random.default_rng(6)
    ids = rng.integers(4, 24, (2, 128)).astype(np.int32)
    mask = np.ones((2, 128), np.int32)
    mask[1, 90:] = 0
    ids[1, 90:] = 1
    jparams = jesm2.init_params(jax.random.key(0), jcfg)
    want = np.asarray(jesm2.forward(jparams, jnp.asarray(ids), jnp.asarray(mask), jcfg))
    params = from_numpy_tree(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    calls = _routed(monkeypatch)
    got = esm2.forward(params, torch.from_numpy(ids), torch.from_numpy(mask), cfg).numpy()
    assert calls == [(256, 128)] * 2
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], atol=2e-5)
