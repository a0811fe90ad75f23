"""The port's optimizer (train/optimizer.py) against optax, on the CPU:
5 steps from the same parameters on the same gradients (made with numpy),
for each schedule, AdamW and the global-norm clip on both sides of its
threshold. Parameters agree within 1e-6 (float32; Adam's update is within
a few ulps of lr per step)."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from protein_clip_tpu.train import optimizer as jopt
from protein_clip_tpu_torch.train import optimizer

ATOL = 1e-6
STEPS = 5


def _params(rng):
    return {"w": rng.normal(size=(3, 4)).astype(np.float32),
            "head": {"b": rng.normal(size=(4,)).astype(np.float32),
                     "t": np.asarray(1.0, np.float32)}}


def _grads(rng, scale):
    return [jax.tree.map(lambda p: (rng.normal(size=p.shape) * scale).astype(np.float32),
                         _params(np.random.default_rng(0))) for _ in range(STEPS)]


def _run_optax(tx, params, grads):
    p = jax.tree.map(jnp.asarray, params)
    state = tx.init(p)
    out = []
    for g in grads:
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, p)
        p = optax.apply_updates(p, upd)
        out.append(jax.tree.map(np.asarray, p))
    return out


def _run_port(opt, params, grads):
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    state = opt.init(p)
    out = []
    for g in grads:
        for leaf, gl in zip(optimizer.tree_leaves(p), jax.tree.leaves(g)):
            leaf.grad = torch.from_numpy(np.array(gl))
        state.apply()
        out.append(jax.tree.map(lambda t: t.detach().numpy().copy(), p))
    assert state.count == len(grads)
    return out


@pytest.mark.parametrize("name,kw,scale", [
    ("constant", dict(), 1.0),
    ("warmup", dict(warmup_steps=3), 1.0),
    ("cosine", dict(schedule="cosine", total_steps=6), 1.0),
    ("cosine_warmup", dict(schedule="cosine", warmup_steps=2, total_steps=6), 1.0),
    ("adamw", dict(weight_decay=0.1), 1.0),
    ("adamw_warmup", dict(weight_decay=0.05, warmup_steps=2), 1.0),
    ("clip_active", dict(grad_clip=0.5), 1.0),          # norms ~4 > 0.5: clipped
    ("clip_idle", dict(grad_clip=50.0), 1.0),           # norms < 50: untouched
    ("clip_small_grads", dict(grad_clip=1.0), 1e-3),
])
def test_steps_match_optax(name, kw, scale):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    params, grads = _params(rng), _grads(rng, scale)
    want = _run_optax(jopt.build(1e-2, **kw), params, grads)
    got = _run_port(optimizer.build(1e-2, **kw), params, grads)
    for step, (g, w) in enumerate(zip(got, want)):
        for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
            np.testing.assert_allclose(a, b, atol=ATOL, err_msg=f"{name} step {step}")


@pytest.mark.parametrize("kw", [dict(), dict(warmup_steps=4),
                                dict(schedule="cosine", total_steps=10),
                                dict(schedule="cosine", warmup_steps=3, total_steps=10)])
def test_schedule_values_match_optax(kw):
    """lr at counts 0..12: the first update of a warmup runs at 0, and the
    cosine horizon counts from step 0, warmup included."""
    lr = 3e-3
    opt = optimizer.build(lr, **kw)
    if kw.get("schedule") == "cosine":
        sched = optax.warmup_cosine_decay_schedule(0.0, lr, kw.get("warmup_steps", 0),
                                                   kw["total_steps"])
    elif kw.get("warmup_steps"):
        sched = optax.schedules.join_schedules(
            [optax.linear_schedule(0.0, lr, kw["warmup_steps"]), optax.constant_schedule(lr)],
            [kw["warmup_steps"]])
    else:
        sched = optax.constant_schedule(lr)
    for count in range(13):
        np.testing.assert_allclose(opt.learning_rate(count), float(sched(count)), rtol=1e-6,
                                   atol=1e-12)
    assert (opt.learning_rate(0) == 0.0) == bool(kw.get("warmup_steps"))


def test_default_is_reference_adam():
    opt = optimizer.adam()
    assert (opt.lr, opt.b1, opt.b2, opt.eps, opt.weight_decay, opt.grad_clip) == (
        1e-3, 0.9, 0.999, 1e-8, 0.0, 0.0)
    state = opt.init({"w": torch.zeros(2)})
    assert isinstance(state.torch_opt, torch.optim.Adam)
    assert not isinstance(state.torch_opt, torch.optim.AdamW)
    assert isinstance(optimizer.build(1e-3, weight_decay=0.1).init(
        {"w": torch.zeros(2)}).torch_opt, torch.optim.AdamW)


@pytest.mark.parametrize("kw,match", [(dict(schedule="cosine"), "total_steps"),
                                      (dict(schedule="cosine", warmup_steps=5, total_steps=5),
                                       "warmup_steps"),
                                      (dict(schedule="linear"), "unknown")])
def test_bad_schedules_raise(kw, match):
    with pytest.raises(ValueError, match=match):
        optimizer.build(1e-3, **kw)


def test_from_config_reads_the_engine_knobs():
    class Cfg:
        learning_rate, weight_decay, warmup_steps = 2e-3, 0.01, 3
        lr_schedule, total_steps, grad_clip = "cosine", 9, 1.5

    opt = optimizer.from_config(Cfg())
    assert (opt.lr, opt.weight_decay, opt.warmup_steps, opt.schedule, opt.total_steps,
            opt.grad_clip) == (2e-3, 0.01, 3, "cosine", 9, 1.5)
    assert optimizer.from_config(Cfg(), lr=1.0, grad_clip=0.0).lr == 1.0
    assert optimizer.from_config(Cfg(), grad_clip=0.0).grad_clip == 0.0
