"""The port's LoRA training (``train/lora.py``: adapters merged per chunk
inside the graph, over the two-pass step of ``train/finetune.py``) against
the JAX package's, on the CPU: tiny ESM config, float32, dropout 0.

The adapters and heads of the JAX package go across as numpy. The step
checks follow ``test_torch_finetune.py``: losses within 1e-5 relative per
step, the first step's gradients within 1e-5 of each leaf's largest, the
parameters after three steps within Adam's bound. Also: the zero-init
identity, what the merge touches, the frozen base, the eval step, alpha and
the learning rates, the refusals and ``cli.main --lora-rank`` end to end
(its checkpoint loads in the JAX package and serves in the port). The packed
LoRA step (``make_train_step_packed``: the packed finetune step with the
adapter merge) against JAX's at 16 and 4 rows a chunk, against its
single-graph loss with dropout on, the packed eval step, and ``cli.main
--lora-rank --packed``.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from protein_clip_tpu.models import clip as jclip
from protein_clip_tpu.models import esm2 as jesm2
from protein_clip_tpu.train import checkpoint as jckpt
from protein_clip_tpu.train import lora as jlora
from protein_clip_tpu_torch.cli import embed, main
from protein_clip_tpu_torch.models import esm2
from protein_clip_tpu_torch.train import checkpoint, clip_engine, lora
from test_torch_finetune import (RTOL, SMALL_RUN, TINY, Capturing, assert_grads_close,
                                 assert_two_pass_equals_packed_loss, assert_within_adam_bound,
                                 engine_cfgs, jax_capture, mcfgs, np_tree, packed_cfgs,
                                 packed_wire, pair_batches, run_packed_steps)

RANK, ALPHA = 4, 8.0
LRS = dict(learning_rate=1e-3, backbone_lr=1e-3)


@pytest.fixture(scope="module")
def tiny():
    """(JAX mcfg, port mcfg, JAX base, port base, JAX params): B moved off
    its zero init by random entries so that every adapter gradient is
    generic (a constant B gives A of the output projection a gradient that
    LayerNorm's shift invariance sums to 0)."""
    jmcfg, mcfg = mcfgs()
    jesm = jesm2.init_params(jax.random.key(1), jmcfg.esm)
    zero_init = jlora.init_lora(jax.random.key(3), jesm, RANK)
    adapters = {name: {"a": ab["a"],
                       "b": 0.01 * jax.random.normal(jax.random.key(i), ab["b"].shape)}
                for i, (name, ab) in enumerate(zero_init.items())}
    jparams = jlora.init_params(adapters, jclip.init_params(jax.random.key(2), jmcfg))
    return jmcfg, mcfg, jesm, checkpoint.from_numpy_tree(np_tree(jesm), "cpu"), jparams


def port_params(jparams):
    return checkpoint.from_numpy_tree(np_tree(jparams), "cpu")


def _ids(seed, B=4, T=10):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(4, 24, (B, T)).astype(np.int32)),
            torch.ones(B, T, dtype=torch.int32))


def test_zero_init_is_identity(tiny):
    """B = 0 at init: the merged model is the frozen model, exactly."""
    _, mcfg, _, esm, _ = tiny
    adapters = lora.init_lora(torch.Generator().manual_seed(0), esm, RANK,
                              lora.ATTN_TARGETS + lora.FFN_TARGETS)
    merged = lora.merge_lora(esm, adapters, ALPHA)
    ids, mask = _ids(0)
    assert torch.equal(esm2.forward(esm, ids, mask, mcfg.esm),
                       esm2.forward(merged, ids, mask, mcfg.esm))
    a = adapters["attn/q"]["a"]
    assert a.shape == (2, 64, RANK) and a.dtype == torch.float32
    assert not adapters["ffn/wo"]["b"].any()


@pytest.mark.parametrize("ffn", [False, True])
def test_merge_changes_only_targets(tiny, ffn):
    """The targeted weights move by (alpha / r) A.B as in the JAX merge
    (within 1e-6, float32); their biases, the other weights and the
    embeddings are the base's own tensors."""
    _, _, jesm, esm, _ = tiny
    targets = lora.ATTN_TARGETS + (lora.FFN_TARGETS if ffn else ())
    jadapters = jax.tree.map(lambda a: a + 0.1, jlora.init_lora(jax.random.key(4), jesm, RANK,
                                                                targets))
    merged = lora.merge_lora(esm, port_params(jadapters), ALPHA)
    jmerged = checkpoint._flatten(np_tree(jlora.merge_lora(jesm, jadapters, ALPHA)))
    for key, t in checkpoint._flatten(merged).items():
        np.testing.assert_allclose(t.numpy(), jmerged[key], atol=1e-6, err_msg=key)
    layers, base = merged["layers"], esm["layers"]
    for group, names in (("attn", ("q", "k", "v", "o", "ln")), ("ffn", ("wi", "wo", "ln"))):
        for name in names:
            targeted = name in targets
            for leaf, t in layers[group][name].items():
                same = t is base[group][name][leaf]
                assert same == (not (targeted and leaf == "w")), (group, name, leaf)
    assert merged["embed"] is esm["embed"] and merged["final_ln"] is esm["final_ln"]


@pytest.fixture(scope="module")
def three_steps(tiny):
    jmcfg, mcfg, jesm, esm, jparams = tiny
    jcfg, cfg = engine_cfgs(jmcfg, mcfg, **LRS)
    tx = optax.chain(jax_capture(), jlora.make_optimizer(jcfg))
    jstep = jlora.make_train_step(jcfg, tx)
    jstate = tx.init(jparams)
    params = port_params(jparams)
    state = Capturing(lora.make_optimizer(cfg), params)
    step = lora.make_train_step(cfg)
    base = {k: t.clone() for k, t in checkpoint._flatten(esm).items()}
    jp, losses, jlosses, jgrads = jparams, [], [], []
    for s in range(3):
        jb, b = pair_batches(20 + s)
        jp, jstate, jloss = jstep(jp, jstate, jesm, jb, jax.random.key(s))
        params, state, loss = step(params, state, esm, b, None)
        losses.append(float(loss))
        jlosses.append(float(jloss))
        jgrads.append(jstate[0]["g"])
    return params, state.grads, losses, jp, jgrads, jlosses, base


def test_lora_steps_match_jax(three_steps):
    params, grads, losses, jp, jgrads, jlosses, _ = three_steps
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL)
    assert_grads_close(grads[0], jgrads[0])
    assert max(float(g.abs().max()) for k, g in grads[0].items() if k.endswith("/a")) > 1e-8
    assert_within_adam_bound(params, jp, grads, jgrads,
                             {"lora": LRS["backbone_lr"], "heads": LRS["learning_rate"]})


def test_base_gets_no_grad(tiny, three_steps):
    """The frozen compute-dtype base takes no gradient buffer and does not
    move; every adapter does."""
    _, _, _, esm, jparams = tiny
    params, *_, base = three_steps
    for key, t in checkpoint._flatten(esm).items():
        assert t.grad is None and not t.requires_grad, key
        assert torch.equal(t, base[key]), key
    start = checkpoint._flatten(port_params(jparams)["lora"])
    for key, t in checkpoint._flatten(params["lora"]).items():
        assert not torch.equal(t.detach(), start[key]), key


def test_eval_step_matches_jax(tiny):
    jmcfg, mcfg, jesm, esm, jparams = tiny
    jcfg, cfg = engine_cfgs(jmcfg, mcfg)
    jb, b = pair_batches(7, 12)
    want = jlora.make_eval_step(jcfg)(jparams, jesm, jb)
    got = lora.make_eval_step(cfg)(port_params(jparams), esm, b)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_alpha_learning_rates_and_refusals(tiny, monkeypatch):
    """alpha is 2 * rank unless PCT_LORA_ALPHA sets it (the JAX package's
    default_alpha); the adapters train at 1e-4 unless backbone_lr is given;
    the grouped step is refused, the packed steps build (flat packing) and
    refuse width tiers."""
    _, mcfg, _, _, _ = tiny
    monkeypatch.delenv("PCT_LORA_ALPHA", raising=False)
    assert lora.default_alpha(RANK) == 2.0 * RANK == jlora.default_alpha(RANK)
    monkeypatch.setenv("PCT_LORA_ALPHA", "3")
    assert lora.default_alpha(RANK) == 3.0 == jlora.default_alpha(RANK)
    opt = lora.make_optimizer(clip_engine.EngineConfig(model=mcfg))
    assert (opt.groups["lora"].lr, opt.groups["heads"].lr) == (1e-4, 1e-3)
    with pytest.raises(ValueError, match="length-grouped"):
        lora.make_train_step(clip_engine.EngineConfig(model=mcfg, length_groups=2))
    for make in (lora.make_train_step, lora.make_train_step_packed):
        assert callable(make(clip_engine.EngineConfig(model=mcfg, packed=True)))
        with pytest.raises(ValueError, match="flat packing only.*width-tiered finetune is "
                                             "not wired"):
            make(clip_engine.EngineConfig(model=mcfg, packed=True, packed_tiers=2))


def test_cli_main_lora(tmp_path):
    """``cli.main --lora-rank 4 --lora-ffn`` writes the run contract; its
    best_model.npz holds {heads, lora} with the tree of the JAX
    ``lora.init_params``, and ``cli.embed`` merges it into the base it
    trained against and serves."""
    assert main.main(TINY + SMALL_RUN + ["--lora-rank", "4", "--lora-ffn",
                                         "--synthetic-fixture", "--data-dir",
                                         str(tmp_path / "data"), "--runs-dir",
                                         str(tmp_path / "runs")]) == 0
    (run,) = list((tmp_path / "runs").iterdir())
    assert sorted(p.name for p in run.iterdir()) == [
        "best_model.npz", "figures", "losses_per_epoch.txt", "metrics.jsonl", "state"]
    rows = (run / "losses_per_epoch.txt").read_text().splitlines()
    assert len(rows) == 2 and all(np.isfinite(float(v)) for v in rows[1].split(","))
    jmcfg = jclip.CLIPConfig(input_dim=64, esm=jesm2.ESM2Config.tiny())
    jesm = jesm2.init_params(jax.random.key(0), jmcfg.esm)
    like = jlora.init_params(jlora.init_lora(jax.random.key(0), jesm, 4,
                                             jlora.ATTN_TARGETS + jlora.FFN_TARGETS),
                             jclip.init_params(jax.random.key(0), jmcfg))
    tree = jckpt.load_npz(run / "best_model.npz", like)
    assert jax.tree.structure(tree) == jax.tree.structure(like)
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree.leaves(tree))
    assert embed.main(TINY + ["--checkpoint", str(run / "best_model.npz"), "--fasta",
                              str(tmp_path / "data" / "receptor.fasta"), "--side", "rec",
                              "--out", str(tmp_path / "idx.npz")]) == 0
    with np.load(tmp_path / "idx.npz") as index:
        assert np.isfinite(index["embeddings"]).all()


@pytest.mark.parametrize("rows_per_chunk", [16, 4])
def test_packed_lora_steps_match_jax(tiny, rows_per_chunk):
    """Three packed LoRA steps against JAX's make_train_step_packed, held as
    the packed finetune steps are; the base takes no gradient."""
    jmcfg, mcfg, jesm, esm, jparams = tiny
    jcfg, cfg = packed_cfgs(jmcfg, mcfg, **LRS)
    tx = optax.chain(jax_capture(), jlora.make_optimizer(jcfg))
    jstep = jlora.make_train_step_packed(jcfg, tx, rows_per_chunk=rows_per_chunk)
    step = (lora.make_train_step(cfg) if rows_per_chunk == 16
            else lora.make_train_step_packed(cfg, rows_per_chunk=rows_per_chunk))
    params = port_params(jparams)
    params, grads, losses, jp, jgrads, jlosses = run_packed_steps(
        jstep, step, jparams, tx.init(jparams), params,
        Capturing(lora.make_optimizer(cfg), params), esm, jesm, 60)
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL)
    assert_grads_close(grads[0], jgrads[0])
    assert max(float(g.abs().max()) for k, g in grads[0].items() if k.endswith("/a")) > 1e-8
    assert_within_adam_bound(params, jp, grads, jgrads,
                             {"lora": LRS["backbone_lr"], "heads": LRS["learning_rate"]})
    assert all(t.grad is None for t in checkpoint._flatten(esm).values())


def test_packed_lora_two_pass_grads_equal_packed_loss_with_dropout(tiny):
    """The packed two passes over the adapter merge against the single
    graph, with head dropout 0.5."""
    from protein_clip_tpu_torch.train import optimizer

    _, _, _, esm, jparams = tiny
    _, mcfg = mcfgs(dropout=0.5)
    cfg = clip_engine.EngineConfig(model=mcfg, batch_size=4, accumulated_batches=2,
                                   packed=True)
    assert_two_pass_equals_packed_loss(
        cfg, lambda: port_params(jparams), lora.esm_view(cfg), esm,
        lambda: optimizer.multi_transform({"lora": optimizer.adam(0.0),
                                           "heads": optimizer.adam(0.0)}))


def test_packed_eval_step_matches_jax(tiny):
    jmcfg, mcfg, jesm, esm, jparams = tiny
    jcfg, cfg = packed_cfgs(jmcfg, mcfg)
    jb, b = packed_wire(61, 12)
    want = jlora.make_eval_step(jcfg)(jparams, jesm, jb)
    got = lora.make_eval_step(cfg)(port_params(jparams), esm, b)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_cli_main_lora_packed(tmp_path):
    """``cli.main --lora-rank 4 --packed`` for one tiny epoch on the CPU: the
    run contract, finite losses, a {heads, lora} checkpoint."""
    assert main.main(TINY + SMALL_RUN + ["--lora-rank", "4", "--packed",
                                         "--synthetic-fixture", "--data-dir",
                                         str(tmp_path / "data"), "--runs-dir",
                                         str(tmp_path / "runs")]) == 0
    (run,) = list((tmp_path / "runs").iterdir())
    rows = (run / "losses_per_epoch.txt").read_text().splitlines()
    assert len(rows) == 2 and all(np.isfinite(float(v)) for v in rows[1].split(","))
    with np.load(run / "best_model.npz") as ckpt:
        assert any(k.startswith("lora") for k in ckpt)
        assert not any(k.startswith("esm") for k in ckpt)
