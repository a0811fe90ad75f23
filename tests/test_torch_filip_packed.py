"""The port's packed FILIP training (``train/filip_packed.py``, the scatter
tiers of ``train/packed_engine.tokenize_packed``) against the JAX
package's, on the CPU in float32: tiny ESM config, 32-d token heads,
dropout 0, inputs made from a numpy seed, parameters carried across as
numpy. JAX's side scores through its fused similarity in interpret mode.

- The wire with ``scatter_tiers`` 1 and 4 equal to JAX's to the bit (ids,
  owner permutations, each tier's indices and width), with a width no
  sequence takes, and through ``data/prefetch.py``.
- ``filip_sim_packed`` within 1e-6 of JAX's on the (n, n) block.
- The packed train step's loss and gradients, flat and scatter-tiered,
  with and without DCL, within 1e-5 of JAX's (the loss relative, each
  gradient of the step's largest entry); both eval steps alike.
- Port against port: scatter tiers against one flat buffer, packed against
  the one-bucket step, and gap tokens kept out of the scores.
- ``cli.main_2protein_filip --packed`` on the CPU, at 4 scatter tiers and
  at 1, and its checkpoint through JAX's loader.

The pairs are mostly short (peptides of 5-24 residues, receptors of
20-59) with one long chain a side, so the tiers differ and the max-sim's
maxima are far from ties: on long random chains over a random tiny
backbone, two tokens of a row score within f32 noise of each other, and a
max that flips between packages moves a gradient by a token's share.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protein_clip_tpu.cli import common as jcommon
from protein_clip_tpu.data.tokenizer import EsmTokenizer as JaxTokenizer
from protein_clip_tpu.models import esm2 as jesm2
from protein_clip_tpu.models import filip as jfilip
from protein_clip_tpu.ops import filip_pallas as jops
from protein_clip_tpu.ops import infonce as jinfonce
from protein_clip_tpu.train import clip_engine as jengine
from protein_clip_tpu.train import filip_packed as jfpacked
from protein_clip_tpu.train import packed_engine as jpacked
from protein_clip_tpu_torch.cli import main_2protein_filip as cli
from protein_clip_tpu_torch.data import prefetch
from protein_clip_tpu_torch.data.tokenizer import EsmTokenizer
from protein_clip_tpu_torch.models import esm2, filip
from protein_clip_tpu_torch.ops import filip as ops
from protein_clip_tpu_torch.ops.infonce import filip_loss
from protein_clip_tpu_torch.train import (checkpoint, clip_engine, filip_engine, filip_packed,
                                          optimizer, packed_engine)

SIM_ATOL = 1e-6
ATOL = RTOL = 1e-5
D = 32
N = 8
AAS = list("LAGVSERTIDPKQNFYMHWC")
TINY = ["--esm-config", "tiny", "--esm-dtype", "float32", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs: its ops are small and
    many, and under the suite's parallel workers a full thread pool a
    worker oversubscribes the CPU, whose spin-waits then cost more than the
    ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pairs(seed, long_pep=140, long_rec=300):
    """N pairs: N - 1 short a side and one long one (rows of 256 and 384:
    pep tiers [128, 256], rec tiers [128, 256, 384], the 256 rec tier
    empty)."""
    rng = np.random.default_rng(seed)
    pep = [int(k) for k in rng.integers(5, 25, N - 1)] + [long_pep]
    rec = [int(k) for k in rng.integers(20, 60, N - 1)] + [long_rec]
    return (["".join(rng.choice(AAS, k)) for k in pep],
            ["".join(rng.choice(AAS, k)) for k in rec])


def _wire(peps, recs, scatter_tiers):
    """The same pairs packed by each package: (JAX batch, port batch)."""
    return (jpacked.tokenize_packed(JaxTokenizer(), peps, recs, scatter_tiers=scatter_tiers),
            packed_engine.tokenize_packed(EsmTokenizer(), peps, recs,
                                          scatter_tiers=scatter_tiers))


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, port config, JAX backbone, port backbone, JAX heads)."""
    jesm_cfg = jesm2.ESM2Config.tiny()
    jmcfg = jfilip.FILIPConfig(input_dim=64, embedding_dim=D, dropout=0.0, esm=jesm_cfg)
    mcfg = filip.FILIPConfig(input_dim=64, embedding_dim=D, dropout=0.0,
                             esm=esm2.ESM2Config.tiny())
    jesm = jesm2.init_params(jax.random.key(1), jesm_cfg)
    return (jmcfg, mcfg, jesm, checkpoint.from_numpy_tree(_np(jesm), "cpu"),
            jfilip.init_params(jax.random.key(2), jmcfg))


# ---------------------------------------------------------------------------
# The wire
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("row_len", [128, 200, 256, 384, 512, 1000, 2048])
def test_tier_widths_match_jax(row_len):
    for n in (1, 2, 3, 4):
        assert packed_engine._tier_widths(row_len, n) == jpacked._tier_widths(row_len, n)


@pytest.mark.parametrize("scatter_tiers", [1, 4])
def test_packed_wire_matches_jax(scatter_tiers):
    jb, b = _wire(*_pairs(0), scatter_tiers)
    assert sorted(b) == sorted(jb)
    for side in ("pep", "rec"):
        for k in ("ids", "operm"):
            assert b[f"{side}_{k}"].dtype == (torch.int8 if k == "ids" else torch.int32)
            np.testing.assert_array_equal(b[f"{side}_{k}"].numpy(), np.asarray(jb[f"{side}_{k}"]))
        if scatter_tiers == 1:
            assert f"{side}_stiers" not in b
            continue
        tiers, jtiers = b[f"{side}_stiers"], jb[f"{side}_stiers"]
        assert len(tiers) == len(jtiers) > 1
        for t, jt in zip(tiers, jtiers):
            assert t["operm"].dtype == torch.int32 and t["width"] == jt["wmark"].shape[0]
            np.testing.assert_array_equal(t["operm"].numpy(), np.asarray(jt["operm"]))
    if scatter_tiers > 1:   # a width no sequence takes ships no index; others pad to 8
        assert [t["width"] for t in b["rec_stiers"]] == [128, 256, 384]
        assert [len(t["operm"]) for t in b["rec_stiers"]] == [8, 0, 8]
        assert (b["rec_stiers"][2]["operm"][1:] == N).all()


def test_the_wire_crosses_prefetch_with_its_tiers():
    """The tiers tuple is the wire's first nested leaf: to_device and the
    producer thread map every tensor in it and leave the int widths."""
    b = _wire(*_pairs(1), 4)[1]
    seen = []
    mapped = prefetch._map_tensors(b, lambda t: seen.append(t.shape) or t.clone())
    assert len(seen) == 4 + len(b["pep_stiers"]) + len(b["rec_stiers"])
    got = list(prefetch.prefetch_to_device([0, 1], lambda _: b, "cpu"))
    for out in [mapped, prefetch.to_device(b, "cpu")] + got:
        for side in ("pep", "rec"):
            for t, want in zip(out[f"{side}_stiers"], b[f"{side}_stiers"]):
                assert t["width"] == want["width"] and isinstance(t["width"], int)
                assert torch.equal(t["operm"], want["operm"])


# ---------------------------------------------------------------------------
# The scores and the steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scatter_tiers", [1, 4])
def test_filip_sim_packed_matches_jax(tiny, scatter_tiers):
    jmcfg, mcfg, jesm, esm, jheads = tiny
    jb, b = _wire(*_pairs(2), scatter_tiers)
    want = jax.jit(lambda p, batch: jfpacked.filip_sim_packed(
        p, jesm, jpacked.expand_packed_batch(batch), jmcfg, N,
        similarity_fn=jops.filip_similarity_fused))(jheads, jb)
    launches = ops.filip_similarity_fused.launches
    got = filip_packed.filip_sim_packed(checkpoint.from_numpy_tree(_np(jheads), "cpu"), esm, b,
                                        mcfg, N)
    assert ops.filip_similarity_fused.launches == launches       # the CPU runs no kernel
    for g, w in zip(got, want):
        assert g.shape == (N, N)
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=SIM_ATOL, rtol=0)


_JAX_GRADS = {}


def _jax_value_and_grad(jmcfg, jesm, use_dcl):
    """JAX's packed step's loss and gradients (its loss_fn: the packed
    similarity through the fused kernel, the FILIP InfoNCE), jitted."""
    if use_dcl not in _JAX_GRADS:
        def loss(p, batch):
            sa, sb = jfpacked.filip_sim_packed(p, jesm, jpacked.expand_packed_batch(batch),
                                               jmcfg, N, similarity_fn=jops.filip_similarity_fused)
            return jinfonce.filip_loss(sa, sb, use_dcl)
        _JAX_GRADS[use_dcl] = jax.jit(jax.value_and_grad(loss))
    return _JAX_GRADS[use_dcl]


def _capturing(state, params):
    """Keep, by leaf name, the gradients ``state.apply`` applies (zeros for
    ``emb_ffn``, which FILIP does not read)."""
    named = checkpoint._flatten(params)
    apply = state.apply

    def capture():
        state.grads = {k: torch.zeros_like(t) if t.grad is None else t.grad.detach().clone()
                       for k, t in named.items()}
        apply()

    state.apply = capture
    return state


def _port_step(mcfg, jheads, esm, batch, **kw):
    """One port packed step from JAX's heads: (loss, gradients by leaf)."""
    cfg = clip_engine.EngineConfig(model=mcfg, batch_size=N, accumulated_batches=1, packed=True,
                                   **kw)
    params = checkpoint.from_numpy_tree(_np(jheads), "cpu")
    state = _capturing(optimizer.adam(1e-3).init(params), params)
    _, _, loss = filip_engine.make_train_step(cfg)(params, state, esm, batch, None)
    return float(loss), state.grads


@pytest.mark.parametrize("use_dcl", [False, True])
@pytest.mark.parametrize("scatter_tiers", [1, 4])
def test_packed_step_matches_jax(tiny, scatter_tiers, use_dcl):
    """The loss within 1e-5 relative and every gradient within 1e-5 of the
    step's largest entry (the temperature's gradient sums terms of that
    scale that nearly cancel)."""
    jmcfg, mcfg, jesm, esm, jheads = tiny
    jb, b = _wire(*_pairs(3), scatter_tiers)
    jloss, jgrads = _jax_value_and_grad(jmcfg, jesm, use_dcl)(jheads, jb)
    jg = checkpoint._flatten(_np(jgrads))
    loss, grads = _port_step(mcfg, jheads, esm, b, scatter_tiers=scatter_tiers,
                             filip_use_dcl=use_dcl)
    np.testing.assert_allclose(loss, float(jloss), rtol=RTOL)
    assert grads.keys() == jg.keys()
    scale = max(float(np.abs(v).max()) for v in jg.values())
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jg[k], rtol=0, atol=ATOL * scale, err_msg=k)


@pytest.mark.parametrize("scatter_tiers", [1, 4])
def test_packed_eval_step_matches_jax(tiny, scatter_tiers):
    jmcfg, mcfg, jesm, esm, jheads = tiny
    kw = dict(batch_size=N, accumulated_batches=1, packed=True, scatter_tiers=scatter_tiers,
              filip_use_dcl=True)
    jb, b = _wire(*_pairs(4), scatter_tiers)
    want = jfpacked.make_eval_step_packed_filip(
        jengine.EngineConfig(model=jmcfg, **kw), jops.filip_similarity_fused)(jheads, jesm, jb)
    got = filip_engine.make_eval_step(clip_engine.EngineConfig(model=mcfg, **kw))(
        checkpoint.from_numpy_tree(_np(jheads), "cpu"), esm, b)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_scatter_tiers_match_flat_and_the_plain_step(tiny):
    """Port against port on the same pairs: the scatter-tiered step's loss
    and gradients against the flat-packed step's (the same scores, from
    blocks) within 1e-6, and the packed step against the one-bucket step
    (the same token sets, <cls> and <eos> included) within 1e-5."""
    _, mcfg, _, esm, jheads = tiny
    peps, recs = _pairs(5)
    tiered = _port_step(mcfg, jheads, esm, _wire(peps, recs, 4)[1], scatter_tiers=4)
    flat = _port_step(mcfg, jheads, esm, _wire(peps, recs, 1)[1])
    cfg = clip_engine.EngineConfig(model=mcfg, batch_size=N, accumulated_batches=1)
    params = checkpoint.from_numpy_tree(_np(jheads), "cpu")
    state = _capturing(optimizer.adam(1e-3).init(params), params)
    _, _, loss = filip_engine.make_train_step(cfg)(
        params, state, esm, clip_engine.tokenize_pair_batch(EsmTokenizer(), peps, recs), None)
    plain = (float(loss), state.grads)
    for (la, ga), (lb, gb), tol in ((tiered, flat, 1e-6), (flat, plain, ATOL)):
        np.testing.assert_allclose(la, lb, rtol=tol)
        scale = max(float(g.abs().max()) for g in gb.values())
        for k in gb:
            np.testing.assert_allclose(ga[k].numpy(), gb[k].numpy(), rtol=0, atol=tol * scale,
                                       err_msg=k)


def test_gap_tokens_and_phantom_rows_stay_out_of_the_scores():
    """Non-finite tokens in the gaps and pads of the packed rows go to the
    dump slots: the scores and the gradients stay finite, the gap tokens'
    gradients are 0, and the tiered scores equal the flat ones."""
    b = packed_engine.expand_packed_batch(_wire(*_pairs(6), 4)[1])
    rng = np.random.default_rng(6)
    packs = {side: {k: b[f"{side}_{k}"] for k in ("ids", "seg", "pos", "owner")}
             for side in ("pep", "rec")}
    tokens = {}
    for side, pk in packs.items():
        x = filip_packed._l2_normalize_tokens(
            torch.from_numpy(rng.normal(size=(*pk["ids"].shape, D)).astype(np.float32)))
        x[pk["seg"] == 0] = float("nan")
        tokens[side] = x
    outs = []
    for tiered in (False, True):
        xs = {side: x.clone().requires_grad_(True) for side, x in tokens.items()}
        tiers = {side: filip_packed._scatter_side(xs[side], packs[side],
                                                  b[f"{side}_stiers"] if tiered else None, N)
                 for side in xs}
        sims = filip_packed._sim_from_tiers(tiers["pep"], tiers["rec"], 0.5,
                                            ops.filip_similarity_fused, N)
        filip_loss(*sims, False).backward()
        for side, x in xs.items():
            assert torch.isfinite(x.grad).all()
            assert float(x.grad[packs[side]["seg"] == 0].abs().max()) == 0
        outs.append([s.detach() for s in sims])
    for a, c in zip(*outs):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=1e-6, rtol=0)


def test_maxsim_backward_in_float64_splits_ties_as_float64_autograd():
    """On the scatter tiers' blocks (phantom rows included), with tokens in
    multiples of 1/4 (every score exact, many tied maxima): the max-sim
    backward on float64 tokens runs in float64 and equals float64 autograd
    through maxsim_reference within 1e-12 of the largest entry; on f32
    tokens it returns f32."""
    b = packed_engine.expand_packed_batch(_wire(*_pairs(8), 4)[1])
    rng = np.random.default_rng(8)
    tiers = {}
    for side in ("pep", "rec"):
        pk = {k: b[f"{side}_{k}"] for k in ("ids", "seg", "pos", "owner")}
        x = torch.from_numpy(rng.integers(-2, 3, (*pk["ids"].shape, D)) / 4.0)
        tiers[side] = filip_packed._scatter_side(x.float(), pk, b[f"{side}_stiers"], N)
    blocks = [(a[0], c[0], a[1], c[1]) for a in tiers["pep"] for c in tiers["rec"]
              if len(a[0]) and len(c[0])]
    assert len(blocks) == 4 and any(int((m.sum(1) == 0).sum()) for blk in blocks
                                    for m in blk[2:])
    for ha, hb, ma, mb in blocks:
        ga, gb = (torch.from_numpy(rng.normal(size=(len(ha), len(hb)))) for _ in range(2))
        ra, rb = ha.double().requires_grad_(True), hb.double().requires_grad_(True)
        torch.autograd.backward(ops.maxsim_reference(ra, rb, ma, mb), (ga, gb))
        got = ops.maxsim_backward(ha.double(), hb.double(), ma, mb, ga, gb)
        for g, r in zip(got, (ra.grad, rb.grad)):
            assert g.dtype == torch.float64
            assert float((g - r).abs().max()) <= 1e-12 * float(r.abs().max())
        assert all(g.dtype == torch.float32 for g in ops.maxsim_backward(ha, hb, ma, mb, ga, gb))


def test_packed_steps_refuse_width_tiers_and_other_batches(tiny):
    """Width tiers build and score (each pack pair a block, equal to the
    flat scores within SIM_ATOL; tests/test_torch_tiers.py holds them
    against JAX's); a batch of another sequence count or an unpacked
    batch is refused."""
    _, mcfg, _, esm, jheads = tiny
    cfg = clip_engine.EngineConfig(model=mcfg, batch_size=N, accumulated_batches=1, packed=True)
    params = checkpoint.from_numpy_tree(_np(jheads), "cpu")
    for make in (filip_engine.make_train_step, filip_engine.make_eval_step):
        assert callable(make(clip_engine.EngineConfig(model=mcfg, packed=True, packed_tiers=2)))
    step = filip_engine.make_train_step(cfg)
    wrong = packed_engine.tokenize_packed(EsmTokenizer(), *_pairs(7), scatter_tiers=4)
    wrong = {k: v for k, v in wrong.items()}
    wrong["pep_operm"] = wrong["pep_operm"][:6]
    with pytest.raises(ValueError, match="6 pep sequences"):
        step(params, optimizer.adam().init(params), esm, wrong, None)
    with pytest.raises(ValueError, match="tokenize_packed"):
        step(params, optimizer.adam().init(params), esm,
             clip_engine.tokenize_pair_batch(EsmTokenizer(), *_pairs(7)), None)
    pairs = _pairs(7)
    tiered = packed_engine.tokenize_packed(EsmTokenizer(), *pairs, tier_widths=[128, 256])
    assert "pep_packs" in tiered and "rec_packs" in tiered
    for t, f in zip(filip_packed.filip_sim_packed(params, esm, tiered, mcfg, N),
                    filip_packed.filip_sim_packed(params, esm, _wire(*pairs, 1)[1], mcfg, N)):
        np.testing.assert_allclose(t.detach().numpy(), f.detach().numpy(), atol=SIM_ATOL)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

SMALL_RUN = ["--batch-size", "4", "--fixture-families", "30", "--embedding-dim", str(D),
             "--epochs", "1"]


@pytest.mark.parametrize("scatter_tiers", ["4", "1"])
def test_cli_packed_runs_and_its_checkpoint_loads_in_jax(tmp_path, scatter_tiers):
    """``--packed`` at 4 scatter tiers (the default) and at 1: the run
    contract with finite losses, and best_model.npz through JAX's
    load_clip_checkpoint scoring as the port's heads from the same file."""
    assert cli.main(TINY + SMALL_RUN + ["--synthetic-fixture", "--data-dir",
                                        str(tmp_path / "data"), "--runs-dir",
                                        str(tmp_path / "runs"), "--packed", "--scatter-tiers",
                                        scatter_tiers]) == 0
    (run,) = list((tmp_path / "runs").iterdir())
    assert sorted(p.name for p in run.iterdir()) == [
        "best_model.npz", "figures", "losses_per_epoch.txt", "metrics.jsonl", "state"]
    rows = (run / "losses_per_epoch.txt").read_text().splitlines()
    assert len(rows) == 2 and all(np.isfinite(float(v)) for v in rows[1].split(","))
    assert json.loads((run / "metrics.jsonl").read_text())["epoch"] == 1
    jmcfg = jfilip.FILIPConfig(input_dim=64, embedding_dim=D, esm=jesm2.ESM2Config.tiny())
    jheads, _ = jcommon.load_clip_checkpoint(run / "best_model.npz", jmcfg, {})
    mcfg = filip.FILIPConfig(input_dim=64, embedding_dim=D, esm=esm2.ESM2Config.tiny())
    heads = checkpoint.load_npz(run / "best_model.npz", filip.init_params(
        mcfg, torch.Generator(), device="meta"), "cpu")
    rng = np.random.default_rng(9)
    hp, hr = (rng.normal(size=(5, T, 64)).astype(np.float32) for T in (12, 30))
    ma = (np.arange(12)[None] < rng.integers(2, 13, (5, 1))).astype(np.int32)
    mb = (np.arange(30)[None] < rng.integers(2, 31, (5, 1))).astype(np.int32)
    want = jops.filip_similarity_fused(
        jfilip.encode_side_tokens(jheads, "pep", jnp.asarray(hp), jmcfg),
        jfilip.encode_side_tokens(jheads, "rec", jnp.asarray(hr), jmcfg),
        jnp.asarray(ma), jnp.asarray(mb), jheads["temperature"])
    got = ops.filip_similarity_fused(
        filip.encode_side_tokens(heads, "pep", torch.from_numpy(hp), mcfg),
        filip.encode_side_tokens(heads, "rec", torch.from_numpy(hr), mcfg),
        torch.from_numpy(ma), torch.from_numpy(mb), heads["temperature"])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
