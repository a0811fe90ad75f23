"""The port's FILIP training against the JAX package's, on the CPU in
float32 (tiny ESM config, 32-d token heads, dropout 0), with inputs made
from a numpy seed.

- The max-sim backward (``ops/filip.maxsim_backward``) against JAX's
  ``filip_pallas._raw_maxsim_bwd`` within 1e-6, on quantised tokens whose
  dot products are exact in f32 (so both see the same ties), with a row
  whose mask is empty, Ba != Bb, and a block budget small enough to cut
  the work into several (ib, jb) blocks.
- The gradients of ``filip_similarity_fused`` in ha, hb and t against
  ``jax.grad`` through JAX's ``filip_similarity_fused`` (its Pallas kernel
  in interpret mode, as ``tests/test_pallas_filip.py`` runs it) and, where
  no mask is empty, through the lax ``filip_similarity``: 1e-6.
- ``filip_loss`` with and without DCL; ``encode_batch_tokens`` at 1 and 2
  chunks, ``forward``, and the plain variants (grouped, token max,
  mean-average): 1e-5 (a float32 backbone, sums in another order).
- Three Adam steps of the plain and the grouped train steps, with and
  without DCL, against ``filip_engine.make_train_step`` with JAX's fused
  similarity: losses within 1e-5 relative per step, gradients within 1e-5
  of the step's largest entry; the parameters by Adam's first-update bound
  (ROADMAP, lessons): 1e-5 plus, summed over the steps, 2 lr |dg| /
  (max|g| + eps) of each step's gradient gap, which near g = 0 turns f32
  noise into up to lr. Both eval steps within 1e-5.
- ``cli.main_2protein_filip --device cpu`` end to end, its refusals (the
  packed and unfrozen modes run: ``test_torch_filip_{packed,finetune}.py``), and
  its ``best_model.npz`` through JAX's ``cli/common.load_clip_checkpoint``
  (the loader ``retrieve --filip`` uses), which gives the same scores.
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
from protein_clip_tpu.train import filip_engine as jfengine
from protein_clip_tpu.train import optimizer as jopt
from protein_clip_tpu_torch.cli import main_2protein_filip as cli
from protein_clip_tpu_torch.data.tokenizer import EsmTokenizer
from protein_clip_tpu_torch.models import esm2, filip
from protein_clip_tpu_torch.ops import filip as ops
from protein_clip_tpu_torch.ops import infonce
from protein_clip_tpu_torch.train import checkpoint, clip_engine, filip_engine, optimizer

BWD_ATOL = 1e-6
ATOL = RTOL = 1e-5
LR = 1e-3
D = 32
AAS = list("LAGVSERTIDPKQNFYMHWC")
TINY = ["--esm-config", "tiny", "--esm-dtype", "float32", "--device", "cpu"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _masks(rng, Ba, Bb, TA, TB, empty):
    """Padded masks with true lengths over [2, T]; ``empty``: a-row 1 and
    b-row 0 hold no valid token."""
    ma = (np.arange(TA)[None] < rng.integers(2, TA + 1, (Ba, 1))).astype(np.int32)
    mb = (np.arange(TB)[None] < rng.integers(2, TB + 1, (Bb, 1))).astype(np.int32)
    if empty:
        ma[1 % Ba] = 0
        mb[0] = 0
    return ma, mb


# ---------------------------------------------------------------------------
# The max-sim backward
# ---------------------------------------------------------------------------

BWD_CASES = {   # (Ba, Bb, TA, TB, empty rows, budget: None = the default 2^26)
    "square": (4, 4, 16, 24, False, None),
    "rectangular": (3, 5, 12, 40, False, None),
    "empty_rows": (4, 6, 20, 17, True, None),
    "several_blocks": (6, 10, 16, 24, True, 2 * 16 * 24),
    "one_pair_a_block": (5, 7, 9, 33, True, 1),
}


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_maxsim_backward_matches_jax(case):
    """Tokens of entries in {-1, -1/2, 0, 1/2, 1}: every dot product is
    exact in f32, so the rows and columns hold exact ties, both packages
    see the same ones and split the max's gradient over them."""
    Ba, Bb, TA, TB, empty, budget = BWD_CASES[case]
    rng = np.random.default_rng(len(case))
    ha = (rng.integers(-2, 3, (Ba, TA, D)) / 2).astype(np.float32)
    hb = (rng.integers(-2, 3, (Bb, TB, D)) / 2).astype(np.float32)
    ma, mb = _masks(rng, Ba, Bb, TA, TB, empty)
    ga, gb = (rng.normal(size=(Ba, Bb)).astype(np.float32) for _ in range(2))
    s = np.einsum("atd,jsd->ajts", ha, hb)
    valid = (ma[:, None, :, None] * mb[None, :, None, :]) > 0
    sm = np.where(valid, s, -np.inf)
    ties = ((sm == sm.max(3, keepdims=True)) & valid).sum(3)
    assert (ties > 1).any()                       # the case holds ties
    kw = {} if budget is None else {"budget_elems": budget}
    got = ops.maxsim_backward(*map(_t, (ha, hb, ma, mb, ga, gb)), **kw)
    want = jops._raw_maxsim_bwd(*map(jnp.asarray, (ha, hb, ma, mb, ga, gb)),
                                budget_elems=1 << 26 if budget is None else budget)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=BWD_ATOL, rtol=0)
    if empty:   # rows with no valid token take no gradient
        assert float(got[0][1].abs().max()) == 0 and float(got[1][0].abs().max()) == 0
    if budget is not None:  # the blocks change the sums' order only
        whole = ops.maxsim_backward(*map(_t, (ha, hb, ma, mb, ga, gb)))
        for g, w in zip(got, whole):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=BWD_ATOL, rtol=0)


GRAD_CASES = {"no_empty_rows": (3, 4, 16, 24, False), "rectangular": (2, 5, 20, 12, False),
              "empty_rows": (4, 3, 16, 20, True)}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_fused_gradients_match_jax(case):
    """d/d(ha, hb, t) of a weighted sum of both outputs, through the port's
    wrapper (its autograd Function: plain forward, maxsim_backward) and
    through jax.grad of JAX's fused similarity (interpret mode); through
    the lax oracle too where no mask is empty (it leaves an empty row's
    max at f32-min)."""
    Ba, Bb, TA, TB, empty = GRAD_CASES[case]
    rng = np.random.default_rng(100 + len(case))
    ha, hb = _unit(rng.normal(size=(Ba, TA, D))), _unit(rng.normal(size=(Bb, TB, D)))
    ma, mb = _masks(rng, Ba, Bb, TA, TB, empty)
    wa, wb = (rng.normal(size=(Ba, Bb)).astype(np.float32) for _ in range(2))
    t0 = np.float32(0.7)

    xa, xb, xt = (_t(x).requires_grad_(True) for x in (ha, hb, np.asarray(t0)))
    sa, sb = ops.filip_similarity_fused(xa, xb, _t(ma), _t(mb), xt)
    ((sa * _t(wa)).sum() + (sb * _t(wb)).sum()).backward()
    got = [x.grad.numpy() for x in (xa, xb, xt)]

    def loss(sim_fn):
        def f(a, b, t):
            oa, ob = sim_fn(a, b, jnp.asarray(ma), jnp.asarray(mb), t)
            return jnp.sum(oa * wa) + jnp.sum(ob * wb)
        return jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(ha), jnp.asarray(hb),
                                              jnp.asarray(t0))

    oracles = [jops.filip_similarity_fused] + ([] if empty else [jfilip.filip_similarity])
    for sim_fn in oracles:
        for g, w in zip(got, loss(sim_fn)):
            np.testing.assert_allclose(g, np.asarray(w), atol=BWD_ATOL, rtol=0)


def test_fused_under_inference_mode_keeps_its_scores():
    """Serving calls the wrapper under inference_mode: the same scores as
    with a gradient, no graph."""
    rng = np.random.default_rng(5)
    ha, hb = _unit(rng.normal(size=(3, 10, D))), _unit(rng.normal(size=(4, 14, D)))
    ma, mb = _masks(rng, 3, 4, 10, 14, True)
    with torch.inference_mode():
        served = ops.filip_similarity_fused(_t(ha), _t(hb), _t(ma), _t(mb), 0.5)
    trained = ops.filip_similarity_fused(_t(ha).requires_grad_(True), _t(hb), _t(ma), _t(mb),
                                         torch.tensor(0.5, requires_grad=True))
    for s, t in zip(served, trained):
        assert not s.requires_grad and t.requires_grad
        assert torch.equal(s, t.detach())


# ---------------------------------------------------------------------------
# The loss and the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_dcl", [False, True])
def test_filip_loss_matches_jax(use_dcl):
    rng = np.random.default_rng(7)
    sa, sb = (rng.normal(size=(6, 6)).astype(np.float32) * 3 for _ in range(2))
    xa, xb = _t(sa).requires_grad_(True), _t(sb).requires_grad_(True)
    loss = infonce.filip_loss(xa, xb, use_dcl)
    loss.backward()
    want, wgrads = jax.value_and_grad(
        lambda a, b: jinfonce.filip_loss(a, b, use_dcl), argnums=(0, 1))(jnp.asarray(sa),
                                                                         jnp.asarray(sb))
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-6)
    for x, w in zip((xa, xb), wgrads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), atol=1e-6)
    for x in (sa, sb):
        np.testing.assert_allclose(float(infonce.filip_direction_loss(_t(x), use_dcl)),
                                   float(jinfonce.filip_direction_loss(jnp.asarray(x), use_dcl)),
                                   rtol=1e-6)


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, port config, JAX backbone, port backbone, JAX heads):
    tiny backbone, 32-d token heads, dropout 0."""
    jesm_cfg = jesm2.ESM2Config.tiny()
    jmcfg = jfilip.FILIPConfig(input_dim=64, embedding_dim=D, dropout=0.0, esm=jesm_cfg)
    mcfg = filip.FILIPConfig(input_dim=64, embedding_dim=D, dropout=0.0,
                             esm=esm2.ESM2Config.tiny())
    jesm = jesm2.init_params(jax.random.key(1), jesm_cfg)
    return (jmcfg, mcfg, jesm, checkpoint.from_numpy_tree(_np(jesm), "cpu"),
            jfilip.init_params(jax.random.key(2), jmcfg))


def _pairs(seed, n):
    rng = np.random.default_rng(seed)
    return (["".join(rng.choice(AAS, int(k))) for k in rng.integers(5, 25, n)],
            ["".join(rng.choice(AAS, int(k))) for k in rng.integers(20, 60, n)])


def _batch(pkg, peps, recs, groups):
    """The same strings tokenized by one package: 'jax' or 'port'."""
    if pkg == "jax":
        tok = JaxTokenizer()
        return (jengine.tokenize_grouped(tok, peps, recs, groups) if groups > 1
                else jengine.tokenize_pair_batch(tok, peps, recs))
    tok = EsmTokenizer()
    return (clip_engine.tokenize_grouped(tok, peps, recs, groups) if groups > 1
            else clip_engine.tokenize_pair_batch(tok, peps, recs))


@pytest.mark.parametrize("num_chunks", [1, 2])
def test_encode_batch_tokens_matches_jax(tiny, num_chunks):
    jmcfg, mcfg, jesm, esm, jheads = tiny
    peps, recs = _pairs(0, 6)
    jb = jengine.expand_batch(_batch("jax", peps, recs, 1))
    b = clip_engine.expand_batch(_batch("port", peps, recs, 1))
    got = filip.encode_batch_tokens(checkpoint.from_numpy_tree(_np(jheads), "cpu"), esm, b,
                                    mcfg, num_chunks=num_chunks)
    want = jfilip.encode_batch_tokens(jheads, jesm, jb, jmcfg, num_chunks=num_chunks)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=ATOL)


def test_forward_matches_jax_and_defaults_to_the_fused_similarity(tiny):
    jmcfg, mcfg, jesm, esm, jheads = tiny
    peps, recs = _pairs(1, 6)
    jb = jengine.expand_batch(_batch("jax", peps, recs, 1))
    b = clip_engine.expand_batch(_batch("port", peps, recs, 1))
    params = checkpoint.from_numpy_tree(_np(jheads), "cpu")
    got = filip.forward(params, esm, b, mcfg)
    want = jfilip.forward(jheads, jesm, jb, jmcfg, similarity_fn=jops.filip_similarity_fused)
    lax = filip.forward(params, esm, b, mcfg, similarity_fn=filip.filip_similarity)
    for g, w, x in zip(got, want, lax):
        assert g.shape == (6, 6)
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=ATOL)
        np.testing.assert_allclose(x.detach().numpy(), np.asarray(w), atol=ATOL)


def _groups(seed):
    rng = np.random.default_rng(seed)
    ha, hb = _unit(rng.normal(size=(2, 3, 10, D))), _unit(rng.normal(size=(3, 3, 14, D)))
    ma = (np.arange(10)[None, None] < rng.integers(1, 11, (2, 3, 1))).astype(np.int32)
    mb = (np.arange(14)[None, None] < rng.integers(1, 15, (3, 3, 1))).astype(np.int32)
    return ha, hb, ma, mb


@pytest.mark.parametrize("variant", ["grouped", "token_max", "mean_average"])
def test_similarity_variants_match_jax(variant):
    ha, hb, ma, mb = _groups(11)
    t = np.float32(0.8)
    if variant == "grouped":
        got = filip.filip_similarity_grouped(_t(ha), _t(hb), _t(ma), _t(mb), torch.tensor(t))
        want = jfilip.filip_similarity_grouped(*map(jnp.asarray, (ha, hb, ma, mb, t)))
        assert got[0].shape == (2, 3, 3, 3)
    elif variant == "token_max":
        got = [filip.token_max_similarity(_t(ha[0]), _t(hb[0]))]
        want = [jfilip.token_max_similarity(jnp.asarray(ha[0]), jnp.asarray(hb[0]))]
    else:
        got = [filip.mean_average_similarity(_t(ha[0]), _t(hb[0]), _t(ma[0]), _t(mb[0]),
                                             torch.tensor(t))]
        want = [jfilip.mean_average_similarity(*map(jnp.asarray, (ha[0], hb[0], ma[0], mb[0],
                                                                  t)))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


# ---------------------------------------------------------------------------
# The train and eval steps
# ---------------------------------------------------------------------------

def _capturing(state, params):
    """Make ``state.apply`` keep, by leaf name, the gradients it applies
    (zeros for ``emb_ffn``, which FILIP does not read: it gets none)."""
    named = checkpoint._flatten(params)
    apply = state.apply

    def capture():
        state.grads = {k: torch.zeros_like(t) if t.grad is None else t.grad.detach().clone()
                       for k, t in named.items()}
        apply()

    state.apply = capture
    return state


def _jax_grad_fn(jmcfg, jcfg, groups):
    """JAX's gradients of its train step's FILIP loss (through its fused
    similarity), jitted: (heads, backbone, batch) -> flat gradients."""
    def loss(p, jesm, jbatch):
        if groups == 1:
            b = jengine.expand_batch(jbatch)
            sa, sb = jfilip.forward(p, jesm, b, jmcfg, similarity_fn=jops.filip_similarity_fused,
                                    num_chunks=jfengine._snap_chunks(jcfg.batch_size,
                                                                     jcfg.num_chunks))
            return jinfonce.filip_loss(sa, sb, jcfg.filip_use_dcl)
        sides = []
        for b in map(jengine.expand_batch, jbatch):
            n = jfengine._snap_chunks(b["pep_ids"].shape[0], max(1, jcfg.num_chunks // groups))
            ha, hb = jfilip.encode_batch_tokens(p, jesm, b, jmcfg, num_chunks=n)
            sides.append((ha, hb, b["pep_mask"], b["rec_mask"]))
        blocks = [[jops.filip_similarity_fused(a[0], b[1], a[2], b[3], p["temperature"])
                   for b in sides] for a in sides]
        return jinfonce.filip_loss(jnp.block([[x[0] for x in r] for r in blocks]),
                                   jnp.block([[x[1] for x in r] for r in blocks]),
                                   jcfg.filip_use_dcl)

    grad = jax.jit(jax.grad(loss))
    return lambda p, jesm, jbatch: checkpoint._flatten(_np(grad(p, jesm, jbatch)))


@pytest.mark.parametrize("use_dcl", [False, True])
@pytest.mark.parametrize("groups", [1, 2])
def test_train_steps_match_jax(tiny, groups, use_dcl):
    """Three Adam steps (8 pairs, 2 backbone chunks) from the same heads:
    each step's loss, and its gradients (JAX's taken at its own parameters)
    within 1e-5 of the step's largest gradient entry (a leaf such as the
    temperature's sums terms of that scale that nearly cancel), then the
    parameters, each within 1e-5 plus what Adam's updates allow for the
    steps' gradient gaps."""
    jmcfg, mcfg, jesm, esm, jheads = tiny
    kw = dict(batch_size=8, accumulated_batches=1, num_chunks=2, length_groups=groups,
              filip_use_dcl=use_dcl)
    jcfg = jengine.EngineConfig(model=jmcfg, **kw)
    cfg = clip_engine.EngineConfig(model=mcfg, **kw)
    tx = jopt.adam(LR)
    jstep = jfengine.make_train_step(jcfg, tx, similarity_fn=jops.filip_similarity_fused)
    jgrad = _jax_grad_fn(jmcfg, jcfg, groups)
    step = filip_engine.make_train_step(cfg)
    jp, jstate = jheads, tx.init(jheads)
    params = checkpoint.from_numpy_tree(_np(jheads), "cpu")
    state = _capturing(optimizer.adam(LR).init(params), params)
    launches = ops.filip_similarity_fused.launches
    allowed = {k: 1e-5 for k in checkpoint._flatten(params)}
    for s in range(3):
        peps, recs = _pairs(10 + s, 8)
        jbatch = _batch("jax", peps, recs, groups)
        jg = jgrad(jp, jesm, jbatch)
        jp, jstate, jloss = jstep(jp, jstate, jesm, jbatch, jax.random.key(s))
        params, state, loss = step(params, state, esm, _batch("port", peps, recs, groups), None)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
        assert state.grads.keys() == jg.keys()
        scale = max(float(np.abs(v).max()) for v in jg.values())
        for k, g in state.grads.items():
            g = g.numpy()
            np.testing.assert_allclose(g, jg[k], rtol=0, atol=ATOL * scale, err_msg=k)
            allowed[k] = allowed[k] + 2 * LR * np.abs(g - jg[k]) / (
                np.maximum(np.abs(g), np.abs(jg[k])) + 1e-8)
    assert ops.filip_similarity_fused.launches == launches      # the CPU runs no kernel
    flat_j = checkpoint._flatten(_np(jp))
    for k, v in checkpoint._flatten(params).items():
        assert (np.abs(v.detach().numpy() - flat_j[k]) <= allowed[k]).all(), k


@pytest.mark.parametrize("groups", [1, 2])
def test_eval_steps_match_jax(tiny, groups):
    jmcfg, mcfg, jesm, esm, jheads = tiny
    jcfg = jengine.EngineConfig(model=jmcfg, batch_size=12, num_chunks=2, length_groups=groups)
    cfg = clip_engine.EngineConfig(model=mcfg, batch_size=12, num_chunks=2, length_groups=groups)
    params = checkpoint.from_numpy_tree(_np(jheads), "cpu")
    peps, recs = _pairs(3, 12)
    for dcl in (False, True):
        want = jfengine.make_eval_step(jcfg, jops.filip_similarity_fused, dcl)(
            jheads, jesm, _batch("jax", peps, recs, groups))
        got = filip_engine.make_eval_step(cfg, use_dcl=dcl)(params, esm,
                                                            _batch("port", peps, recs, groups))
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_engine_refuses_packed_and_a_single_batch_when_grouped(tiny):
    """Packed steps build (train/filip_packed.py, which supersedes the
    groups), width-tiered too (tests/test_torch_tiers.py runs them), and a
    grouped step refuses a single batch."""
    _, mcfg, _, esm, _ = tiny
    for make in (filip_engine.make_train_step, filip_engine.make_eval_step):
        assert callable(make(clip_engine.EngineConfig(model=mcfg, packed=True, length_groups=2,
                                                      scatter_tiers=4)))
        assert callable(make(clip_engine.EngineConfig(model=mcfg, packed=True, packed_tiers=2)))
    grouped = clip_engine.EngineConfig(model=mcfg, length_groups=2)
    one = _batch("port", *_pairs(0, 4), 1)
    with pytest.raises(ValueError, match="tuple"):
        filip_engine.make_train_step(grouped)(None, None, esm, one, None)
    with pytest.raises(ValueError, match="tuple"):
        filip_engine.make_eval_step(grouped)(None, esm, one)
    assert [filip_engine._snap_chunks(b, w) for b, w in ((10, 1), (10, 4), (10, 16), (8, 3))] \
        == [jfengine._snap_chunks(b, w) for b, w in ((10, 1), (10, 4), (10, 16), (8, 3))] \
        == [1, 2, 10, 2]


# ---------------------------------------------------------------------------
# The CLI, end to end on the CPU
# ---------------------------------------------------------------------------

SMALL_RUN = ["--batch-size", "4", "--fixture-families", "60", "--embedding-dim", str(D)]


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("filip_cli")
    assert cli.main(TINY + SMALL_RUN + ["--synthetic-fixture", "--data-dir", str(d / "data"),
                                        "--runs-dir", str(d / "runs"), "--epochs", "2",
                                        "--length-groups", "2", "--use-dcl"]) == 0
    (run,) = list((d / "runs").iterdir())
    return d, run


def test_cli_writes_the_run_contract(cli_run):
    d, run = cli_run
    assert sorted(p.name for p in run.iterdir()) == [
        "best_model.npz", "figures", "losses_per_epoch.txt", "metrics.jsonl", "state"]
    rows = run.joinpath("losses_per_epoch.txt").read_text().splitlines()
    assert rows[0] == "Epoch,Train Loss,Validation Loss" and len(rows) == 3
    assert all(np.isfinite(float(v)) for r in rows[1:] for v in r.split(","))
    metrics = [json.loads(x) for x in run.joinpath("metrics.jsonl").read_text().splitlines()]
    assert [m["epoch"] for m in metrics] == [1, 2]
    assert {p.name for p in (d / "data").iterdir()} >= {"protein1.fasta", "protein2.fasta"}


def test_cli_checkpoint_loads_in_jax_with_the_same_scores(cli_run):
    """best_model.npz through JAX's load_clip_checkpoint (what its
    retrieve --filip reads): the same FILIP scores as the port's heads
    from the same file, on the same hidden states."""
    _, run = cli_run
    jesm_cfg = jesm2.ESM2Config.tiny()
    jmcfg = jfilip.FILIPConfig(input_dim=64, embedding_dim=D, esm=jesm_cfg)
    jheads, _ = jcommon.load_clip_checkpoint(run / "best_model.npz", jmcfg, {})
    mcfg = filip.FILIPConfig(input_dim=64, embedding_dim=D, esm=esm2.ESM2Config.tiny())
    heads = checkpoint.load_npz(run / "best_model.npz", filip.init_params(
        mcfg, torch.Generator(), device="meta"), "cpu")
    rng = np.random.default_rng(9)
    hp, hr = (rng.normal(size=(5, T, 64)).astype(np.float32) for T in (12, 30))
    ma, mb = _masks(rng, 5, 5, 12, 30, False)
    want = jops.filip_similarity_fused(
        jfilip.encode_side_tokens(jheads, "pep", jnp.asarray(hp), jmcfg),
        jfilip.encode_side_tokens(jheads, "rec", jnp.asarray(hr), jmcfg),
        jnp.asarray(ma), jnp.asarray(mb), jheads["temperature"])
    got = ops.filip_similarity_fused(filip.encode_side_tokens(heads, "pep", _t(hp), mcfg),
                                     filip.encode_side_tokens(heads, "rec", _t(hr), mcfg),
                                     _t(ma), _t(mb), heads["temperature"])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("extra,error,match", [
    (["--packed", "--tp", "2"], ValueError, "DP-only"),
    (["--finetune", "--esm-dtype", "int8"], NotImplementedError, "int8"),
    (["--lora-rank", "4", "--length-groups", "2"], SystemExit, "length-groups"),
    (["--dp", "3"], SystemExit, "divisible by --dp 3"),
    (["--finetune", "--lora-rank", "4"], SystemExit, "mutually exclusive"),
    (["--finetune", "--length-groups", "2"], SystemExit, "length-groups"),
    (["--lora-rank", "4", "--packed", "--pack-tiers", "2"], SystemExit, "flat packing")])
def test_cli_refuses_what_is_not_ported(tmp_path, extra, error, match):
    with pytest.raises(error, match=match):
        cli.main(TINY + ["--runs-dir", str(tmp_path / "runs")] + extra)
    assert not (tmp_path / "runs").exists()


def test_cli_defaults_and_cuda_without_a_card(tmp_path):
    args = cli.build_argparser().parse_args([])
    assert (args.batch_size, args.epochs, args.num_chunks, args.length_groups,
            args.scatter_tiers, args.max_sequence_length, args.use_dcl, args.device) == (
        10, 10, 1, 1, 4, 2000, False, "cuda")
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--esm-config", "tiny", "--runs-dir", str(tmp_path / "runs")])
