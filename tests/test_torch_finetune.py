"""The port's unfrozen-backbone CLIP training (``train/finetune.py`` over the
two-pass ``train/gradcache.gradcache_value_and_grad`` and the two-group
optimizer) against the JAX package's, on the CPU: tiny ESM config, float32,
dropout 0 for parity.

Parameters go across as numpy (``checkpoint.from_numpy_tree``), batches are
tokenized by each package from the same strings, and three steps run on
both sides from the same weights. Per step the losses agree within 1e-5
relative; at the first step, where both start from the same weights, every
gradient agrees within 1e-5 of its leaf's largest entry (float32, sums in
other orders). After the steps each parameter agrees within the
bound Adam puts on it (``assert_within_adam_bound``): Adam maps a gradient g
to lr * m / (sqrt(v) + eps), so where g is near 0 two gradients that differ
by f32 noise give updates up to lr apart, and a flat tolerance would test
that noise. Also: the two-pass gradients against one monolithic graph with
dropout on, remat, the two learning rates, the eval step, the refusals and
``cli.main --finetune`` end to end.

The packed step (``make_train_step_packed``, flat packing) is held the same
way against JAX's on rows of 128 (peptides) and 256 (receptors), where the
constant-token chunk rule matters, at 16 and 4 rows a chunk; its
single-graph ``make_packed_loss`` against JAX's and against the two passes
with dropout on; its loss against the one-bucket loss; the packed eval
step; and ``cli.main --finetune --packed``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from protein_clip_tpu.data.tokenizer import EsmTokenizer as JaxTokenizer
from protein_clip_tpu.models import clip as jclip
from protein_clip_tpu.models import esm2 as jesm2
from protein_clip_tpu.train import checkpoint as jckpt
from protein_clip_tpu.train import clip_engine as jengine
from protein_clip_tpu.train import finetune as jfinetune
from protein_clip_tpu_torch.cli import embed, main
from protein_clip_tpu_torch.data.tokenizer import EsmTokenizer
from protein_clip_tpu_torch.models import clip, esm2
from protein_clip_tpu_torch.train import checkpoint, clip_engine, finetune, packed_engine

RTOL = 1e-5
AAS = list("LAGVSERTIDPKQNFYMHWC")
TINY = ["--esm-config", "tiny", "--esm-dtype", "float32", "--device", "cpu"]
SMALL_RUN = ["--batch-size", "4", "--accumulated-batches", "2", "--num-chunks", "2",
             "--fixture-families", "60", "--epochs", "1"]
GLOBAL, CHUNKS = 8, 4


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def mcfgs(dropout=0.0):
    """(JAX, port) CLIP configs over the tiny backbone, 16-d heads."""
    return (jclip.CLIPConfig(input_dim=64, embedding_dim=16, h1=2, h2=2, dropout=dropout,
                             esm=jesm2.ESM2Config.tiny()),
            clip.CLIPConfig(input_dim=64, embedding_dim=16, h1=2, h2=2, dropout=dropout,
                            esm=esm2.ESM2Config.tiny()))


def engine_cfgs(jmcfg, mcfg, **kw):
    kw = dict(batch_size=GLOBAL, accumulated_batches=1, num_chunks=CHUNKS, length_groups=1, **kw)
    return jengine.EngineConfig(model=jmcfg, **kw), clip_engine.EngineConfig(model=mcfg, **kw)


def pair_batches(seed, n=GLOBAL):
    """The same random pairs tokenized by each package: (JAX, port)."""
    rng = np.random.default_rng(seed)
    peps = ["".join(rng.choice(AAS, int(k))) for k in rng.integers(5, 25, n)]
    recs = ["".join(rng.choice(AAS, int(k))) for k in rng.integers(20, 60, n)]
    return (jengine.tokenize_pair_batch(JaxTokenizer(), peps, recs),
            clip_engine.tokenize_pair_batch(EsmTokenizer(), peps, recs))


def jax_capture():
    """An optax transform that passes the gradients on and keeps them in its state."""
    return optax.GradientTransformation(lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
                                        lambda g, state, params=None: (g, {"g": g}))


class Capturing:
    """The port's optimizer state bound to ``params``, keeping (by flat
    checkpoint key) the gradients it applies."""

    def __init__(self, opt, params):
        self.state = opt.init(params)
        self.flat = checkpoint._flatten(params)
        self.grads = []

    def apply(self):
        self.grads.append({k: t.grad.detach().clone() for k, t in self.flat.items()})
        self.state.apply()


def assert_grads_close(port, jax_tree, rel=RTOL):
    """Every leaf within rel of its largest entry (JAX's)."""
    jflat = checkpoint._flatten(np_tree(jax_tree))
    assert port.keys() == jflat.keys()
    for k, want in jflat.items():
        err = float(np.abs(port[k].numpy() - want).max())
        assert err <= rel * float(np.abs(want).max()), (k, err)


def assert_within_adam_bound(params, jparams, grads, jgrads, lrs: dict, eps=1e-8):
    """Parameters after len(grads) Adam steps. With b1 = 0.9 and b2 = 0.999
    over t <= 3 steps, the bias-corrected moments are close to the mean and
    the root mean square of the gradients so far, so an update moves by at
    most 2 sum_s |dg_s| / (max_s |g_s| + eps) times lr when the gradients
    move by dg_s (g_s the larger of the two at step s); a parameter is held
    to the sum of that over the steps, plus 1e-6."""
    flat = checkpoint._flatten(params)
    jflat = checkpoint._flatten(np_tree(jparams))
    jg = [checkpoint._flatten(np_tree(g)) for g in jgrads]
    for k, p in flat.items():
        bound = np.full(p.shape, 1e-6)
        dg_sum = np.zeros(p.shape)
        g_max = np.zeros(p.shape)
        for g, jgs in zip(grads, jg):
            dg_sum += np.abs(g[k].numpy() - jgs[k])
            g_max = np.maximum(g_max, np.maximum(np.abs(g[k].numpy()), np.abs(jgs[k])))
            bound += lrs[k.split("/")[0]] * 2 * dg_sum / (g_max + eps)
        d = np.abs(p.detach().numpy() - jflat[k])
        assert (d <= bound).all(), (k, float(d.max()))


@pytest.fixture(scope="module")
def tiny():
    jmcfg, mcfg = mcfgs()
    jesm = jesm2.init_params(jax.random.key(1), jmcfg.esm)
    jheads = jclip.init_params(jax.random.key(2), jmcfg)
    return jmcfg, mcfg, jesm, jheads


def port_params(jesm, jheads):
    return finetune.init_params(checkpoint.from_numpy_tree(np_tree(jesm), "cpu"),
                                checkpoint.from_numpy_tree(np_tree(jheads), "cpu"))


LRS = dict(learning_rate=1e-3, backbone_lr=1e-4)


@pytest.fixture(scope="module")
def three_steps(tiny):
    """Three steps of each package's finetune step, with the two-group Adam."""
    jmcfg, mcfg, jesm, jheads = tiny
    jcfg, cfg = engine_cfgs(jmcfg, mcfg, **LRS)
    tx = optax.chain(jax_capture(), jfinetune.make_optimizer(jcfg))
    jstep = jfinetune.make_train_step(jcfg, tx)
    jp = jfinetune.init_params(jesm, jheads)
    jstate = tx.init(jp)
    params = port_params(jesm, jheads)
    state = Capturing(finetune.make_optimizer(cfg), params)
    step = finetune.make_train_step(cfg)
    losses, jlosses, jgrads = [], [], []
    for s in range(3):
        jb, b = pair_batches(10 + s)
        jp, jstate, jloss = jstep(jp, jstate, {}, jb, jax.random.key(s))
        params, state, loss = step(params, state, {}, b, None)
        losses.append(float(loss))
        jlosses.append(float(jloss))
        jgrads.append(jstate[0]["g"])
    return params, state.grads, losses, jp, jgrads, jlosses


def test_finetune_steps_match_jax(three_steps):
    params, grads, losses, jp, jgrads, jlosses = three_steps
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL)
    # the first step's gradients, from the same weights; later steps start
    # from weights that Adam has already set apart by its bound
    assert_grads_close(grads[0], jgrads[0])
    esm_moved = max(float(np.abs(g).max()) for g in jax.tree.leaves(np_tree(jgrads[0]["esm"])))
    assert esm_moved > 1e-6, "backbone gradients must be nonzero"
    assert all(t.dtype == torch.float32 for t in checkpoint._flatten(params["esm"]).values())
    assert_within_adam_bound(params, jp, grads, jgrads,
                             {"esm": LRS["backbone_lr"], "heads": LRS["learning_rate"]})


def test_two_pass_grads_equal_monolithic_with_dropout(tiny):
    """The gradcache invariant inside the port: with head dropout 0.5, the
    two-pass step's gradients equal one graph over every chunk's encode with
    the same per-chunk seeds, within 1e-5 of each leaf's largest (the same
    products, accumulated in another order). Pass 2 must redraw pass 1's
    masks for that to hold; a step with other seeds gives other gradients."""
    _, _, jesm, jheads = tiny
    _, mcfg = mcfgs(dropout=0.5)
    cfg = clip_engine.EngineConfig(model=mcfg, batch_size=GLOBAL, accumulated_batches=1,
                                   num_chunks=CHUNKS)
    batch = clip_engine.expand_batch(pair_batches(3)[1])

    def two_pass(seed):
        params = port_params(jesm, jheads)
        state = Capturing(optimizer_sgd0(), params)
        _, _, loss = finetune.make_train_step(cfg)(params, state, {}, batch,
                                                   torch.Generator().manual_seed(seed))
        return float(loss), state.grads[0]

    loss, grads = two_pass(7)
    params = port_params(jesm, jheads)
    flat = checkpoint._flatten(params)
    for t in flat.values():
        t.requires_grad_(True)
    seeds = finetune._chunk_seeds(torch.Generator().manual_seed(7), CHUNKS)

    def view(p):
        return finetune._cast_esm(p["esm"], mcfg.esm.compute_dtype)

    embs = [torch.cat([finetune._encoder(cfg, side, view)(params, c)
                       for c in finetune._chunked(batch, side, CHUNKS, s)])
            for side, s in (("pep", seeds[0]), ("rec", seeds[1]))]
    mono = clip_engine.default_loss_fn()(*embs)
    mono.backward()
    np.testing.assert_allclose(loss, float(mono.detach()), rtol=RTOL)
    for k, t in flat.items():
        err = float((grads[k] - t.grad).abs().max())
        assert err <= RTOL * float(t.grad.abs().max()), (k, err)
    other = two_pass(8)[1]
    assert any(not torch.allclose(grads[k], other[k]) for k in grads)


def optimizer_sgd0():
    """Two groups at lr 0: the step applies nothing, so the captured
    gradients belong to the parameters as given."""
    from protein_clip_tpu_torch.train import optimizer

    return optimizer.multi_transform({"esm": optimizer.adam(0.0), "heads": optimizer.adam(0.0)})


def test_remat_gives_the_same_grads(tiny):
    """Per-layer checkpointing recomputes each layer in the backward; the
    gradients are those of the graph that keeps every activation, bit for
    bit (the same float32 operations in the same order on the CPU)."""
    _, mcfg, jesm, jheads = tiny
    jb, b = pair_batches(4)
    out = []
    for remat in (True, False):
        cfg = clip_engine.EngineConfig(model=mcfg, batch_size=GLOBAL, accumulated_batches=1,
                                       num_chunks=CHUNKS, remat=remat)
        params = port_params(jesm, jheads)
        state = Capturing(optimizer_sgd0(), params)
        finetune.make_train_step(cfg)(params, state, {}, b, None)
        out.append(state.grads[0])
    for k in out[0]:
        assert torch.equal(out[0][k], out[1][k]), k


def test_two_group_optimizer(tiny):
    """Heads at learning_rate, backbone at backbone_lr: with backbone_lr 0
    the backbone stays as it was while the heads move (the JAX package's
    test_finetune_two_group_optimizer); the backbone lr defaults to 1e-5."""
    _, mcfg, jesm, jheads = tiny
    cfg = clip_engine.EngineConfig(model=mcfg, batch_size=GLOBAL, accumulated_batches=1,
                                   num_chunks=2, backbone_lr=0.0)
    params = port_params(jesm, jheads)
    before = {k: t.clone() for k, t in checkpoint._flatten(params).items()}
    state = finetune.make_optimizer(cfg).init(params)
    _, _, loss = finetune.make_train_step(cfg)(params, state, {}, pair_batches(5)[1], None)
    assert np.isfinite(float(loss))
    after = checkpoint._flatten(params)
    for k, t in before.items():
        if k.startswith("esm/"):
            assert torch.equal(after[k], t), k
    assert max(float((after[k].detach() - t).abs().max()) for k, t in before.items()
               if k.startswith("heads/")) > 0
    default = finetune.make_optimizer(clip_engine.EngineConfig(model=mcfg))
    assert (default.groups["esm"].lr, default.groups["heads"].lr) == (1e-5, 1e-3)


def test_eval_step_matches_jax(tiny):
    jmcfg, mcfg, jesm, jheads = tiny
    jcfg, cfg = engine_cfgs(jmcfg, mcfg)
    jb, b = pair_batches(6, 12)
    want = jfinetune.make_eval_step(jcfg)(jfinetune.init_params(jesm, jheads), {}, jb)
    got = finetune.make_eval_step(cfg)(port_params(jesm, jheads), {}, b)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_grouped_and_packed_steps_are_refused(tiny):
    """Length groups are refused; the packed steps build (flat packing),
    and width tiers are refused."""
    _, mcfg, _, _ = tiny
    with pytest.raises(ValueError, match="length-grouped"):
        finetune.make_train_step(clip_engine.EngineConfig(model=mcfg, length_groups=2))
    for make in (finetune.make_train_step, finetune.make_train_step_packed):
        assert callable(make(clip_engine.EngineConfig(model=mcfg, packed=True)))
        with pytest.raises(NotImplementedError, match="width-tiered"):
            make(clip_engine.EngineConfig(model=mcfg, packed=True, packed_tiers=2))


def test_cli_main_finetune(tmp_path):
    """``cli.main --finetune`` writes the run contract; its best_model.npz
    holds {heads, esm} with the tree of the JAX ``finetune.init_params``,
    and ``cli.embed`` serves with the checkpoint's own backbone."""
    assert main.main(TINY + SMALL_RUN + ["--finetune", "--synthetic-fixture", "--data-dir",
                                         str(tmp_path / "data"), "--runs-dir",
                                         str(tmp_path / "runs")]) == 0
    (run,) = list((tmp_path / "runs").iterdir())
    assert sorted(p.name for p in run.iterdir()) == ["best_model.npz", "losses_per_epoch.txt",
                                                     "metrics.jsonl"]
    rows = (run / "losses_per_epoch.txt").read_text().splitlines()
    assert len(rows) == 2 and all(np.isfinite(float(v)) for v in rows[1].split(","))
    jmcfg = jclip.CLIPConfig(input_dim=64, esm=jesm2.ESM2Config.tiny())
    like = jfinetune.init_params(jesm2.init_params(jax.random.key(0), jmcfg.esm),
                                 jclip.init_params(jax.random.key(0), jmcfg))
    tree = jckpt.load_npz(run / "best_model.npz", like)
    assert jax.tree.structure(tree) == jax.tree.structure(like)
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree.leaves(tree))
    assert embed.main(TINY + ["--checkpoint", str(run / "best_model.npz"), "--fasta",
                              str(tmp_path / "data" / "receptor.fasta"), "--side", "rec",
                              "--out", str(tmp_path / "idx.npz")]) == 0
    with np.load(tmp_path / "idx.npz") as index:
        assert np.isfinite(index["embeddings"]).all()


def test_cli_refuses_finetune_with_lora(tmp_path):
    """Full and parameter-efficient finetuning exclude each other, as in
    the JAX package, before anything is loaded."""
    with pytest.raises(SystemExit, match="mutually exclusive"):
        main.main(TINY + ["--runs-dir", str(tmp_path / "runs"), "--finetune", "--lora-rank", "4"])
    assert not (tmp_path / "runs").exists()


def test_two_group_optimizer_clips_the_whole_tree(tiny):
    """With grad_clip, both groups see gradients scaled by the norm of the
    whole tree, as the JAX package's chain(clip_by_global_norm,
    multi_transform) gives them: three updates from the same gradients
    agree within 1e-6 (float32, the norm summed in another order)."""
    jmcfg, mcfg, jesm, jheads = tiny
    jcfg, cfg = engine_cfgs(jmcfg, mcfg, grad_clip=0.5, **LRS)
    tx = jfinetune.make_optimizer(jcfg)
    jp = jfinetune.init_params(jesm, jheads)
    jstate = tx.init(jp)
    params = port_params(jesm, jheads)
    state = finetune.make_optimizer(cfg).init(params)
    flat = checkpoint._flatten(params)
    rng = np.random.default_rng(0)
    for _ in range(3):
        grads = {k: rng.normal(size=t.shape).astype(np.float32) for k, t in flat.items()}
        jgrads = jax.tree_util.tree_unflatten(
            jax.tree.structure(jp), [jnp.asarray(grads[k]) for k in
                                     checkpoint._flatten(np_tree(jp))])
        updates, jstate = tx.update(jgrads, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for k, t in flat.items():
            t.grad = torch.from_numpy(grads[k])
        state.apply()
    jflat = checkpoint._flatten(np_tree(jp))
    for k, t in flat.items():
        np.testing.assert_allclose(t.detach().numpy(), jflat[k], atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# The packed step (cfg.packed, flat packing)
# ---------------------------------------------------------------------------

def packed_pairs(seed, n=GLOBAL):
    """Peptides of 5-24 residues and receptors of 130-249: rows of 128 and
    256, so the packed step's constant-token chunk rule gives the peptide
    rows twice the receptor rows' chunk height."""
    rng = np.random.default_rng(seed)
    return (["".join(rng.choice(AAS, int(k))) for k in rng.integers(5, 25, n)],
            ["".join(rng.choice(AAS, int(k))) for k in rng.integers(130, 250, n)])


def packed_wire(seed, n=GLOBAL):
    """The same pairs packed by each package: (JAX batch, port batch)."""
    from protein_clip_tpu.train import packed_engine as jpacked
    from protein_clip_tpu_torch.train import packed_engine

    peps, recs = packed_pairs(seed, n)
    return (jpacked.tokenize_packed(JaxTokenizer(), peps, recs),
            packed_engine.tokenize_packed(EsmTokenizer(), peps, recs))


def packed_cfgs(jmcfg, mcfg, **kw):
    kw = dict(batch_size=4, accumulated_batches=2, packed=True, **kw)
    return jengine.EngineConfig(model=jmcfg, **kw), clip_engine.EngineConfig(model=mcfg, **kw)


def run_packed_steps(jstep, step, jp, jstate, params, state, esm, jesm, seed0):
    """Three steps of each package's packed step from the same weights:
    (params, port gradients, losses, JAX params, JAX gradients, JAX losses)."""
    losses, jlosses, jgrads = [], [], []
    for s in range(3):
        jb, b = packed_wire(seed0 + s)
        assert b["pep_ids"].shape[1] == 128 and b["rec_ids"].shape[1] == 256
        jp, jstate, jloss = jstep(jp, jstate, jesm, jb, jax.random.key(s))
        params, state, loss = step(params, state, esm, b, None)
        losses.append(float(loss))
        jlosses.append(float(jloss))
        jgrads.append(jstate[0]["g"])
    return params, state.grads, losses, jp, jgrads, jlosses


@pytest.mark.parametrize("rows_per_chunk", [16, 4])
def test_packed_finetune_steps_match_jax(tiny, rows_per_chunk):
    """Three packed finetune steps against JAX's make_train_step_packed:
    with 16 rows a chunk each side is one chunk (the peptide rows at 32);
    with 4 the peptide rows take 2 chunks of 8 and the receptor rows 4 of 4.
    Losses within 1e-5 relative, the first step's gradients within 1e-5 of
    each leaf's largest, the parameters within Adam's bound."""
    jmcfg, mcfg, jesm, jheads = tiny
    jcfg, cfg = packed_cfgs(jmcfg, mcfg, **LRS)
    tx = optax.chain(jax_capture(), jfinetune.make_optimizer(jcfg))
    jstep = jfinetune.make_train_step_packed(jcfg, tx, rows_per_chunk=rows_per_chunk)
    step = (finetune.make_train_step(cfg) if rows_per_chunk == 16
            else finetune.make_train_step_packed(cfg, rows_per_chunk=rows_per_chunk))
    jp = jfinetune.init_params(jesm, jheads)
    params = port_params(jesm, jheads)
    params, grads, losses, jp, jgrads, jlosses = run_packed_steps(
        jstep, step, jp, tx.init(jp), params, Capturing(finetune.make_optimizer(cfg), params),
        {}, {}, 40)
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL)
    assert_grads_close(grads[0], jgrads[0])
    esm_moved = max(float(np.abs(g).max()) for g in jax.tree.leaves(np_tree(jgrads[0]["esm"])))
    assert esm_moved > 1e-6, "backbone gradients must be nonzero"
    assert_within_adam_bound(params, jp, grads, jgrads,
                             {"esm": LRS["backbone_lr"], "heads": LRS["learning_rate"]})


def test_packed_loss_matches_jax(tiny):
    """make_packed_loss, the single-graph form, against JAX's: within 1e-5
    relative, at 4 rows a chunk."""
    jmcfg, mcfg, jesm, jheads = tiny
    jcfg, cfg = packed_cfgs(jmcfg, mcfg)
    jb, b = packed_wire(50)
    want = jfinetune.make_packed_loss(jcfg, rows_per_chunk=4)(
        jfinetune.init_params(jesm, jheads), {}, jb, jax.random.key(0))
    got = finetune.make_packed_loss(cfg, rows_per_chunk=4)(port_params(jesm, jheads), {}, b,
                                                           None)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def assert_two_pass_equals_packed_loss(cfg, params_fn, view, esm, optimizer_zero):
    """The packed two-pass step's gradients (captured at lr 0) equal those
    of make_packed_loss's single graph with the same generator seed, within
    1e-5 of each leaf's largest, loss within 1e-5 relative; another seed
    gives other gradients (pass 2 must redraw pass 1's masks to agree)."""
    b = packed_wire(51)[1]

    def two_pass(seed):
        params = params_fn()
        state = Capturing(optimizer_zero(), params)
        _, _, loss = finetune.make_train_step_packed(cfg, rows_per_chunk=4, view=view)(
            params, state, esm, b, torch.Generator().manual_seed(seed))
        return float(loss), state.grads[0]

    loss, grads = two_pass(7)
    params = params_fn()
    flat = checkpoint._flatten(params)
    for t in flat.values():
        t.requires_grad_(True)
    mono = finetune.make_packed_loss(cfg, rows_per_chunk=4, view=view)(
        params, esm, b, torch.Generator().manual_seed(7))
    mono.backward()
    np.testing.assert_allclose(loss, float(mono.detach()), rtol=RTOL)
    for k, t in flat.items():
        err = float((grads[k] - t.grad).abs().max())
        assert err <= RTOL * float(t.grad.abs().max()), (k, err)
    other = two_pass(8)[1]
    assert any(not torch.allclose(grads[k], other[k]) for k in grads)


def test_packed_two_pass_grads_equal_packed_loss_with_dropout(tiny):
    """The gradcache invariant of the packed step, with head dropout 0.5
    (token FFN per chunk, pooled FFN in the tail)."""
    _, _, jesm, jheads = tiny
    _, mcfg = mcfgs(dropout=0.5)
    cfg = clip_engine.EngineConfig(model=mcfg, batch_size=4, accumulated_batches=2,
                                   packed=True)
    assert_two_pass_equals_packed_loss(cfg, lambda: port_params(jesm, jheads),
                                       finetune.esm_view(cfg), {}, optimizer_sgd0)


def test_packed_loss_matches_the_plain_finetune_loss(tiny):
    """Packing changes the layout, not the objective: the packed loss on
    the same pairs equals the one-bucket loss within 2e-4 relative (as the
    JAX package's test_packed_finetune_matches_plain_finetune holds it)."""
    _, mcfg, jesm, jheads = tiny
    peps, recs = packed_pairs(52)
    cfg = clip_engine.EngineConfig(model=mcfg, batch_size=4, accumulated_batches=2)
    params = port_params(jesm, jheads)
    packed = finetune.make_packed_loss(dataclasses.replace(cfg, packed=True), rows_per_chunk=4)(
        params, {}, packed_engine.tokenize_packed(EsmTokenizer(), peps, recs), None)
    plain = finetune.make_eval_step(cfg)(
        params, {}, clip_engine.tokenize_pair_batch(EsmTokenizer(), peps, recs))
    np.testing.assert_allclose(float(packed), float(plain), rtol=2e-4)


def test_packed_eval_step_matches_jax(tiny):
    """The eval step on a packed batch goes through clip_engine's packed
    dispatch, as JAX's does: a pool of 12, not the global batch."""
    jmcfg, mcfg, jesm, jheads = tiny
    jcfg, cfg = packed_cfgs(jmcfg, mcfg)
    jb, b = packed_wire(53, 12)
    want = jfinetune.make_eval_step(jcfg)(jfinetune.init_params(jesm, jheads), {}, jb)
    got = finetune.make_eval_step(cfg)(port_params(jesm, jheads), {}, b)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_cli_main_finetune_packed(tmp_path):
    """``cli.main --finetune --packed`` for one tiny epoch on the CPU: the
    run contract, finite losses, a {heads, esm} checkpoint."""
    assert main.main(TINY + SMALL_RUN + ["--finetune", "--packed", "--synthetic-fixture",
                                         "--data-dir", str(tmp_path / "data"), "--runs-dir",
                                         str(tmp_path / "runs")]) == 0
    (run,) = list((tmp_path / "runs").iterdir())
    assert sorted(p.name for p in run.iterdir()) == ["best_model.npz", "losses_per_epoch.txt",
                                                     "metrics.jsonl"]
    rows = (run / "losses_per_epoch.txt").read_text().splitlines()
    assert len(rows) == 2 and all(np.isfinite(float(v)) for v in rows[1].split(","))
    with np.load(run / "best_model.npz") as ckpt:
        assert any(k.startswith("esm") for k in ckpt) and any(k.startswith("heads")
                                                             for k in ckpt)
