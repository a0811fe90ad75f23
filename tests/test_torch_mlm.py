"""The MLM objective in the port (``models/mlm.py``, ``esm2.init_lm_head`` /
``lm_logits``, ``packed_engine.tokenize_packed_rows``, ``cli/mlm_train.py``,
``eval/mlm_sweep.py``, ``cli/mlm_sweep.py``) against the JAX package's, on
the CPU in float32 with the tiny config.

- ``lm_logits`` over a forward with <mask> tokens (token dropout per row
  and, on packed rows, per segment) within 1e-5 of JAX's; ``init_lm_head``'s
  tree JAX's.
- ``mlm_loss`` on masks drawn by JAX's ``mask_tokens`` and fed to both,
  plain and packed, within 1e-5; the packed loss terms equal the unpacked
  ones (as the JAX package's test); on padded rows the loss through K1's
  plain version (a pad query gets the mean of v) equals the loss through
  the eager attention, since the loss reads only masked positions, none of
  them pads.
- ``tokenize_packed_rows``, ``mask_sequence``, ``changed_fraction`` and
  ``sweep`` equal JAX's to the bit for the same seed; ``mask_tokens``'s
  masks touch only eligible positions.
- One step of each mode (head, --finetune, --lora-rank; plain and
  --packed) against JAX's step as its CLI builds it, with the same masks:
  the loss within 1e-5 relative and every gradient within 1e-5 of its
  leaf's largest entry (the unfrozen steps are held by gradients: Adam's
  first update is lr g / (|g| + eps)); the head step's parameters within
  Adam's bound.
- ``cli.mlm_train`` in each mode and ``cli.mlm_sweep`` end to end; the
  port's best_model.npz read by JAX's ``checkpoint.load_npz``; the
  refusals.
"""

import os
import random
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from protein_clip_tpu.data import packing as jpacking
from protein_clip_tpu.data.tokenizer import EsmTokenizer as JaxTokenizer
from protein_clip_tpu.eval import mlm_sweep as jsweep
from protein_clip_tpu.models import esm2 as jesm2
from protein_clip_tpu.models import mlm as jmlm
from protein_clip_tpu.train import checkpoint as jckpt
from protein_clip_tpu.train import finetune as jfinetune
from protein_clip_tpu.train import lora as jlora
from protein_clip_tpu.train import optimizer as jopt
from protein_clip_tpu.train import packed_engine as jpacked
from protein_clip_tpu_torch.cli import mlm_sweep, mlm_train
from protein_clip_tpu_torch.data.fasta import sequences_only
from protein_clip_tpu_torch.data.tokenizer import EsmTokenizer
from protein_clip_tpu_torch.eval import mlm_sweep as sweep_mod
from protein_clip_tpu_torch.models import esm2, mlm
from protein_clip_tpu_torch.ops import attention
from protein_clip_tpu_torch.train import checkpoint, lora, optimizer, packed_engine

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))
ATOL = RTOL = 1e-5
LR = 1e-3
AAS = list("LAGVSERTIDPKQNFYMHWC")
TINY = ["--esm-config", "tiny", "--esm-dtype", "float32", "--device", "cpu"]
RANK = 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _carry(jtree):
    return checkpoint.from_numpy_tree(_np(jtree), "cpu", torch.float32)


def _seqs(rng, n, lo, hi):
    return ["".join(rng.choice(AAS, int(k))) for k in rng.integers(lo, hi, n)]


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, port config, JAX backbone, port backbone, JAX LM head
    with a random dense bias, LayerNorm and decoder bias, so every leaf
    takes part)."""
    jcfg, cfg = jesm2.ESM2Config.tiny(), esm2.ESM2Config.tiny()
    jparams = jesm2.init_params(jax.random.key(0), jcfg)
    head = jesm2.init_lm_head(jax.random.key(1), jcfg)
    r = np.random.default_rng(2)
    head = {"dense": {"w": head["dense"]["w"],
                      "b": jnp.asarray(0.1 * r.standard_normal(64), jnp.float32)},
            "ln": {"w": jnp.asarray(1 + 0.1 * r.standard_normal(64), jnp.float32),
                   "b": jnp.asarray(0.1 * r.standard_normal(64), jnp.float32)},
            "bias": jnp.asarray(0.1 * r.standard_normal(33), jnp.float32)}
    return jcfg, cfg, jparams, _carry(jparams), head


def _plain(seed, n=6, lo=6, hi=40):
    """The same sequences tokenized by each package into padded rows:
    (seqs, ids, attention mask) as numpy."""
    seqs = _seqs(np.random.default_rng(seed), n, lo, hi)
    enc = JaxTokenizer()(seqs)
    return seqs, np.asarray(enc["input_ids"]), np.asarray(enc["attention_mask"])


def _jax_masks(seed, ids, mask, p=0.3):
    masked, labels = jmlm.mask_tokens(jax.random.key(seed), jnp.asarray(ids), jnp.asarray(mask), p)
    return np.asarray(masked), np.asarray(labels)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# The head, token dropout, the loss
# ---------------------------------------------------------------------------

def test_init_lm_head_tree_matches_jax():
    jcfg, cfg = jesm2.ESM2Config.tiny(), esm2.ESM2Config.tiny()
    want = checkpoint._flatten(_np(jesm2.init_lm_head(jax.random.key(0), jcfg)))
    got = checkpoint._flatten(esm2.init_lm_head(cfg, torch.Generator().manual_seed(0),
                                                device="cpu"))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == torch.float32, k
    assert float(got["dense/w"].std()) == pytest.approx(0.02, rel=0.1)
    for k in ("dense/b", "ln/b", "bias"):
        assert not got[k].any()
    assert bool((got["ln/w"] == 1).all())


@pytest.mark.parametrize("packed", [False, True], ids=["padded", "packed"])
def test_lm_logits_with_mask_tokens_match_jax(tiny, packed):
    """The forward over ids with <mask> tokens (token dropout's rescale per
    row, or per segment on packed rows) then the LM head: the f32 logits
    within 1e-5 of JAX's at every position."""
    jcfg, cfg, jparams, params, jhead = tiny
    seqs, ids, mask = _plain(3)
    masked, _ = _jax_masks(4, ids, mask, 0.4)
    assert (masked == 32).sum(1).min() > 0
    kw, jkw = {}, {}
    if packed:
        encs = [m[a > 0] for m, a in zip(masked, mask)]
        pk = jpacking.pack_sequences(encs, 64, row_multiple=1)
        masked, mask = pk.ids, (pk.segment_ids > 0).astype(np.int32)
        kw = dict(segment_ids=_t(pk.segment_ids), positions=_t(pk.positions))
        jkw = dict(segment_ids=jnp.asarray(pk.segment_ids), positions=jnp.asarray(pk.positions))
    jh = jesm2.forward(jparams, jnp.asarray(masked), jnp.asarray(mask), jcfg, **jkw)
    want = np.asarray(jesm2.lm_logits(jparams, jhead, jh, jcfg))
    h = esm2.forward(params, _t(masked), _t(mask), cfg, **kw)
    got = esm2.lm_logits(params, _carry(jhead), h, cfg)
    assert got.dtype == torch.float32 and got.shape == (*masked.shape, 33)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("packed", [False, True], ids=["padded", "packed"])
def test_mlm_loss_on_jax_masks_matches_jax(tiny, packed):
    jcfg, cfg, jparams, params, jhead = tiny
    _, ids, mask = _plain(5)
    masked, labels = _jax_masks(6, ids, mask)
    kw, jkw = {}, {}
    if packed:
        encs_m = [m[a > 0] for m, a in zip(masked, mask)]
        encs_o = [o[a > 0] for o, a in zip(ids, mask)]
        pk_m = jpacking.pack_sequences(encs_m, 64, row_multiple=1)
        pk_o = jpacking.pack_sequences(encs_o, 64, row_multiple=1)
        masked, mask = pk_m.ids, (pk_m.segment_ids > 0).astype(np.int32)
        labels = np.where(pk_m.ids != pk_o.ids, pk_o.ids, -100)
        kw = dict(segment_ids=_t(pk_m.segment_ids), positions=_t(pk_m.positions))
        jkw = dict(segment_ids=jnp.asarray(pk_m.segment_ids),
                   positions=jnp.asarray(pk_m.positions))
    want = jmlm.mlm_loss_terms(jparams, jhead, jnp.asarray(masked), jnp.asarray(mask),
                               jnp.asarray(labels), jcfg, **jkw)
    got = mlm.mlm_loss_terms(params, _carry(jhead), _t(masked), _t(mask), _t(labels), cfg, **kw)
    assert float(got[1]) == float(want[1]) > 0
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=RTOL)
    np.testing.assert_allclose(float(mlm.mlm_loss(params, _carry(jhead), _t(masked), _t(mask),
                                                  _t(labels), cfg, **kw)),
                               float(want[0] / want[1]), rtol=RTOL)


def test_packed_loss_terms_equal_the_unpacked_ones(tiny):
    """The port's counterpart of the JAX package's
    test_packed_mlm_loss_matches_unpacked: (sum, count) from packed rows
    equal those of the padded batch, with per-sequence masking rates."""
    _, cfg, _, params, jhead = tiny
    head = _carry(jhead)
    rng = np.random.default_rng(7)
    tok = EsmTokenizer()
    encs = [tok.encode(s) for s in _seqs(rng, 6, 6, 28)]
    masked = []
    for e, p in zip(encs, [0.5, 0.1, 0.4, 0.0, 0.3, 0.2]):
        m = e.copy()
        body = np.arange(1, len(e) - 1)
        m[body[rng.random(len(body)) < p]] = 32
        masked.append(m)
    T = max(len(e) for e in encs)
    ids_u = np.ones((6, T), np.int32)
    msk_u = np.zeros((6, T), np.int32)
    lbl_u = np.full((6, T), -100, np.int32)
    for i, (o, m) in enumerate(zip(encs, masked)):
        ids_u[i, :len(m)], msk_u[i, :len(m)] = m, 1
        lbl_u[i, :len(m)] = np.where(m != o, o, -100)
    s_u, c_u = mlm.mlm_loss_terms(params, head, _t(ids_u), _t(msk_u), _t(lbl_u), cfg)
    pk_m = packed_engine.pack_sequences(masked, 64, row_multiple=1)
    pk_o = packed_engine.pack_sequences(encs, 64, row_multiple=1)
    s_p, c_p = mlm.mlm_loss_terms(
        params, head, _t(pk_m.ids), _t((pk_m.segment_ids > 0).astype(np.int32)),
        _t(np.where(pk_m.ids != pk_o.ids, pk_o.ids, -100)), cfg,
        segment_ids=_t(pk_m.segment_ids), positions=_t(pk_m.positions))
    assert float(c_p) == float(c_u) > 0
    np.testing.assert_allclose(float(s_p), float(s_u), rtol=RTOL)


def test_pad_query_rows_do_not_reach_the_loss(tiny, monkeypatch):
    """On padded rows K1 gives a pad query the mean of v (its plain
    version, attention_reference, does the same) where the eager form
    masks keys only: the hidden states differ at pads, and the loss, which
    reads masked positions only, none of them a pad, is the same within
    1e-6."""
    _, cfg, _, params, jhead = tiny
    _, ids, mask = _plain(8)
    masked, labels = _jax_masks(9, ids, mask)
    assert (mask == 0).any() and not ((labels != -100) & (mask == 0)).any()
    eager = mlm.mlm_loss(params, _carry(jhead), _t(masked), _t(mask), _t(labels), cfg)
    h_eager = esm2.forward(params, _t(masked), _t(mask), cfg)
    monkeypatch.setattr(esm2, "_attend", lambda q, k, v, mask_bias, segments, c:
                        attention.attention_reference(q, k, v, segments))
    k1_plain = mlm.mlm_loss(params, _carry(jhead), _t(masked), _t(mask), _t(labels), cfg)
    h_plain = esm2.forward(params, _t(masked), _t(mask), cfg)
    pads = _t(mask == 0)
    assert float((h_plain - h_eager)[pads].abs().max()) > 1e-3
    np.testing.assert_allclose(float(k1_plain), float(eager), rtol=1e-6)


def test_mask_tokens_touches_only_eligible_positions():
    _, ids, mask = _plain(10, n=16, lo=20, hi=60)
    ids_t, mask_t = _t(ids), _t(mask)
    masked, labels = mlm.mask_tokens(torch.Generator().manual_seed(0), ids_t, mask_t, 0.5)
    chosen = masked == 32
    special = (ids_t <= 2) | (mask_t == 0)
    assert not (chosen & special).any()
    assert torch.equal(labels != -100, chosen)
    assert torch.equal(labels[chosen], ids_t[chosen].int())
    assert torch.equal(masked[~chosen], ids_t[~chosen].int())
    rate = float(chosen.sum()) / float((~special).sum())
    assert abs(rate - 0.5) < 0.05
    again = mlm.mask_tokens(torch.Generator().manual_seed(0), ids_t, mask_t, 0.5)
    assert torch.equal(again[0], masked) and torch.equal(again[1], labels)


# ---------------------------------------------------------------------------
# The wire and the sweep: equal to the bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lens,row_len", [((5, 60), None), ((100, 500), None),
                                          ((5, 60), 40), ((1500, 2300), None)],
                         ids=["short", "bench", "explicit_truncated", "past_the_cap"])
def test_tokenize_packed_rows_matches_jax(lens, row_len):
    seqs = _seqs(np.random.default_rng(lens[0]), 20, *lens)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        want = np.asarray(jpacked.tokenize_packed_rows(JaxTokenizer(), seqs, row_len))
        got = packed_engine.tokenize_packed_rows(EsmTokenizer(), seqs, row_len)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    cut = [w for w in caught if "truncated (eos kept)" in str(w.message)]
    longest = max(len(s) for s in seqs) + 2
    assert len(cut) == (2 if longest > (row_len or 2048) else 0)   # one from each package
    ids, seg, pos = packed_engine.derive_segments(got)
    for a, b in zip((ids, seg, pos), jpacked.derive_segments(jnp.asarray(want))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_mask_sequence_and_changed_fraction_match_jax():
    seqs = _seqs(np.random.default_rng(11), 30, 5, 80)
    for p in (0.0, 0.15, 0.5, 1.0):
        a, b = random.Random(3), random.Random(3)
        got = [mlm.mask_sequence(s, p, ".", a) for s in seqs]
        assert got == [jmlm.mask_sequence(s, p, ".", b) for s in seqs]
        assert a.random() == b.random()
        tok = EsmTokenizer()
        for s, m in zip(seqs, got):
            x, y = tok.encode(s), tok.encode(m)
            assert mlm.changed_fraction(x, y, np.ones_like(x)) == \
                jmlm.changed_fraction(x, y, np.ones_like(x))
    assert mlm.changed_fraction([0, 5, 6, 2], [0, 29, 6, 2], [1, 1, 1, 0]) == 1 / 3


def test_sweep_matches_jax():
    seqs = _seqs(np.random.default_rng(12), 40, 8, 60)
    for kw in ({}, {"probs": (0.3, 0.05), "mask_char": "X", "seed": 7}):
        got, want = sweep_mod.sweep(seqs, **kw), jsweep.sweep(seqs, **kw)
        assert list(got) == list(want) and got == want


# ---------------------------------------------------------------------------
# One step of each mode against JAX's
# ---------------------------------------------------------------------------

MODES = [("head", False), ("head", True), ("finetune", False), ("finetune", True),
         ("lora", False), ("lora", True)]


def _wires(seed, packed):
    """(JAX arrays, port arrays) of one batch: padded (ids, mask) or the
    packed rows."""
    seqs = _seqs(np.random.default_rng(seed), 8, 10, 50)
    if packed:
        w = jpacked.tokenize_packed_rows(JaxTokenizer(), seqs)
        return (w,), (torch.from_numpy(np.array(w)),)
    enc = JaxTokenizer()(seqs)
    return ((jnp.asarray(enc["input_ids"]), jnp.asarray(enc["attention_mask"])),
            (torch.from_numpy(enc["input_ids"]), torch.from_numpy(enc["attention_mask"])))


def _jax_step(jcfg, mode, packed, jesm, jhead, arrs, masked, labels, lora_tree):
    """JAX's loss and gradients as cli/mlm_train.py's step forms them (its
    _masked_loss over the masked ids given), by mode."""
    if packed:
        ids, seg, pos = jpacked.derive_segments(arrs[0])
        mask = (seg > 0).astype(jnp.int32)
        extra = dict(segment_ids=seg, positions=pos)
    else:
        mask, extra = arrs[1], {}

    def loss(esm_p, head, remat):
        return jmlm.mlm_loss(esm_p, head, jnp.asarray(masked), mask, jnp.asarray(labels), jcfg,
                             remat=remat, **extra)

    if mode == "head":
        trainable = jhead
        fn = lambda t: loss(jesm, t, False)                                 # noqa: E731
    elif mode == "finetune":
        trainable = {"esm": jfinetune.init_params(jesm, {})["esm"], "head": jhead}
        fn = lambda t: loss(jfinetune._cast_esm(t["esm"], jcfg.compute_dtype), t["head"],   # noqa
                            True)
    else:
        trainable = {"lora": lora_tree, "head": jhead}
        fn = lambda t: loss(jlora.merge_lora(jesm, t["lora"], jlora.default_alpha(RANK)),  # noqa
                            t["head"], True)
    value, grads = jax.jit(jax.value_and_grad(fn))(trainable)
    return trainable, float(value), grads


@pytest.mark.parametrize("mode,packed", MODES, ids=[f"{m}-{'packed' if p else 'plain'}"
                                                    for m, p in MODES])
def test_step_matches_jax(tiny, mode, packed):
    jcfg, cfg, jparams, params, jhead = tiny
    jarrs, arrs = _wires(20, packed)
    inputs = mlm_train.batch_inputs(arrs, packed)
    masked, labels = _jax_masks(21, inputs["ids"].numpy(), inputs["mask"].numpy())
    lora_tree = None
    if mode == "lora":    # B moved off zero, so A takes a gradient
        lora_tree = jlora.init_lora(jax.random.key(3), jparams, RANK)
        r = np.random.default_rng(4)
        lora_tree = {k: {"a": v["a"], "b": jnp.asarray(0.05 * r.standard_normal(v["b"].shape),
                                                       jnp.float32)}
                     for k, v in lora_tree.items()}
    jtrain, jloss, jgrads = _jax_step(jcfg, mode, packed, jparams, jhead, jarrs, masked, labels,
                                      lora_tree)

    class Args:
        lora_ffn, seed, lora_rank = False, 0, RANK

    head = _carry(jhead)
    trainable, view, group = mlm_train.trainable_tree(Args, mode, head, params, cfg, "cpu")
    if mode == "lora":
        trainable["lora"] = _carry(lora_tree)
    esm_in = {} if mode == "finetune" else params
    opt = (optimizer.adam(LR) if mode == "head"
           else optimizer.multi_transform({group: optimizer.adam(LR), "head": optimizer.adam(LR)}))
    state = opt.init(trainable)
    flat = checkpoint._flatten(trainable)
    seen = {}
    apply = state.apply

    def capture():
        seen.update({k: t.grad.detach().clone() for k, t in flat.items()})
        apply()

    state.apply = capture
    step, eval_step = mlm_train.make_steps(cfg, mode, view)
    _, _, loss = step(trainable, state, esm_in, inputs, (_t(masked), _t(labels)))
    np.testing.assert_allclose(float(loss), jloss, rtol=RTOL)
    jflat = checkpoint._flatten(_np(jgrads))
    assert seen.keys() == jflat.keys()
    for k, want in jflat.items():
        err = float(np.abs(seen[k].numpy() - want).max())
        assert err <= RTOL * float(np.abs(want).max()), (k, err)
    if mode == "head":      # Adam's first step: parameters within its bound
        tx = jopt.adam(LR)
        upd, _ = tx.update(jgrads, tx.init(jtrain), jtrain)
        new = checkpoint._flatten(_np(optax.apply_updates(jtrain, upd)))
        for k, v in checkpoint._flatten(trainable).items():
            g = np.abs(jflat[k]) + 1e-8
            bound = 2 * LR * np.abs(seen[k].numpy() - jflat[k]) / g + 1e-6
            assert (np.abs(v.detach().numpy() - new[k]) <= bound).all(), k
    # the eval step is the loss without a graph
    trainable2, _, _ = mlm_train.trainable_tree(Args, mode, _carry(jhead), params, cfg, "cpu")
    if mode == "lora":
        trainable2["lora"] = _carry(lora_tree)
    got = eval_step(trainable2, esm_in, inputs, (_t(masked), _t(labels)))
    assert not got.requires_grad
    np.testing.assert_allclose(float(got), jloss, rtol=RTOL)


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

RUN = ["--batch-size", "4", "--fixture-families", "60", "--epochs", "2", "--synthetic-fixture"]
CLI_MODES = {"head": [], "head_packed": ["--packed", "--side", "both"],
             "finetune_packed": ["--packed", "--finetune"],
             "lora": ["--lora-rank", str(RANK), "--lora-ffn", "--side", "a"]}


def _like(mode, jcfg):
    head = jesm2.init_lm_head(jax.random.key(0), jcfg)
    jesm = jesm2.init_params(jax.random.key(0), jcfg)
    if mode.startswith("finetune"):
        return {"esm": jesm, "head": head}
    if mode == "lora":
        return {"lora": jlora.init_lora(jax.random.key(0), jesm, RANK,
                                        jlora.ATTN_TARGETS + jlora.FFN_TARGETS), "head": head}
    return head


@pytest.mark.parametrize("mode", sorted(CLI_MODES))
def test_cli_mlm_train_writes_the_run_jax_reads(tmp_path, mode):
    """Two epochs of each mode: the CSV's header and finite rows, and
    best_model.npz read by JAX's checkpoint reader into its tree, equal to
    the port's own read of it."""
    runs = tmp_path / "runs"
    assert mlm_train.main(TINY + RUN + ["--data-dir", str(tmp_path / "d"), "--runs-dir",
                                        str(runs)] + CLI_MODES[mode]) == 0
    (run,) = list(runs.iterdir())
    rows = (run / "losses_per_epoch.txt").read_text().splitlines()
    assert rows[0] == "Epoch,Train Loss,Validation Loss" and len(rows) == 3
    assert all(np.isfinite(float(v)) for r in rows[1:] for v in r.split(",")[1:])
    assert {p.name for p in run.iterdir()} == {"losses_per_epoch.txt", "best_model.npz"}
    jtree = jckpt.load_npz(run / "best_model.npz", _like(mode, jesm2.ESM2Config.tiny()))
    got = checkpoint.read_npz(run / "best_model.npz")
    want = checkpoint._flatten(_np(jtree))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == np.float32 and np.array_equal(got[k], v), k


def test_cli_mlm_sweep_matches_jax_sweep(tmp_path, capsys):
    """The sweep's printed means and its data (figure 1.npy beside the
    probabilities) equal JAX's ``sweep`` of the same sequences."""
    assert mlm_sweep.main(["--synthetic-fixture", "--data-dir", str(tmp_path / "d"),
                           "--runs-dir", str(tmp_path / "runs"), "--n-sequences", "30",
                           "--probs", "0.3", "0.1", "--seed", "5"]) == 0
    (run,) = list((tmp_path / "runs").iterdir())
    seqs = sequences_only(tmp_path / "d" / "peptide.fasta")[:30]
    want = jsweep.sweep(seqs, probs=(0.3, 0.1), seed=5)
    data = np.load(run / "figures" / "figure 1.npy")
    np.testing.assert_array_equal(np.load(run / "figures" / "figure 1.probs.npy"), [0.1, 0.3])
    np.testing.assert_array_equal(data, [want[0.1], want[0.3]])
    out = capsys.readouterr().out
    assert f"p=0.1: mean changed fraction {np.mean(want[0.1]):.3f}" in out
    assert f"p=0.3: mean changed fraction {np.mean(want[0.3]):.3f}" in out


@pytest.mark.parametrize("extra,error,match", [
    (["--finetune", "--lora-rank", "4"], SystemExit, "mutually exclusive"),
    (["--finetune", "--esm-dtype", "int8"], NotImplementedError, "int8"),
    (["--lora-rank", "4", "--esm-dtype", "int8"], NotImplementedError, "int8"),
    (["--dp", "3"], SystemExit, "divisible by --dp 3"),
    (["--tp", "3"], ValueError, "--tp.*num_heads, 4"),
    (["--resume-dir", "r"], SystemExit, "resume"),
    (["--packed", "--pack-tiers", "4"], SystemExit, "one width")])
def test_cli_mlm_train_refusals(tmp_path, extra, error, match):
    with pytest.raises(error, match=match):
        mlm_train.main(["--esm-config", "tiny", "--device", "cpu", "--runs-dir",
                        str(tmp_path / "runs")] + extra)
    assert not (tmp_path / "runs").exists()


def test_lora_tree_is_the_port_one():
    """``trainable_tree``'s LoRA adapters are ``lora.init_lora``'s from a
    generator seeded --seed + 1, on every attention and FFN target under
    --lora-ffn."""
    cfg = esm2.ESM2Config.tiny()
    params = esm2.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

    class Args:
        lora_ffn, seed, lora_rank = True, 3, RANK

    tree, _, group = mlm_train.trainable_tree(Args, "lora", {}, params, cfg, "cpu")
    want = lora.init_lora(torch.Generator().manual_seed(4), params, RANK,
                          lora.ATTN_TARGETS + lora.FFN_TARGETS)
    assert group == "lora" and tree["lora"].keys() == want.keys()
    assert all(torch.equal(tree["lora"][k]["a"], want[k]["a"]) for k in want)


@pytest.mark.parametrize("mode,jax_error", [("--finetune", TypeError), ("--lora-rank", KeyError)])
def test_int8_unfrozen_mlm_fails_in_jax_and_is_refused_here(tmp_path, mode, jax_error):
    """The JAX package's cli.mlm_train fails under --esm-dtype int8 in the
    unfrozen modes (a gradient of the int8 weights; LoRA's missing "w"
    leaves); the port raises NotImplementedError before it loads anything.
    The head alone trains over the int8 backbone in both (P1's plain
    version here)."""
    from protein_clip_tpu.cli import mlm_train as jmlm_train

    argv = ["--esm-config", "tiny", "--esm-dtype", "int8", "--synthetic-fixture",
            "--data-dir", str(tmp_path / "d"), "--fixture-families", "60", "--batch-size", "4",
            "--epochs", "1"]
    extra = [mode] + (["4"] if mode == "--lora-rank" else [])
    with pytest.raises(jax_error):
        jmlm_train.main(argv + extra + ["--runs-dir", str(tmp_path / "jax")])
    with pytest.raises(NotImplementedError, match="int8"):
        mlm_train.main(argv + extra + ["--device", "cpu", "--runs-dir", str(tmp_path / "port")])
    assert not (tmp_path / "port").exists()
    assert mlm_train.main(argv + ["--device", "cpu", "--runs-dir", str(tmp_path / "port")]) == 0
    (run,) = list((tmp_path / "port").iterdir())
    row = (run / "losses_per_epoch.txt").read_text().splitlines()[1]
    assert all(np.isfinite(float(v)) for v in row.split(",")[1:])
