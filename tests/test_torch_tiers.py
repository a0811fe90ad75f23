"""Width-tiered packing in the port (``train/packed_engine.tokenize_packed
(tiers > 1)`` and ``tier_widths``, the CLIP packed steps over
``{side}_packs``, packed FILIP over width tiers) against the JAX package,
on the CPU in float32 with tiny configs and dropout 0.

- The wire equal to JAX's to the bit over a sequence of batches from one
  corpus, both packages' sticky caches cleared first: the data-aware
  widths and their reuse, a later batch that spills to a wider tier, a
  width a batch leaves empty (a placeholder pack), the rows and operm
  lengths ratcheted up, a batch that outgrows the widest tier (the widths
  derived again), an odd explicit row length, explicit widths, and 2
  tiers against 4. The device-side maps (``local_owner`` among them) and
  ``packed_side_count`` alike.
- The tiered train step (three steps: the loss within 1e-5 relative, the
  first gradients within 1e-5 of each leaf's largest, the heads within
  Adam's bound) and eval step against JAX's; the tiered step against the
  port's flat step on the same pairs within 1e-5.
- Packed FILIP over width tiers against JAX's: the (n, n) scores within
  1e-6, the step's loss and gradients within 1e-5, with one side flat
  beside a tiered one and with both tiered; the eval step.
- ``cli.main --packed --pack-tiers 4`` and ``cli.main_2protein_filip
  --packed --pack-tiers 4``: an epoch, and a run resumed after one epoch
  equal to the unbroken two-epoch run to the bit.
"""

import json
import os
import warnings

import jax
import numpy as np
import optax
import pytest
import torch

from protein_clip_tpu.data.tokenizer import EsmTokenizer as JaxTokenizer
from protein_clip_tpu.models import clip as jclip
from protein_clip_tpu.models import esm2 as jesm2
from protein_clip_tpu.models import filip as jfilip
from protein_clip_tpu.ops import filip_pallas as jops
from protein_clip_tpu.ops import infonce as jinfonce
from protein_clip_tpu.train import clip_engine as jengine
from protein_clip_tpu.train import filip_packed as jfpacked
from protein_clip_tpu.train import optimizer as jopt
from protein_clip_tpu.train import packed_engine as jpacked
from protein_clip_tpu_torch.cli import main, main_2protein_filip
from protein_clip_tpu_torch.data import fasta, prefetch
from protein_clip_tpu_torch.data.tokenizer import EsmTokenizer
from protein_clip_tpu_torch.models import esm2, filip
from protein_clip_tpu_torch.train import (checkpoint, clip_engine, filip_engine, filip_packed,
                                          loop, optimizer, packed_engine)
from protein_clip_tpu_torch.viz import plots
from test_torch_finetune import (Capturing, assert_grads_close, assert_within_adam_bound,
                                 jax_capture, mcfgs, np_tree)

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))
RTOL = ATOL = 1e-5
SIM_ATOL = 1e-6
LR = 1e-3
AAS = list("LAGVSERTIDPKQNFYMHWC")
TINY = ["--esm-config", "tiny", "--esm-dtype", "float32", "--device", "cpu"]
HEAD_LRS = {"pep": LR, "rec": LR, "temperature": LR}


@pytest.fixture(autouse=True)
def cleared():
    """Both packages' sticky tier caches empty before and after each test."""
    jpacked.clear_tier_width_cache()
    packed_engine.clear_tier_width_cache()
    yield
    jpacked.clear_tier_width_cache()
    packed_engine.clear_tier_width_cache()


def _seqs(rng, lengths):
    return ["".join(rng.choice(AAS, int(k))) for k in lengths]


def _batch(seed, n_short, n_long, long_len=(500, 630), short=(55, 62), peps=(5, 25)):
    """Pairs of short peptides beside receptors: n_short short ones (two to
    a 128-wide row) and n_long long ones, shuffled."""
    rng = np.random.default_rng(seed)
    lens = list(rng.integers(*short, n_short)) + list(rng.integers(*long_len, n_long))
    rng.shuffle(lens)
    return _seqs(rng, rng.integers(*peps, len(lens))), _seqs(rng, lens)


def _wire(peps, recs, **kw):
    """The same pairs packed by each package: (JAX batch, port batch)."""
    return (jpacked.tokenize_packed(JaxTokenizer(), peps, recs, **kw),
            packed_engine.tokenize_packed(EsmTokenizer(), peps, recs, **kw))


def _assert_wire_equal(jb, b):
    """Keys, structure, dtypes and values equal; every tensor of the port's
    wire is the JAX one's to the bit."""
    assert sorted(b) == sorted(jb)
    for key, val in b.items():
        if key.endswith("_packs"):
            assert isinstance(val, tuple) and len(val) == len(jb[key])
            for p, jp in zip(val, jb[key]):
                assert p.keys() == jp.keys() == {"ids", "operm", "nmark"}
                for k in p:
                    assert p[k].dtype == {"ids": torch.int8, "operm": torch.int32,
                                          "nmark": torch.int8}[k]
                    np.testing.assert_array_equal(p[k].numpy(), np.asarray(jp[k]), err_msg=k)
        else:
            np.testing.assert_array_equal(val.numpy(), np.asarray(jb[key]), err_msg=key)


def _assert_caches_equal():
    assert packed_engine._STICKY_TIER_WIDTHS == jpacked._STICKY_TIER_WIDTHS
    assert packed_engine._STICKY_TIER_ROWS == jpacked._STICKY_TIER_ROWS
    assert packed_engine._STICKY_TIER_OPERM == jpacked._STICKY_TIER_OPERM


def _widths(batch, side):
    """The row widths of a side: its packs', or the flat rows' one."""
    packs = batch.get(f"{side}_packs") or ({"ids": batch[f"{side}_ids"]},)
    return [p["ids"].shape[1] for p in packs]


# ---------------------------------------------------------------------------
# The wire: equal to the bit
# ---------------------------------------------------------------------------

def test_tier_cost_model_matches_jax():
    rng = np.random.default_rng(0)
    assert packed_engine._TIER_COST_GAMMA == jpacked._TIER_COST_GAMMA
    for lens in ([100] * 48 + [1950] * 8, list(rng.integers(10, 2000, 60)),
                 list(rng.integers(10, 120, 30)), [2048], list(rng.integers(100, 500, 256))):
        for w in (128, 256, 640, 2048):
            fit = [L for L in lens if L <= w]
            assert packed_engine._ffd_rows(fit, w) == jpacked._ffd_rows(fit, w)
        for n in (1, 2, 3, 4, 8):
            for row_len in (2048, 640, 300):
                lens_r = [min(L, row_len) for L in lens]
                got = packed_engine._tier_widths_data(lens_r, row_len, n)
                assert got == jpacked._tier_widths_data(lens_r, row_len, n)
                assert len(got) <= n and got[-1] >= max(lens_r)


def test_tiered_wire_over_a_batch_sequence_matches_jax():
    """Five batches of one corpus through both packers at tiers=4: the first
    fixes the widths (peptides one width: the flat pair; receptors two),
    the second overflows the narrow tier (spill to the wider), the third
    leaves the wide tier empty (a placeholder pack, its operm 8 sentinels),
    the fourth is smaller (the wide pack's rows and operm ratcheted up to
    the high-water marks with all-<pad> rows and sentinels), the fifth
    outgrows the widest tier (the widths derived again)."""
    tok = EsmTokenizer()
    seen = {"spill": False, "placeholder": False, "ratchet": False}
    batches = [_batch(0, 30, 6), _batch(1, 90, 12), _batch(2, 20, 0), _batch(3, 5, 1),
               _batch(4, 60, 3, long_len=(1200, 1500))]
    widths = []
    for i, (peps, recs) in enumerate(batches):
        jb, b = _wire(peps, recs, tiers=4)
        _assert_wire_equal(jb, b)
        _assert_caches_equal()
        assert "pep_ids" in b and "rec_packs" in b
        widths.append(_widths(b, "rec"))
        nmarks = [p["nmark"].shape[0] for p in b["rec_packs"]]
        assert sum(nmarks) == packed_engine.packed_side_count(b, "rec") == len(recs)
        for p, n in zip(b["rec_packs"], nmarks):
            operm = p["operm"].numpy()
            assert len(operm) % 8 == 0 and (operm[n:] == len(recs)).all()
            assert len(set(operm[:n].tolist())) == n
        # every receptor rides exactly one pack, intact
        expanded = packed_engine.expand_packed_batch(b)
        found = np.zeros(len(recs), bool)
        for pk in expanded["rec_packs"]:
            ids, owner = pk["ids"].numpy(), pk["owner"].numpy()
            for j in np.unique(owner[owner < len(recs)]):
                assert not found[j]
                found[j] = True
                np.testing.assert_array_equal(ids[owner == j], tok.encode(recs[j]))
        assert found.all()
        narrow = [len(tok.encode(s)) <= widths[-1][0] for s in recs]
        seen["spill"] |= nmarks[0] < sum(narrow)
        seen["placeholder"] |= 0 in nmarks
        if i == 3:      # the wide pack of one sequence keeps batch 1's rows and operm
            wide = b["rec_packs"][-1]
            alone = packed_engine._row_multiple_for(widths[-1][-1])
            seen["ratchet"] = (wide["ids"].shape[0] > alone and wide["operm"].shape[0] > 8
                               and nmarks[-1] == 1)
    assert widths[0] == widths[1] == widths[2] == widths[3] != widths[4], widths
    assert len(widths[0]) == 2 and widths[4][-1] > widths[0][-1]
    assert all(seen.values()), seen


def test_expand_and_count_over_packs_match_jax():
    """The device-side maps of each pack (ids, segments, positions, the
    global owner with the side's count as its dump, ``local_owner`` with
    the pack's operm length as its), and an expanded batch fed again."""
    jb, b = _wire(*_batch(5, 30, 6), tiers=4)
    want, got = jpacked.expand_packed_batch(jb), packed_engine.expand_packed_batch(b)
    assert packed_engine.packed_side_count(b, "rec") == jpacked.packed_side_count(jb, "rec") == 36
    for p, jp in zip(got["rec_packs"], want["rec_packs"]):
        assert p.keys() == jp.keys()
        for k in p:
            np.testing.assert_array_equal(p[k].numpy(), np.asarray(jp[k]), err_msg=k)
    for k in ("pep_ids", "pep_seg", "pep_pos", "pep_owner"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert packed_engine.expand_packed_batch(got) is got
    assert packed_engine.packed_side_count(got, "rec") == 36


@pytest.mark.parametrize("kw", [{"rec_row_len": 300, "tiers": 4},
                                {"tier_widths": [128, 256]},
                                {"tier_widths": [128]},
                                {"tier_widths": [128, 4096], "rec_row_len": 640},
                                {"tiers": 2}, {"tiers": 4}],
                         ids=["odd_row_len", "widths", "widths_uncovered", "widths_past_cap",
                              "tiers2", "tiers4"])
def test_explicit_and_capped_wires_match_jax(kw):
    """An explicit odd row length (the 282-token chain rides the 300-wide
    width intact), explicit widths (a top width added when they do not
    cover the batch; widths past the row dropped), and 2 tiers against 4
    on a long-tailed batch (at most that many widths)."""
    rng = np.random.default_rng(7)
    recs = _seqs(rng, [280, 120, 60, 30] + list(rng.integers(20, 200, 8))
                 + list(rng.integers(900, 1900, 3)))
    peps = _seqs(rng, rng.integers(5, 15, len(recs)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # past rec_row_len: truncated, in both
        jb, b = _wire(peps, recs, **kw)
    _assert_wire_equal(jb, b)
    _assert_caches_equal()
    if "tiers" in kw and "rec_packs" in b:
        assert len(b["rec_packs"]) <= kw["tiers"]
    if kw.get("rec_row_len") == 300:     # the 282-token chain rides the 300-wide row intact
        assert _widths(b, "rec")[-1] == 300
        x = packed_engine.expand_packed_batch(b)
        packs = packed_engine.side_packs(x, "rec")
        assert any(torch.equal(pk["ids"][pk["owner"] == 0], torch.from_numpy(
            EsmTokenizer().encode(recs[0])).int()) for pk in packs)


def test_two_tiers_against_four():
    """On a mix of four length clusters, 2 tiers give 2 widths and 4 give
    more (at most 4), each wire JAX's to the bit."""
    rng = np.random.default_rng(8)
    recs = _seqs(rng, list(rng.integers(57, 64, 64)) + list(rng.integers(240, 256, 48))
                 + list(rng.integers(600, 640, 24)) + list(rng.integers(1900, 2000, 8)))
    peps = _seqs(rng, rng.integers(5, 25, len(recs)))
    out = {}
    for n in (2, 4):
        jpacked.clear_tier_width_cache()
        packed_engine.clear_tier_width_cache()
        jb, out[n] = _wire(peps, recs, tiers=n)
        _assert_wire_equal(jb, out[n])
    assert len(_widths(out[2], "rec")) == 2 < len(_widths(out[4], "rec")) <= 4


def test_tier_state_round_trip_and_prefetch(tmp_path):
    """``tier_state`` / ``restore_tier_state`` carry the sticky caches
    through a train-state snapshot (``torch.save``, read with
    ``weights_only``), and the tiered wire crosses ``data/prefetch.py``
    whole, placeholder packs' empty ``nmark`` included."""
    packed_engine.tokenize_packed(EsmTokenizer(), *_batch(0, 30, 6), tiers=4)
    b = packed_engine.tokenize_packed(EsmTokenizer(), *_batch(2, 20, 0), tiers=4)
    assert 0 in [p["nmark"].shape[0] for p in b["rec_packs"]]
    state = packed_engine.tier_state()
    before = (dict(packed_engine._STICKY_TIER_WIDTHS), dict(packed_engine._STICKY_TIER_ROWS),
              dict(packed_engine._STICKY_TIER_OPERM))
    torch.save({"tiers": state}, tmp_path / "tiers.pt")
    loaded = torch.load(tmp_path / "tiers.pt", weights_only=True)["tiers"]
    packed_engine.clear_tier_width_cache()
    packed_engine.restore_tier_state(loaded)
    assert (packed_engine._STICKY_TIER_WIDTHS, packed_engine._STICKY_TIER_ROWS,
            packed_engine._STICKY_TIER_OPERM) == before
    got = list(prefetch.prefetch_to_device([0], lambda _: b, "cpu"))[0]
    for p, want in zip(got["rec_packs"], b["rec_packs"]):
        assert all(torch.equal(p[k], want[k]) for k in want)


# ---------------------------------------------------------------------------
# The CLIP steps over packs
# ---------------------------------------------------------------------------

GLOBAL = 8


@pytest.fixture(scope="module")
def tiny():
    jmcfg, mcfg = mcfgs()
    jesm = jesm2.init_params(jax.random.key(1), jmcfg.esm)
    return (jmcfg, mcfg, jesm, checkpoint.from_numpy_tree(np_tree(jesm), "cpu", torch.float32),
            jclip.init_params(jax.random.key(2), jmcfg))


def _cfgs(jmcfg, mcfg, **kw):
    kw = dict(batch_size=4, accumulated_batches=2, packed=True, **kw)
    return jengine.EngineConfig(model=jmcfg, **kw), clip_engine.EngineConfig(model=mcfg, **kw)


def _carry(jtree):
    return checkpoint.from_numpy_tree(np_tree(jtree), "cpu", torch.float32)


def _tiered_pairs(seed, n=GLOBAL):
    rng = np.random.default_rng(seed)
    return (_seqs(rng, rng.integers(5, 25, n)),
            _seqs(rng, list(rng.integers(10, 100, n - 2)) + list(rng.integers(150, 250, 2))))


TIERED = {"tier_widths": [128, 256], "rec_row_len": 256}


@pytest.mark.parametrize("rows_per_chunk", [16, 1])
def test_tiered_train_steps_match_jax(tiny, rows_per_chunk):
    """Three steps over tiered batches (receptors in widths 128 and 256,
    peptides flat), through the packed step of each package; with one row a
    chunk the 128-wide pack takes two rows a chunk (constant tokens)."""
    jmcfg, mcfg, jesm, esm, jheads = tiny
    jcfg, cfg = _cfgs(jmcfg, mcfg, packed_tiers=4)
    tx = optax.chain(jax_capture(), jopt.adam(LR))
    jstep = jpacked.make_train_step_packed(jcfg, tx, rows_per_chunk=rows_per_chunk)
    step = packed_engine.make_train_step_packed(cfg, rows_per_chunk=rows_per_chunk)
    jp, jstate = jheads, tx.init(jheads)
    params = _carry(jheads)
    state = Capturing(optimizer.adam(LR), params)
    losses, jlosses, jgrads = [], [], []
    for s in range(3):
        jb, b = _wire(*_tiered_pairs(30 + s), **TIERED)
        assert "rec_packs" in b and len(b["rec_packs"]) == 2
        jp, jstate, jloss = jstep(jp, jstate, jesm, jb, jax.random.key(s))
        params, state, loss = step(params, state, esm, b, None)
        losses.append(float(loss))
        jlosses.append(float(jloss))
        jgrads.append(jstate[0]["g"])
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL)
    assert_grads_close(state.grads[0], jgrads[0])
    assert_within_adam_bound(params, jp, state.grads, jgrads, HEAD_LRS)


def test_tiered_eval_step_and_embed_match_jax(tiny):
    jmcfg, mcfg, jesm, esm, jheads = tiny
    jcfg, cfg = _cfgs(jmcfg, mcfg, packed_tiers=4)
    jb, b = _wire(*_tiered_pairs(40, 6), tiers=4, rec_row_len=256)
    want = jpacked.make_eval_step_packed(jcfg)(jheads, jesm, jb)
    got = clip_engine.make_eval_step(cfg)(_carry(jheads), esm, b)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    jpep, jrec = jpacked.embed_packed(jheads, jesm, jb, jmcfg)
    pep, rec = packed_engine.embed_packed(_carry(jheads), esm, b, mcfg)
    np.testing.assert_allclose(pep.numpy(), np.asarray(jpep), atol=ATOL)
    np.testing.assert_allclose(rec.numpy(), np.asarray(jrec), atol=ATOL)


def test_tiered_step_equals_flat_step(tiny):
    """Port against port on the same pairs: the tiered step's loss and
    gradients against the flat step's within 1e-5 (the loss relative, each
    gradient of its leaf's largest entry)."""
    _, mcfg, _, esm, jheads = tiny
    peps, recs = _tiered_pairs(50)
    out = []
    for kw in (TIERED, {"rec_row_len": 256}):
        cfg = clip_engine.EngineConfig(model=mcfg, batch_size=4, accumulated_batches=2,
                                       packed=True, packed_tiers=4 if "tier_widths" in kw else 1)
        params = _carry(jheads)
        state = Capturing(optimizer.adam(LR), params)
        b = packed_engine.tokenize_packed(EsmTokenizer(), peps, recs, **kw)
        assert ("rec_packs" in b) == ("tier_widths" in kw)
        _, _, loss = clip_engine.make_train_step(cfg)(params, state, esm, b, None)
        out.append((float(loss), state.grads[0]))
    (lt, gt), (lf, gf) = out
    np.testing.assert_allclose(lt, lf, rtol=RTOL)
    for k, g in gf.items():
        assert float((gt[k] - g).abs().max()) <= RTOL * float(g.abs().max()), k


# ---------------------------------------------------------------------------
# Packed FILIP over width tiers
# ---------------------------------------------------------------------------

D = 32
N = 8


@pytest.fixture(scope="module")
def ftiny():
    jesm_cfg = jesm2.ESM2Config.tiny()
    jmcfg = jfilip.FILIPConfig(input_dim=64, embedding_dim=D, dropout=0.0, esm=jesm_cfg)
    mcfg = filip.FILIPConfig(input_dim=64, embedding_dim=D, dropout=0.0,
                             esm=esm2.ESM2Config.tiny())
    jesm = jesm2.init_params(jax.random.key(1), jesm_cfg)
    return jmcfg, mcfg, jesm, _carry(jesm), jfilip.init_params(jax.random.key(2), jmcfg)


def _filip_pairs(seed, long_pep=None):
    """N short pairs (far from max-sim ties) with two long receptors, and a
    long peptide when ``long_pep`` is given (both sides tiered)."""
    rng = np.random.default_rng(seed)
    pep = list(rng.integers(5, 25, N - 1)) + [long_pep or 20]
    rec = list(rng.integers(20, 60, N - 2)) + [140, 300]
    return _seqs(rng, pep), _seqs(rng, rec)


FILIP_WIRES = {"pep_flat": ({}, {"tier_widths": [128, 384], "pep_row_len": 128}),
               "both_tiered": ({"long_pep": 200}, {"tier_widths": [128, 256, 384]})}


def _filip_wire(seed, case):
    pair_kw, wire_kw = FILIP_WIRES[case]
    jb, b = _wire(*_filip_pairs(seed, **pair_kw), **wire_kw)
    assert "rec_packs" in b and (("pep_packs" in b) == (case == "both_tiered"))
    return jb, b


@pytest.mark.parametrize("case", sorted(FILIP_WIRES))
def test_filip_sim_over_packs_matches_jax(ftiny, case):
    jmcfg, mcfg, jesm, esm, jheads = ftiny
    jb, b = _filip_wire(2, case)
    want = jax.jit(lambda p, batch: jfpacked.filip_sim_packed(
        p, jesm, jpacked.expand_packed_batch(batch), jmcfg, N,
        similarity_fn=jops.filip_similarity_fused))(jheads, jb)
    got = filip_packed.filip_sim_packed(_carry(jheads), esm, b, mcfg, N)
    for g, w in zip(got, want):
        assert g.shape == (N, N)
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=SIM_ATOL, rtol=0)


def _capturing(state, params):
    named = checkpoint._flatten(params)
    apply = state.apply

    def capture():
        state.grads = {k: torch.zeros_like(t) if t.grad is None else t.grad.detach().clone()
                       for k, t in named.items()}
        apply()

    state.apply = capture
    return state


@pytest.mark.parametrize("case", sorted(FILIP_WIRES))
def test_filip_step_over_packs_matches_jax(ftiny, case):
    """The tiered packed FILIP step's loss within 1e-5 relative and every
    gradient within 1e-5 of the step's largest entry of JAX's; the eval
    step's loss alike. (Seed 3's pairs hold a max-sim near-tie that flips
    between the packages by 5.7e-4 of the largest gradient on the flat wire
    too, as ROADMAP's lesson on long random chains says: seed 5 is used.)"""
    jmcfg, mcfg, jesm, esm, jheads = ftiny
    jb, b = _filip_wire(5, case)

    def jloss_fn(p, batch):
        sa, sb = jfpacked.filip_sim_packed(p, jesm, jpacked.expand_packed_batch(batch), jmcfg,
                                           N, similarity_fn=jops.filip_similarity_fused)
        return jinfonce.filip_loss(sa, sb, False)

    jloss, jgrads = jax.jit(jax.value_and_grad(jloss_fn))(jheads, jb)
    jg = checkpoint._flatten(np_tree(jgrads))
    kw = dict(batch_size=N, accumulated_batches=1, packed=True, packed_tiers=4)
    cfg = clip_engine.EngineConfig(model=mcfg, **kw)
    params = _carry(jheads)
    state = _capturing(optimizer.adam(LR).init(params), params)
    _, _, loss = filip_engine.make_train_step(cfg)(params, state, esm, b, None)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    scale = max(float(np.abs(v).max()) for v in jg.values())
    for k, g in state.grads.items():
        np.testing.assert_allclose(g.numpy(), jg[k], rtol=0, atol=ATOL * scale, err_msg=k)
    want = jfpacked.make_eval_step_packed_filip(
        jengine.EngineConfig(model=jmcfg, **kw), jops.filip_similarity_fused)(jheads, jesm, jb)
    got = filip_engine.make_eval_step(cfg)(_carry(jheads), esm, b)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_filip_over_packs_equals_flat(ftiny):
    """Port against port: the scores over width-tier packs equal the flat
    wire's within 1e-6 (the same tokens, scored in blocks)."""
    _, mcfg, _, esm, jheads = ftiny
    peps, recs = _filip_pairs(4, long_pep=200)
    params = _carry(jheads)
    tiered = filip_packed.filip_sim_packed(params, esm, packed_engine.tokenize_packed(
        EsmTokenizer(), peps, recs, tier_widths=[128, 256, 384]), mcfg, N)
    flat = filip_packed.filip_sim_packed(params, esm, packed_engine.tokenize_packed(
        EsmTokenizer(), peps, recs), mcfg, N)
    for t, f in zip(tiered, flat):
        np.testing.assert_allclose(t.detach().numpy(), f.detach().numpy(), atol=SIM_ATOL)


# ---------------------------------------------------------------------------
# The CLIs: an epoch, and resume to the bit
# ---------------------------------------------------------------------------

CLIP_RUN = ["--batch-size", "16", "--accumulated-batches", "4", "--num-chunks", "2",
            "--lr-schedule", "cosine", "--dropout", "0.1", "--packed", "--pack-tiers", "4"]
# one scatter tier: the flat peptide side scatters at its row width, 128 (with
# width tiers its rows cap at 2048, so 4 scatter tiers would score it in a
# 512-wide buffer, which only costs time here; the steps' tests cover both)
FILIP_RUN = ["--batch-size", "64", "--embedding-dim", "32", "--lr-schedule", "cosine",
             "--dropout", "0.1", "--packed", "--pack-tiers", "4", "--scatter-tiers", "1"]


def _tiered_corpus(data, prefixes, n=300):
    """n pairs whose receptors are 80% of 20-59 residues and 20% of
    200-249: the width program splits the runs' first batch of 64 pairs
    into 128- and 256-wide rows. It keeps one width on the synthetic
    fixture's 60-180 residues, and on most length mixes that are not
    bimodal."""
    rng = np.random.default_rng(11)
    lens = np.where(rng.random(n) < 0.8, rng.integers(20, 60, n), rng.integers(200, 250, n))
    peps = _seqs(rng, rng.integers(8, 30, n))
    recs = _seqs(rng, lens)
    data.mkdir(parents=True, exist_ok=True)
    for prefix, seqs in zip(prefixes, (peps, recs)):
        fasta.write_fasta(data / f"{prefix}.fasta", [(f"{prefix}_{i}", q) for i, q in
                                                      enumerate(seqs)])


@pytest.fixture
def deterministic(monkeypatch):
    """Deterministic CPU algorithms (the embedding backward), and no
    drawing (the matrices are still written)."""
    monkeypatch.setattr(plots, "_pyplot", lambda: None)
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def _run(cli, argv, data, runs, epochs, resume_dir=None):
    extra = ["--resume-dir", str(resume_dir)] if resume_dir else ["--runs-dir", str(runs)]
    assert cli.main(TINY + argv + ["--data-dir", str(data), "--epochs", str(epochs)]
                    + extra) == 0
    if resume_dir:
        return resume_dir
    (run,) = list(runs.iterdir())
    return run


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


class Killed(Exception):
    pass


@pytest.mark.parametrize("cli,argv", [(main, CLIP_RUN), (main_2protein_filip, FILIP_RUN)],
                         ids=["clip", "filip"])
def test_tiered_cli_runs_and_resumes_to_the_bit(tmp_path, monkeypatch, deterministic, cli, argv):
    """The run trains on tiered batches (the tokenizer is asked for 4 tiers
    and ships packs), then a run killed after epoch 1 and resumed with
    --resume-dir equals the unbroken two-epoch run to the bit: its CSV,
    metrics, best_model.npz and final snapshot, the packer's sticky caches
    among them."""
    data = tmp_path / "data"
    # FILIP's batch is its global batch: 430 pairs fill a validation batch of 64
    _tiered_corpus(data, *((("peptide", "receptor"), 300) if cli is main
                           else (("protein1", "protein2"), 430)))
    shipped = []
    tokenize = packed_engine.tokenize_packed

    def spying(*a, **kw):
        out = tokenize(*a, **kw)
        shipped.append((kw.get("tiers"), any(k.endswith("_packs") for k in out)))
        return out

    monkeypatch.setattr(clip_engine, "tokenize_packed", spying)
    full = _run(cli, argv, data, tmp_path / "full", 2)
    assert shipped and all(t == 4 for t, _ in shipped) and any(p for _, p in shipped)
    save = loop._save_state

    def save_then_kill(state_dir, epoch, state):
        save(state_dir, epoch, state)
        raise Killed(f"killed after epoch {epoch}")

    monkeypatch.setattr(loop, "_save_state", save_then_kill)
    with pytest.raises(Killed):
        _run(cli, argv, data, tmp_path / "split", 2)
    monkeypatch.setattr(loop, "_save_state", save)
    (split,) = list((tmp_path / "split").iterdir())
    _run(cli, argv, data, None, 2, resume_dir=split)

    assert (split / "losses_per_epoch.txt").read_text() == \
        (full / "losses_per_epoch.txt").read_text()
    rows = (full / "losses_per_epoch.txt").read_text().splitlines()[1:]
    assert len(rows) == 2 and all(np.isfinite(float(v)) for r in rows for v in r.split(",")[1:])
    metrics = [[json.loads(r) for r in (run / "metrics.jsonl").read_text().splitlines()]
               for run in (full, split)]
    assert [(m["epoch"], m["train_loss"], m["val_loss"]) for m in metrics[0]] == \
        [(m["epoch"], m["train_loss"], m["val_loss"]) for m in metrics[1]]
    a, b = (checkpoint.read_npz(run / "best_model.npz") for run in (full, split))
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    states = [checkpoint.load_train_state(run / "state" / "epoch_2.pt", "cpu")
              for run in (full, split)]
    assert states[0]["tiers"]["widths"] and _same(*states)
