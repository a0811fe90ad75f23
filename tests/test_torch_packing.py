"""The port's packed CLIP train step (``train/packed_engine.py``, flat
packing) against the JAX package's, on the CPU: float32, tiny configs,
dropout 0 for parity.

The same strings go through both packages' tokenizers and packers; the
wire (ids and owner permutations) and the device-side maps (segment ids,
positions, owners) must be equal to the bit. The packed backbone (segment
ids, positions, <mask> tokens planted in packed rows) and the packed
pooling agree within 2e-5 absolute at every position (float32 sums in
other orders); three packed train steps agree within 1e-5 relative on the
losses, their first gradients within 1e-5 of each leaf's largest, and the
head parameters within the bound Adam puts on them
(``test_torch_finetune.assert_within_adam_bound``). Also: each packed
sequence's hidden states against the sequence run alone, K1's plain version
on packed rows against the eager form at every position (gaps included),
the eval step, ``embed_packed``, ``fit`` over two epochs, and the
refusals. For the packed unfrozen steps (``train/finetune.py``): the split
``_finish_pool`` against JAX's, and the chunks their constant-token rule
takes against JAX's at rows of 256, 512 and 2048.
"""

import dataclasses
import warnings

import bench

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from protein_clip_tpu.data import dataset as jdataset
from protein_clip_tpu.data import packing as jpacking
from protein_clip_tpu.data.tokenizer import EsmTokenizer as JaxTokenizer
from protein_clip_tpu.models import esm2 as jesm2
from protein_clip_tpu.models import clip as jclip
from protein_clip_tpu.train import clip_engine as jengine
from protein_clip_tpu.train import finetune as jfinetune
from protein_clip_tpu.train import loop as jloop
from protein_clip_tpu.train import optimizer as jopt
from protein_clip_tpu.train import packed_engine as jpacked
from protein_clip_tpu_torch.data import dataset, packing
from protein_clip_tpu_torch.data.synthetic import write_fixture
from protein_clip_tpu_torch.data.tokenizer import EsmTokenizer
from protein_clip_tpu_torch.models import clip, esm2
from protein_clip_tpu_torch.ops import attention
from protein_clip_tpu_torch.tools import bench_train
from protein_clip_tpu_torch.train import checkpoint, clip_engine, finetune, loop, optimizer
from protein_clip_tpu_torch.train import packed_engine
from test_torch_finetune import (Capturing, assert_grads_close, assert_within_adam_bound,
                                 jax_capture, mcfgs, np_tree)

ATOL = 2e-5
RTOL = 1e-5
LR = 1e-3
AAS = list("LAGVSERTIDPKQNFYMHWC")
# head_dim 32 like t30_150M (ESM2Config.tiny has 16)
SMALL = dict(hidden_size=128, num_layers=2, num_heads=4, intermediate_size=256)
GLOBAL = 8


def _seqs(rng, n, lo, hi):
    return ["".join(rng.choice(AAS, int(k))) for k in rng.integers(lo, hi, n)]


def _pairs(seed, n=GLOBAL):
    rng = np.random.default_rng(seed)
    return _seqs(rng, n, 5, 25), _seqs(rng, n, 20, 150)


def _wire(peps, recs, **kw):
    """The same strings packed by each package: (JAX batch, port batch)."""
    return (jpacked.tokenize_packed(JaxTokenizer(), peps, recs, **kw),
            packed_engine.tokenize_packed(EsmTokenizer(), peps, recs, **kw))


def _encodings(rng, n, lo, hi, mask_frac=0.0):
    """Tokenized sequences (<cls> body <eos>), with <mask> planted in the body."""
    out = []
    for k in rng.integers(lo, hi, n):
        body = rng.integers(4, 24, int(k))
        body[rng.random(int(k)) < mask_frac] = 32
        out.append(np.concatenate(([0], body, [2])).astype(np.int32))
    return out


def _carry(jparams):
    return checkpoint.from_numpy_tree(np_tree(jparams), "cpu", torch.float32)


# ---------------------------------------------------------------------------
# The wire, host and device halves: equal to the bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("row_len,row_multiple", [(64, 1), (64, 4), (128, 16), (40, 3)])
def test_pack_sequences_matches_jax(row_len, row_multiple):
    encs = _encodings(np.random.default_rng(row_len + row_multiple), 23, 1, 37)
    want = jpacking.pack_sequences(encs, row_len, row_multiple)
    got = packing.pack_sequences(encs, row_len, row_multiple)
    for f in ("ids", "segment_ids", "positions", "owner_row", "owner_seg"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert got.n_sequences == want.n_sequences == 23
    assert got.max_segments == want.max_segments > 1
    with pytest.raises(ValueError, match="row_len"):
        packing.pack_sequences(encs, 20)


@pytest.mark.parametrize("lens,row_lens", [
    ((5, 25, 20, 150), {}),                              # 128- and 256-wide rows
    ((8, 30, 100, 500), {}),                             # bench.py's draws: 512-wide
    ((5, 25, 20, 150), {"rec_row_len": 100}),            # receptors past the row: truncated
    ((300, 900, 1000, 2100), {})])                       # past the 2048 cap: truncated
def test_tokenize_packed_matches_jax(lens, row_lens):
    rng = np.random.default_rng(sum(lens))
    peps, recs = _seqs(rng, 37, *lens[:2]), _seqs(rng, 37, *lens[2:])
    longest = max(len(s) for s in recs) + 2
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        jb, b = _wire(peps, recs, **row_lens)
    truncated = [w for w in caught if "truncated (eos kept)" in str(w.message)]
    cap = row_lens.get("rec_row_len", 2048)
    assert len(truncated) == (2 if longest > cap else 0)   # one warning from each package
    assert b.keys() == jb.keys() == {"pep_ids", "pep_operm", "rec_ids", "rec_operm"}
    for k in b:
        assert b[k].dtype == (torch.int8 if k.endswith("ids") else torch.int32), k
        np.testing.assert_array_equal(b[k].numpy(), np.asarray(jb[k]), err_msg=k)
    assert sorted(b["rec_operm"].tolist()) == list(range(37))
    if longest > cap:
        ids = b["rec_ids"].numpy()
        assert ids.shape[1] == min(cap, 2048) and (ids[:, -1] == 2).any()


def test_derive_segments_and_expand_match_jax():
    peps, recs = _pairs(5, 29)
    jb, b = _wire(peps, recs)
    for side in ("pep", "rec"):
        want = jpacked.derive_segments(jb[f"{side}_ids"])
        got = packed_engine.derive_segments(b[f"{side}_ids"])
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = jpacked.expand_packed_batch(jb)
    got = packed_engine.expand_packed_batch(b)
    for side in ("pep", "rec"):
        for k in ("ids", "seg", "pos", "owner", "operm"):
            np.testing.assert_array_equal(got[f"{side}_{k}"].numpy(),
                                          np.asarray(want[f"{side}_{k}"]), err_msg=(side, k))
        owner = got[f"{side}_owner"]
        assert (owner[got[f"{side}_seg"] == 0] == 29).all()       # gaps go to the dump
        assert sorted(set(owner.flatten().tolist())) == list(range(30))
    assert packed_engine.expand_packed_batch(got) is got


# ---------------------------------------------------------------------------
# The packed backbone and pooling
# ---------------------------------------------------------------------------

def _packed_rows(seed, mask_frac, row_len=64, row_multiple=2):
    encs = _encodings(np.random.default_rng(seed), 9, 3, 30, mask_frac)
    return encs, packing.pack_sequences(encs, row_len, row_multiple)


def _forward_packed(params, pk, cfg):
    t = [torch.from_numpy(a) for a in (pk.ids, pk.segment_ids, pk.positions)]
    return esm2.forward(params, t[0], (t[1] > 0).int(), cfg, segment_ids=t[1], positions=t[2])


def _jax_forward_packed(jparams, pk, jcfg):
    return np.asarray(jesm2.forward(
        jparams, jnp.asarray(pk.ids), jnp.asarray((pk.segment_ids > 0).astype(np.int32)),
        jcfg, segment_ids=jnp.asarray(pk.segment_ids), positions=jnp.asarray(pk.positions)))


@pytest.mark.parametrize("mask_frac", [0.0, 0.2])
def test_packed_forward_matches_jax(mask_frac):
    """Rows of several segments with gaps and all-<pad> rows; with 0.2 the
    planted <mask> tokens give each segment its own token-dropout ratio."""
    jcfg, cfg = jesm2.ESM2Config(**SMALL), esm2.ESM2Config(**SMALL)
    encs, pk = _packed_rows(3, mask_frac)
    assert pk.max_segments > 2 and (pk.segment_ids == 0).any()
    if mask_frac:
        ratios = {round(float((e == 32).mean()), 6) for e in encs}
        assert len(ratios) > 3          # the per-segment branch sees distinct ratios
    jparams = jesm2.init_params(jax.random.key(4), jcfg)
    want = _jax_forward_packed(jparams, pk, jcfg)
    got = _forward_packed(_carry(jparams), pk, cfg)
    assert got.shape == (*pk.ids.shape, 128)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)     # every position, gaps too


def test_packed_forward_through_k1_plain_version_matches_jax_everywhere(monkeypatch):
    """On packed rows the eager form masks query and key, so a gap query row
    softmaxes to the uniform average of v, as K1 gives it: the forward with
    attention through K1's plain version (attention_reference) equals JAX's
    eager forward at every position."""
    jcfg, cfg = jesm2.ESM2Config(**SMALL), esm2.ESM2Config(**SMALL)
    _, pk = _packed_rows(6, 0.1)
    jparams = jesm2.init_params(jax.random.key(5), jcfg)
    monkeypatch.setattr(esm2, "_attend", lambda q, k, v, mask_bias, segments, c:
                        attention.attention_reference(q, k, v, segments))
    got = _forward_packed(_carry(jparams), pk, cfg)
    np.testing.assert_allclose(got.numpy(), _jax_forward_packed(jparams, pk, jcfg), atol=ATOL)


@pytest.mark.parametrize("mask_frac", [0.0, 0.15])
def test_packed_hidden_matches_each_sequence_alone(mask_frac):
    """The port's counterpart of the JAX package's
    test_packed_hidden_matches_unpacked: every packed sequence's hidden
    states equal the same sequence run alone in a row of its own length."""
    cfg = esm2.ESM2Config(**SMALL)
    params = esm2.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    encs, pk = _packed_rows(7, mask_frac, row_multiple=1)
    packed = _forward_packed(params, pk, cfg)
    for i, e in enumerate(encs):
        solo = esm2.forward(params, torch.from_numpy(e[None]), torch.ones(1, len(e),
                                                                         dtype=torch.int32), cfg)
        at = torch.from_numpy(pk.segment_ids[pk.owner_row[i]] == pk.owner_seg[i])
        torch.testing.assert_close(packed[pk.owner_row[i]][at], solo[0], atol=ATOL, rtol=2e-4)


def test_rope_per_token_equals_shared_table_at_the_same_positions():
    cos, sin = esm2._rope_tables(16, 32, torch.float32, "cpu")
    x = torch.randn(2, 16, 3, 32, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(16).expand(2, 16)
    torch.testing.assert_close(esm2._apply_rope(x, cos[pos], sin[pos]),
                               esm2._apply_rope(x, cos, sin), atol=0, rtol=0)


def test_pool_packed_matches_jax():
    jmcfg, mcfg = mcfgs()
    peps, recs = _pairs(8, 11)
    jb, b = _wire(peps, recs)
    jx, x = jpacked.expand_packed_batch(jb), packed_engine.expand_packed_batch(b)
    jhead = jclip.init_params(jax.random.key(3), jmcfg)
    R, L = x["rec_ids"].shape
    hidden = np.random.default_rng(9).standard_normal((R, L, 64)).astype(np.float32)
    want = jpacked._pool_packed(jhead["rec"], jnp.asarray(hidden), jx["rec_seg"],
                                jx["rec_owner"], 11, jhead["temperature"], dropout_rate=0.0,
                                train=False, rng=None, activation="relu")
    head = _carry(jhead)
    got = packed_engine._pool_packed(head["rec"], torch.from_numpy(hidden), x["rec_owner"], 11,
                                     head["temperature"], activation="relu")
    assert got.shape == (11, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    sums, cnt = packed_engine._token_sums(head["rec"], torch.from_numpy(hidden),
                                          x["rec_owner"], 11, activation="relu")
    assert cnt.tolist() == [len(s) + 2 for s in recs]


def test_finish_pool_matches_jax_and_pool_packed_is_its_composition():
    """_finish_pool (masked mean, pooled FFN, scale) of token sums against
    JAX's, within 2e-5; _pool_packed equals _token_sums then _finish_pool
    to the bit (the frozen step's pooling, split for the unfrozen tail)."""
    jmcfg, mcfg = mcfgs()
    x = packed_engine.expand_packed_batch(_wire(*_pairs(8, 11))[1])
    jhead = jclip.init_params(jax.random.key(4), jmcfg)
    head = _carry(jhead)
    R, L = x["rec_ids"].shape
    hidden = torch.from_numpy(np.random.default_rng(10).standard_normal((R, L, 64)).astype(
        np.float32))
    sums, cnt = packed_engine._token_sums(head["rec"], hidden, x["rec_owner"], 11,
                                          activation="relu")
    got = packed_engine._finish_pool(head["rec"], sums, cnt, head["temperature"],
                                     activation="relu")
    want = jpacked._finish_pool(jhead["rec"], jnp.asarray(sums.numpy()),
                                jnp.asarray(cnt.numpy()), jhead["temperature"],
                                dropout_rate=0.0, train=False, rng=None, activation="relu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert torch.equal(got, packed_engine._pool_packed(head["rec"], hidden, x["rec_owner"], 11,
                                                       head["temperature"], activation="relu"))


@pytest.mark.parametrize("n,rec_lo,rec_hi,width", [
    (64, 130, 250, 256), (64, 300, 500, 512), (56, 1100, 2000, 2048)])
def test_unfrozen_chunks_match_jax(n, rec_lo, rec_hi, width):
    """The chunks the packed unfrozen step takes per side (the constant-token
    rule: rows_per_chunk x widest width / the side's width rows a chunk, the
    most equal chunks that divide the rows) equal JAX's prepare's, to the
    bit, at rows of 128 against 256, 512 and 2048; at 2048 the receptors'
    56 rows take 2 chunks of 28, and the peptides one chunk of all rows."""
    rng = np.random.default_rng(n + width)
    jb, b = _wire(_seqs(rng, n, 5, 25), _seqs(rng, n, rec_lo, rec_hi))
    jcfg, cfg = _cfgs(*mcfgs())
    jprepare = jfinetune._packed_machinery(jcfg, jengine.default_loss_fn(), 16)[3]
    prepare = finetune._packed_machinery(cfg, clip_engine.default_loss_fn(), 16,
                                         finetune.esm_view(cfg))[3]
    want, got = jprepare(jb, jax.random.key(0)), prepare(b, None)
    shapes = {}
    for side in ("pep", "rec"):
        chunks = got[side][0]
        for k in ("ids", "seg", "pos", "owner"):
            w = np.asarray(want[side][0][k])
            assert w.shape == (len(chunks), *chunks[0][k].shape), (side, k)
            np.testing.assert_array_equal(np.stack([c[k].numpy() for c in chunks]), w)
        shapes[side] = (len(chunks), *chunks[0]["ids"].shape)
    assert shapes["pep"][2] == 128 and shapes["rec"][2] == width
    assert shapes["pep"][0] == 1
    if width == 2048:
        assert shapes["rec"] == (2, 28, 2048)


def test_pool_packed_keeps_gap_tokens_out_of_every_sum():
    """A non-finite hidden state at a gap or pad token changes no pooled
    embedding: those tokens are the dump's, as in the TPU package."""
    _, mcfg = mcfgs()
    peps, recs = _pairs(8, 11)
    x = packed_engine.expand_packed_batch(_wire(peps, recs)[1])
    head = clip.init_params(mcfg, torch.Generator().manual_seed(3), device="cpu")
    R, L = x["rec_ids"].shape
    hidden = torch.from_numpy(np.random.default_rng(9).standard_normal((R, L, 64)).astype(
        np.float32))
    dump = x["rec_owner"] == 11
    assert dump.any()
    pooled = [packed_engine._pool_packed(head["rec"], h, x["rec_owner"], 11, head["temperature"],
                                         activation="relu")
              for h in (hidden, hidden.masked_fill(dump[..., None], float("nan")))]
    assert torch.isfinite(pooled[1]).all()
    assert torch.equal(pooled[0], pooled[1])


# ---------------------------------------------------------------------------
# The steps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    jmcfg, mcfg = mcfgs()
    jesm = jesm2.init_params(jax.random.key(1), jmcfg.esm)
    return jmcfg, mcfg, jesm, _carry(jesm), jclip.init_params(jax.random.key(2), jmcfg)


def _cfgs(jmcfg, mcfg, **kw):
    kw = dict(batch_size=4, accumulated_batches=2, packed=True, **kw)
    return jengine.EngineConfig(model=jmcfg, **kw), clip_engine.EngineConfig(model=mcfg, **kw)


HEAD_LRS = {"pep": LR, "rec": LR, "temperature": LR}


@pytest.mark.parametrize("rows_per_chunk", [16, 4])
def test_packed_train_steps_match_jax(tiny, rows_per_chunk):
    """Three steps of 8 pairs from the same heads, through make_train_step's
    packed dispatch; with 4 rows a chunk the 16-row packs take 4 chunks."""
    jmcfg, mcfg, jesm, esm, jheads = tiny
    jcfg, cfg = _cfgs(jmcfg, mcfg)
    tx = optax.chain(jax_capture(), jopt.adam(LR))
    jstep = jpacked.make_train_step_packed(jcfg, tx, rows_per_chunk=rows_per_chunk)
    step = (clip_engine.make_train_step(cfg) if rows_per_chunk == 16
            else packed_engine.make_train_step_packed(cfg, rows_per_chunk=rows_per_chunk))
    jp, jstate = jheads, tx.init(jheads)
    params = _carry(jheads)
    state = Capturing(optimizer.adam(LR), params)
    losses, jlosses, jgrads = [], [], []
    for s in range(3):
        jb, b = _wire(*_pairs(20 + s))
        jp, jstate, jloss = jstep(jp, jstate, jesm, jb, jax.random.key(s))
        params, state, loss = step(params, state, esm, b, None)
        losses.append(float(loss))
        jlosses.append(float(jloss))
        jgrads.append(jstate[0]["g"])
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL)
    assert_grads_close(state.grads[0], jgrads[0])
    assert_within_adam_bound(params, jp, state.grads, jgrads, HEAD_LRS)


def test_packed_eval_step_and_embed_match_jax(tiny):
    jmcfg, mcfg, jesm, esm, jheads = tiny
    jcfg, cfg = _cfgs(jmcfg, mcfg)
    params = _carry(jheads)
    jb, b = _wire(*_pairs(30, 12))                 # a pool of 12, not the global batch
    want = jpacked.make_eval_step_packed(jcfg)(jheads, jesm, jb)
    got = clip_engine.make_eval_step(cfg)(params, esm, b)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    jpep, jrec = jpacked.embed_packed(jheads, jesm, jb, jmcfg)
    pep, rec = packed_engine.embed_packed(params, esm, b, mcfg)
    assert pep.shape == rec.shape == (12, 16)
    np.testing.assert_allclose(pep.numpy(), np.asarray(jpep), atol=ATOL)
    np.testing.assert_allclose(rec.numpy(), np.asarray(jrec), atol=ATOL)


def test_packed_embeddings_equal_the_padded_path(tiny):
    """Within the port: embed_packed gives each pair the embedding that the
    padded batch gives it (clip.forward over one pad bucket)."""
    _, mcfg, _, esm, jheads = tiny
    peps, recs = _pairs(31, 10)
    params = _carry(jheads)
    pep, rec = packed_engine.embed_packed(params, esm, packed_engine.tokenize_packed(
        EsmTokenizer(), peps, recs), mcfg)
    padded = clip_engine.expand_batch(clip_engine.tokenize_pair_batch(EsmTokenizer(), peps, recs))
    want_pep, want_rec = clip.forward(params, esm, padded, mcfg)
    torch.testing.assert_close(pep, want_pep, atol=ATOL, rtol=0)
    torch.testing.assert_close(rec, want_rec, atol=ATOL, rtol=0)


def test_packed_step_dropout_follows_the_generator(tiny):
    """Head dropout in the packed step draws from the step's generator: the
    same seed gives the same loss, another seed another loss."""
    _, mcfg, _, esm, jheads = tiny
    cfg = clip_engine.EngineConfig(model=dataclasses.replace(mcfg, dropout=0.5), batch_size=4,
                                   accumulated_batches=2, packed=True)
    b = packed_engine.tokenize_packed(EsmTokenizer(), *_pairs(32))

    def loss(seed):
        params = _carry(jheads)
        step = clip_engine.make_train_step(cfg)
        return float(step(params, optimizer.adam(LR).init(params), esm, b,
                          torch.Generator().manual_seed(seed))[2])

    assert loss(0) == loss(0) != loss(1)


def test_packed_steps_refuse_other_batches_and_tiers(tiny):
    _, mcfg, _, esm, jheads = tiny
    cfg = clip_engine.EngineConfig(model=mcfg, batch_size=4, accumulated_batches=2, packed=True)
    params = _carry(jheads)
    step = clip_engine.make_train_step(cfg)
    wrong = packed_engine.tokenize_packed(EsmTokenizer(), *_pairs(33, 6))
    with pytest.raises(ValueError, match="6 pep sequences but the step expects 8"):
        step(params, optimizer.adam(LR).init(params), esm, wrong, None)
    padded = clip_engine.tokenize_pair_batch(EsmTokenizer(), *_pairs(33))
    with pytest.raises(ValueError, match="tokenize_packed"):
        step(params, optimizer.adam(LR).init(params), esm, padded, None)
    with pytest.raises(ValueError, match="tokenize_packed"):
        clip_engine.make_eval_step(cfg)(params, esm, padded)
    for kw in ({"tiers": 2}, {"tier_widths": [128]}, {"scatter_tiers": 4}):
        with pytest.raises(NotImplementedError, match="not ported"):
            packed_engine.tokenize_packed(EsmTokenizer(), *_pairs(34), **kw)
    for kw in ({"packed_tiers": 4}, {"scatter_tiers": 4}):
        tiered = dataclasses.replace(cfg, **kw)
        for make in (clip_engine.make_train_step, clip_engine.make_eval_step):
            with pytest.raises(NotImplementedError, match=r"not ported yet \(ROADMAP queue 1: "):
                make(tiered)


def test_packed_fit_matches_jax(tiny, tmp_path):
    """Two epochs of packed training on one synthetic fixture through both
    packages' fit: per-epoch train and validation losses, the test loss and
    the best heads agree."""
    jmcfg, mcfg, jesm, esm, jheads = tiny
    write_fixture(tmp_path / "data", n_families=60, seed=4)

    def loaders(ds_mod):
        tr, va, te = ds_mod.generate_datasets(tmp_path / "data", seed=4)
        return (ds_mod.PairLoader(tr, 4, shuffle=True, seed=4),
                ds_mod.PairLoader(va, 4, shuffle=False, seed=4),
                ds_mod.PairLoader(te, 4, shuffle=False, seed=4))

    jcfg, cfg = _cfgs(jmcfg, mcfg)
    jtr, jva, jte = loaders(jdataset)
    jres = jloop.fit(tmp_path / "jax", jcfg, jheads, jesm, jtr, jva, JaxTokenizer(), 2,
                     rng=jax.random.key(0), test_loader=jte, log=lambda s: None)
    tr, va, te = loaders(dataset)
    res = loop.fit(tmp_path / "port", cfg, _carry(jheads), esm, tr, va, EsmTokenizer(), 2,
                   seed=0, device="cpu", test_loader=te, log=lambda s: None)
    np.testing.assert_allclose(res.train_losses, jres.train_losses, rtol=RTOL)
    np.testing.assert_allclose(res.val_losses, jres.val_losses, rtol=RTOL)
    np.testing.assert_allclose(res.test_loss, jres.test_loss, rtol=RTOL)
    flat, jflat = checkpoint._flatten(res.best_params), checkpoint._flatten(
        np_tree(jres.best_params))
    for k, v in jflat.items():
        np.testing.assert_allclose(flat[k].numpy(), v, atol=RTOL, err_msg=k)


@pytest.mark.parametrize("profile", ["standard", "longtail"])
def test_bench_batches_equal_bench_py(monkeypatch, profile):
    """tools/bench_train draws and packs bench.py's batches: the same wire,
    to the bit, from the same numpy seed."""
    monkeypatch.setenv("PCT_BENCH_PROFILE", profile)
    want = bench.make_batches(np.random.default_rng(42), 2, 256, JaxTokenizer(), "packed")
    got = bench_train.make_batches(np.random.default_rng(42), 2, profile)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]), err_msg=k)
    assert max(b["rec_ids"].shape[1] for b in got) == (2048 if profile == "longtail" else 512)
