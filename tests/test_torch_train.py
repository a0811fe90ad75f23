"""The port's frozen-backbone CLIP training against the JAX package's, on
the CPU (tiny ESM config, float32, dropout 0 for parity).

Parameters go across as numpy (``checkpoint.from_numpy_tree``), batches are
tokenized by each package from the same strings, and the same steps run on
both sides: losses agree within rtol 1e-5 per step and head parameters
within 1e-5 after the steps (float32, sums in other orders; three Adam
steps at lr 1e-3). Also: the eval steps, ``fit`` over two epochs (CSV,
metrics, best_model.npz), the CLIs end to end (``--packed`` too), train-mode
dropout, and the options the port refuses.
"""

import json
import os
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from protein_clip_tpu.data import dataset as jdataset
from protein_clip_tpu.data.tokenizer import EsmTokenizer as JaxTokenizer
from protein_clip_tpu.models import clip as jclip
from protein_clip_tpu.models import esm2 as jesm2
from protein_clip_tpu.ops import infonce_pallas as jpallas
from protein_clip_tpu.train import checkpoint as jckpt
from protein_clip_tpu.train import clip_engine as jengine
from protein_clip_tpu.train import loop as jloop
from protein_clip_tpu.train import optimizer as jopt
from protein_clip_tpu.train.gradcache import encode_hidden_chunked as jax_chunked
from protein_clip_tpu_torch.cli import embed, main, main_2protein, serve
from protein_clip_tpu_torch.data import dataset
from protein_clip_tpu_torch.data.tokenizer import EsmTokenizer
from protein_clip_tpu_torch.models import clip, esm2, heads
from protein_clip_tpu_torch.train import checkpoint, clip_engine, loop, optimizer
from protein_clip_tpu_torch.train.gradcache import encode_hidden_chunked

REPO = Path(__file__).resolve().parent.parent
RTOL = ATOL = 1e-5
AAS = list("LAGVSERTIDPKQNFYMHWC")

# Under pytest-xdist each worker collects every test file, so this runs in
# every worker: the workers share the host's cores, and torch's CPU threads
# (one per core by default in each worker) would oversubscribe them several
# times over. Each worker takes its share of the cores instead.
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))
TINY = ["--esm-config", "tiny", "--esm-dtype", "float32", "--device", "cpu"]
SMALL_RUN = ["--batch-size", "4", "--accumulated-batches", "2", "--num-chunks", "2",
             "--fixture-families", "60"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    """(JAX mcfg, port mcfg, JAX esm, port esm, JAX heads): tiny backbone,
    16-d heads, dropout 0."""
    jesm_cfg = jesm2.ESM2Config.tiny()
    jmcfg = jclip.CLIPConfig(input_dim=64, embedding_dim=16, dropout=0.0, esm=jesm_cfg)
    mcfg = clip.CLIPConfig(input_dim=64, embedding_dim=16, dropout=0.0,
                           esm=esm2.ESM2Config.tiny())
    jesm = jesm2.init_params(jax.random.key(1), jesm_cfg)
    return (jmcfg, mcfg, jesm, checkpoint.from_numpy_tree(_np(jesm), "cpu"),
            jclip.init_params(jax.random.key(2), jmcfg))


def _pairs(seed, n):
    rng = np.random.default_rng(seed)
    return (["".join(rng.choice(AAS, int(k))) for k in rng.integers(5, 25, n)],
            ["".join(rng.choice(AAS, int(k))) for k in rng.integers(20, 60, n)])


def _batch(side_pkg, peps, recs, groups):
    """The same strings tokenized by one package: 'jax' or 'port'."""
    if side_pkg == "jax":
        tok = JaxTokenizer()
        return (jengine.tokenize_grouped(tok, peps, recs, groups) if groups > 1
                else jengine.tokenize_pair_batch(tok, peps, recs))
    tok = EsmTokenizer()
    return (clip_engine.tokenize_grouped(tok, peps, recs, groups) if groups > 1
            else clip_engine.tokenize_pair_batch(tok, peps, recs))


def _assert_tree_close(port_tree, jax_tree, atol=ATOL):
    flat_p = checkpoint._flatten(port_tree)
    flat_j = checkpoint._flatten(_np(jax_tree))
    assert flat_p.keys() == flat_j.keys()
    for k in flat_p:
        np.testing.assert_allclose(flat_p[k].detach().numpy(), flat_j[k], atol=atol, err_msg=k)


def test_chunked_encode_matches_jax(tiny):
    jmcfg, mcfg, jesm, esm, _ = tiny
    b = _batch("port", *_pairs(0, 8), 1)
    jb = _batch("jax", *_pairs(0, 8), 1)
    ids = b["rec_ids"].int()
    mask = (ids != 1).int()
    got = encode_hidden_chunked(esm, ids, mask, mcfg.esm, 4)
    want = jax_chunked(jesm, jb["rec_ids"].astype(np.int32),
                       (np.asarray(jb["rec_ids"]) != 1).astype(np.int32), jmcfg.esm, 4, False)
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    with pytest.raises(ValueError, match="divisible"):
        encode_hidden_chunked(esm, ids, mask, mcfg.esm, 3)


@pytest.mark.parametrize("groups,jax_loss", [(1, "lax"), (2, "lax"), (4, "lax"),
                                             (2, "pallas")])
def test_train_steps_match_jax(tiny, groups, jax_loss):
    """Three global-batch steps (8 pairs, 2 chunks) from the same heads."""
    jmcfg, mcfg, jesm, esm, jheads = tiny
    jcfg = jengine.EngineConfig(model=jmcfg, batch_size=4, accumulated_batches=2,
                                num_chunks=2, length_groups=groups)
    cfg = clip_engine.EngineConfig(model=mcfg, batch_size=4, accumulated_batches=2,
                                   num_chunks=2, length_groups=groups)
    tx = jopt.adam(1e-3)
    jstep = jengine.make_train_step(
        jcfg, tx, (lambda a, b: jpallas.fused_infonce(a, b)) if jax_loss == "pallas" else None)
    step = clip_engine.make_train_step(cfg)
    jp, jstate = jheads, tx.init(jheads)
    params = checkpoint.from_numpy_tree(_np(jheads), "cpu")
    state = optimizer.adam(1e-3).init(params)
    for s in range(3):
        peps, recs = _pairs(10 + s, 8)
        jp, jstate, jloss = jstep(jp, jstate, jesm, _batch("jax", peps, recs, groups),
                                  jax.random.key(s))
        params, state, loss = step(params, state, esm, _batch("port", peps, recs, groups),
                                   None)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    _assert_tree_close(params, jp)


@pytest.mark.parametrize("groups", [1, 2])
def test_eval_steps_match_jax(tiny, groups):
    jmcfg, mcfg, jesm, esm, jheads = tiny
    jcfg = jengine.EngineConfig(model=jmcfg, length_groups=groups)
    cfg = clip_engine.EngineConfig(model=mcfg, length_groups=groups)
    params = checkpoint.from_numpy_tree(_np(jheads), "cpu")
    peps, recs = _pairs(3, 12)
    want = jengine.make_eval_step(jcfg)(jheads, jesm, _batch("jax", peps, recs, groups))
    got = clip_engine.make_eval_step(cfg)(params, esm, _batch("port", peps, recs, groups))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_grouped_steps_refuse_a_single_batch(tiny):
    _, mcfg, _, esm, _ = tiny
    cfg = clip_engine.EngineConfig(model=mcfg, length_groups=2)
    one = _batch("port", *_pairs(0, 4), 1)
    with pytest.raises(ValueError, match="tuple"):
        clip_engine.make_train_step(cfg)(None, None, esm, one, None)
    with pytest.raises(ValueError, match="tuple"):
        clip_engine.make_eval_step(cfg)(None, esm, one)


def _fixture_loaders(pkg, data_dir, seed):
    ds_mod = jdataset if pkg == "jax" else dataset
    tr, va, te = ds_mod.generate_datasets(data_dir, seed=seed)
    return (ds_mod.PairLoader(tr, 4, shuffle=True, seed=seed),
            ds_mod.PairLoader(va, 4, shuffle=False, seed=seed),
            ds_mod.PairLoader(te, 4, shuffle=False, seed=seed))


@pytest.mark.parametrize("use_gradcache", [True, False])
def test_fit_matches_jax(tiny, tmp_path, use_gradcache):
    """Two epochs on one synthetic fixture (40 families: 3 steps an epoch,
    one validation and one test batch): per-epoch losses, the test loss and
    best_model.npz agree; the CSV and metrics.jsonl follow the contract."""
    from protein_clip_tpu_torch.data.synthetic import write_fixture

    jmcfg, mcfg, jesm, esm, jheads = tiny
    write_fixture(tmp_path / "data", n_families=40, seed=4)
    kw = dict(batch_size=4, accumulated_batches=2, num_chunks=2,
              length_groups=2 if use_gradcache else 1)
    jres = jloop.fit(tmp_path / "jax", jengine.EngineConfig(model=jmcfg, **kw), jheads, jesm,
                     *_fixture_loaders("jax", tmp_path / "data", 4)[:2], JaxTokenizer(), 2,
                     rng=jax.random.key(0), use_gradcache=use_gradcache,
                     test_loader=_fixture_loaders("jax", tmp_path / "data", 4)[2],
                     log=lambda s: None)
    tr, va, te = _fixture_loaders("port", tmp_path / "data", 4)
    res = loop.fit(tmp_path / "port", clip_engine.EngineConfig(model=mcfg, **kw),
                   checkpoint.from_numpy_tree(_np(jheads), "cpu"), esm, tr, va,
                   EsmTokenizer(), 2, seed=0, device="cpu", use_gradcache=use_gradcache,
                   test_loader=te, log=lambda s: None)
    np.testing.assert_allclose(res.train_losses, jres.train_losses, rtol=RTOL)
    np.testing.assert_allclose(res.val_losses, jres.val_losses, rtol=RTOL)
    np.testing.assert_allclose(res.test_loss, jres.test_loss, rtol=RTOL)
    _assert_tree_close(res.best_params, jres.best_params)

    csv = (tmp_path / "port" / "losses_per_epoch.txt").read_text().splitlines()
    assert csv[0] == "Epoch,Train Loss,Validation Loss" and len(csv) == 3
    for row, tl, vl in zip(csv[1:], res.train_losses, res.val_losses):
        assert row.split(",")[1:] == [f"{tl:.4f}", f"{vl:.4f}"]
    metrics = [json.loads(x) for x in (tmp_path / "port" / "metrics.jsonl").read_text().split(
        "\n") if x]
    assert [m["epoch"] for m in metrics] == [1, 2]
    assert all(m.keys() == {"epoch", "train_loss", "val_loss", "seconds"} for m in metrics)
    saved = checkpoint.read_npz(tmp_path / "port" / "best_model.npz")
    jsaved = jckpt.load_npz(tmp_path / "jax" / "best_model.npz", jheads)
    for k, v in checkpoint._flatten(_np(jsaved)).items():
        np.testing.assert_allclose(saved[k], v, atol=ATOL, err_msg=k)


def test_best_params_are_a_copy_and_export_with_grad_leaves(tiny, tmp_path):
    _, mcfg, _, esm, jheads = tiny
    params = checkpoint.from_numpy_tree(_np(jheads), "cpu")
    optimizer.adam().init(params)              # leaves now require grad
    assert params["temperature"].requires_grad
    checkpoint.export_npz(tmp_path / "h.npz", params)
    back = checkpoint.load_npz(tmp_path / "h.npz", clip.abstract_params(mcfg), "cpu")
    _assert_tree_close(back, jheads, atol=0)
    snap = loop._snapshot(params)
    with torch.no_grad():
        params["temperature"].add_(1.0)
    assert float(snap["temperature"]) == float(jheads["temperature"])


def test_empty_eval_loader_gives_nan_and_a_short_epoch_raises(tiny):
    _, mcfg, _, esm, jheads = tiny
    cfg = clip_engine.EngineConfig(model=mcfg, batch_size=4, accumulated_batches=3,
                                   num_chunks=1)
    params = checkpoint.from_numpy_tree(_np(jheads), "cpu")
    tok = EsmTokenizer()
    assert np.isnan(clip_engine.evaluate(params, esm, [], tok,
                                         clip_engine.make_eval_step(cfg), "cpu", cfg))
    two = [_pairs(0, 4), _pairs(1, 4)]
    with pytest.raises(ValueError, match="fewer than accumulated_batches"):
        clip_engine.train_gc(params, optimizer.adam().init(params), esm, two, tok,
                             clip_engine.make_train_step(cfg), cfg, None, "cpu")


# ---------------------------------------------------------------------------
# Dropout (train mode): the generator's bits are not JAX's, so it is checked
# on its own: keep rate, 1/(1-p) scale, hidden blocks only.
# ---------------------------------------------------------------------------

def _ffn(depth, dim=32, seed=0):
    return heads.init_ffn(torch.Generator().manual_seed(seed), dim, depth, device="cpu")


def test_dropout_follows_the_hidden_blocks_formula():
    """One hidden block: LN(act(x W + b)), then where(keep, h / (1 - p), 0)
    with keep = rand < 1 - p from the generator, then the output linear."""
    p, ffn = 0.3, _ffn(2)
    x = torch.randn(64, 32, generator=torch.Generator().manual_seed(1))
    got = heads.apply_ffn(ffn, x, dropout_rate=p, train=True,
                          generator=torch.Generator().manual_seed(7))
    blk = ffn["blocks"]
    h = heads._layer_norm(torch.relu(x @ blk["w"][0] + blk["b"][0]), blk["ln_w"][0],
                          blk["ln_b"][0])
    keep = torch.rand(h.shape, generator=torch.Generator().manual_seed(7)) < 1 - p
    want = torch.where(keep, h / (1 - p), 0.0) @ ffn["out"]["w"] + ffn["out"]["b"]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_dropout_keep_rate_and_scale():
    p = 0.25
    h = torch.ones(200_000)
    ffn = {"blocks": {"w": torch.eye(1)[None] * 0, "b": torch.ones(1, 1),
                      "ln_w": torch.zeros(1, 1), "ln_b": torch.ones(1, 1)},
           "out": {"w": torch.eye(1), "b": torch.zeros(1)}}
    # LN of a width-1 row is 0, so every hidden value is ln_b = 1 before dropout
    out = heads.apply_ffn(ffn, h[:, None], dropout_rate=p, train=True,
                          generator=torch.Generator().manual_seed(0))[:, 0]
    kept = out != 0
    assert abs(float(kept.float().mean()) - (1 - p)) < 5 * (p * (1 - p) / h.numel()) ** 0.5
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], 1 / (1 - p)))


def test_dropout_touches_hidden_blocks_only():
    """No hidden block (depth 1): train mode is eval mode and needs no
    generator; p = 0 or eval mode leave the generator untouched."""
    x = torch.randn(16, 32, generator=torch.Generator().manual_seed(2))
    ffn1 = _ffn(1)
    torch.testing.assert_close(heads.apply_ffn(ffn1, x, dropout_rate=0.5, train=True),
                               heads.apply_ffn(ffn1, x))
    ffn2 = _ffn(2)
    g = torch.Generator().manual_seed(3)
    state = g.get_state()
    for kw in (dict(dropout_rate=0.5, train=False), dict(dropout_rate=0.0, train=True)):
        torch.testing.assert_close(heads.apply_ffn(ffn2, x, generator=g, **kw),
                                   heads.apply_ffn(ffn2, x))
    assert torch.equal(g.get_state(), state)
    with pytest.raises(ValueError, match="generator"):
        heads.apply_ffn(ffn2, x, dropout_rate=0.5, train=True)


def test_encode_side_train_mode_draws_dropout_in_both_ffns():
    mcfg = clip.CLIPConfig(input_dim=24, embedding_dim=8, dropout=0.5)
    params = clip.init_params(mcfg, torch.Generator().manual_seed(0), device="cpu")
    hidden = torch.randn(4, 6, 24, generator=torch.Generator().manual_seed(1))
    mask = torch.ones(4, 6, dtype=torch.int32)
    g = torch.Generator().manual_seed(5)
    a = clip.encode_side(params, "pep", hidden, mask, mcfg, train=True, generator=g)
    b = clip.encode_side(params, "pep", hidden, mask, mcfg, train=True, generator=g)
    ev = clip.encode_side(params, "pep", hidden, mask, mcfg)
    assert not torch.allclose(a, b) and not torch.allclose(a, ev)
    # one rand draw per hidden block: aa_ffn over (4, 6, 8), emb_ffn over (4, 8)
    g2 = torch.Generator().manual_seed(5)
    torch.rand(4, 6, 8, generator=g2)
    torch.rand(4, 8, generator=g2)
    torch.testing.assert_close(
        clip.encode_side(params, "pep", hidden, mask, mcfg, train=True, generator=g2), b)


# ---------------------------------------------------------------------------
# The CLIs, end to end on the CPU
# ---------------------------------------------------------------------------

def _run_dir(runs: Path) -> Path:
    (d,) = list(runs.iterdir())
    return d


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    assert main.main(TINY + SMALL_RUN + ["--synthetic-fixture", "--data-dir", str(d / "data"),
                                         "--runs-dir", str(d / "runs"), "--epochs", "2"]) == 0
    return d, _run_dir(d / "runs")


def test_cli_main_writes_the_run_contract(cli_run):
    _, run = cli_run
    assert sorted(p.name for p in run.iterdir()) == [
        "best_model.npz", "figures", "losses_per_epoch.txt", "metrics.jsonl", "state"]
    rows = run.joinpath("losses_per_epoch.txt").read_text().splitlines()
    assert rows[0] == "Epoch,Train Loss,Validation Loss" and len(rows) == 3
    assert all(np.isfinite(float(v)) for r in rows[1:] for v in r.split(","))


def test_cli_checkpoint_loads_in_jax(cli_run):
    _, run = cli_run
    jmcfg = jclip.CLIPConfig(input_dim=64, esm=jesm2.ESM2Config.tiny())
    like = jclip.init_params(jax.random.key(0), jmcfg)
    tree = jckpt.load_npz(run / "best_model.npz", like)
    assert jax.tree.structure(tree) == jax.tree.structure(like)
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree.leaves(tree))


def test_cli_checkpoint_serves(cli_run):
    d, run = cli_run
    ckpt_args = ["--checkpoint", str(run / "best_model.npz")]
    assert embed.main(TINY + ckpt_args + ["--fasta", str(d / "data" / "receptor.fasta"),
                                          "--side", "rec", "--out", str(d / "idx.npz")]) == 0
    server = serve.make_server(serve.build_argparser().parse_args(
        TINY + ckpt_args + ["--index", str(d / "idx.npz"), "--port", "0"]))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        req = urllib.request.Request(base + "/topk", data=json.dumps(
            {"queries": ["MKTAYIAK"], "side": "pep", "k": 3}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            hits = json.loads(r.read())["hits"]
        assert [h["rank"] for h in hits[0]] == [1, 2, 3]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def test_cli_main_2protein(tmp_path):
    assert main_2protein.main(TINY + SMALL_RUN + [
        "--synthetic-fixture", "--data-dir", str(tmp_path / "d2"), "--runs-dir",
        str(tmp_path / "runs"), "--epochs", "1", "--no-gradcache"]) == 0
    assert {p.name for p in (tmp_path / "d2").iterdir()} >= {"protein1.fasta", "protein2.fasta",
                                                             "protein2DB_clustered.tsv"}
    assert (_run_dir(tmp_path / "runs") / "best_model.npz").exists()


def test_cli_main_packed(tmp_path):
    """``cli.main --packed`` trains one epoch (the packed step and eval step)
    and writes the run contract."""
    assert main.main(TINY + SMALL_RUN + [
        "--synthetic-fixture", "--data-dir", str(tmp_path / "d"), "--runs-dir",
        str(tmp_path / "runs"), "--epochs", "1", "--packed"]) == 0
    run = _run_dir(tmp_path / "runs")
    assert {p.name for p in run.iterdir()} == {"best_model.npz", "figures",
                                               "losses_per_epoch.txt", "metrics.jsonl", "state"}
    (row,) = (run / "losses_per_epoch.txt").read_text().splitlines()[1:]
    assert all(np.isfinite(float(v)) for v in row.split(",")[1:])


def test_cli_main_2protein_packed(tmp_path):
    assert main_2protein.main(TINY + SMALL_RUN + [
        "--synthetic-fixture", "--data-dir", str(tmp_path / "d2"), "--runs-dir",
        str(tmp_path / "runs"), "--epochs", "1", "--packed"]) == 0
    assert (_run_dir(tmp_path / "runs") / "best_model.npz").exists()


@pytest.mark.parametrize("extra,match", [
    (["--packed", "--pack-tiers", "2", "--dp", "2"], "flat packing only"),
    (["--finetune", "--packed", "--pack-tiers", "2"], "flat packing only"),
    (["--dp", "2", "--no-gradcache"], "gradcache"),
    (["--packed", "--tp", "2"], "DP-only"), (["--pp", "2"], "multi-device"),
    (["--lora-rank", "4", "--packed", "--pack-tiers", "2"], "flat packing only")])
def test_cli_refuses_what_is_not_ported(tmp_path, extra, match):
    """Pipeline parallelism is not ported; a mesh (--dp) exits with
    --pack-tiers or --no-gradcache, --packed with --tp raises the TPU
    package's reason, and --finetune and --lora-rank exit with --packed
    --pack-tiers, as the TPU package's CLI does, before anything loads.
    Width tiers themselves run (tests/test_torch_tiers.py), --dp trains
    (tests/test_torch_dp.py) and --tp trains (tests/test_torch_tp.py)."""
    error = {"multi-device": NotImplementedError, "DP-only": ValueError}.get(match, SystemExit)
    with pytest.raises(error, match=match):
        main.main(TINY + ["--runs-dir", str(tmp_path / "runs")] + extra)
    assert not (tmp_path / "runs").exists()


def test_cli_dp_refuses_too_few_cards(tmp_path):
    """--dp 2 on CUDA wants two cards, one rank each: with fewer it raises,
    naming the count, before anything loads; it neither shares a card nor
    runs on the CPU."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("this host has two CUDA devices")
    with pytest.raises(RuntimeError, match=f"{torch.cuda.device_count()} visible"):
        main.main(["--esm-config", "tiny", "--device", "cuda", "--dp", "2", "--runs-dir",
                   str(tmp_path / "runs")])
    assert not (tmp_path / "runs").exists()


def test_cli_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main.main(["--esm-config", "tiny", "--runs-dir", str(tmp_path / "runs")])


def test_cli_needs_data_or_the_fixture(tmp_path):
    with pytest.raises(FileNotFoundError, match="synthetic-fixture"):
        main.main(TINY + ["--data-dir", str(tmp_path / "none"),
                          "--runs-dir", str(tmp_path / "runs")])


def test_engine_refuses_packed_and_resume(tiny, tmp_path):
    """The engine takes flat and width-tiered packing
    (tests/test_torch_packing.py, tests/test_torch_tiers.py) and refuses
    FILIP's scatter tiers, and ``fit`` refuses to resume from a snapshot of
    another tree layout (tests/test_torch_resume.py resumes)."""
    _, mcfg, _, esm, _ = tiny
    cfg = clip_engine.EngineConfig(model=mcfg, packed=True, packed_tiers=2)
    for make in (clip_engine.make_train_step, clip_engine.make_eval_step):
        assert callable(make(cfg))
        with pytest.raises(NotImplementedError, match="packing|pool per sequence"):
            make(clip_engine.EngineConfig(model=mcfg, packed=True, scatter_tiers=2))
    other = {"w": torch.zeros(3)}
    (tmp_path / "state").mkdir()
    checkpoint.save_train_state(tmp_path / "state" / "epoch_1.pt", {
        "params": other, "best_params": other, "opt_state": optimizer.adam().init(other)
        .state_dict(), "best_val": 1.0, "train_losses": [1.0], "val_losses": [1.0]})
    heads0 = clip.init_params(mcfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="another tree layout"):
        loop.fit(tmp_path, clip_engine.EngineConfig(model=mcfg), heads0, esm, [], [],
                 EsmTokenizer(), 1, seed=0, device="cpu", resume=True)


def test_training_modules_import_no_jax():
    """The new modules import with jax, the JAX package, optax, orbax and
    matplotlib blocked, and the module walk reaches them."""
    script = """
import importlib, importlib.abc, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "protein_clip_tpu", "optax", "orbax", "matplotlib", "transformers")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import: " + name)
sys.meta_path.insert(0, Block())
import protein_clip_tpu_torch
names = [m.name for m in pkgutil.walk_packages(protein_clip_tpu_torch.__path__,
                                               "protein_clip_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(" ".join(names))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    names = set(out.stdout.split())
    for mod in ("train.clip_engine", "train.loop", "train.optimizer", "train.gradcache",
                "data.dataset", "data.cluster", "data.synthetic", "data.prefetch",
                "data.native.build", "ops.infonce", "cli.main", "cli.main_2protein",
                "cli._clip_runner", "utils.rundir", "train.filip_engine",
                "cli.main_2protein_filip", "models.mlm", "cli.mlm_train",
                "parallel.distributed", "parallel.mesh", "parallel.step", "parallel.packed_step",
                "parallel.filip_step", "parallel.filip_finetune_step", "parallel.engine",
                "parallel.sharding", "parallel.mlm_step", "train.mlm_engine"):
        assert f"protein_clip_tpu_torch.{mod}" in names
