"""Train-state snapshots and resume in the port (``train/loop.fit(resume=
True)``, ``--resume-dir``) on the CPU, tiny ESM config, float32.

- Against the JAX package: the same batches and seeded parameters through
  JAX's ``loop.fit`` and the port's, one epoch, then resumed to three, at
  dropout 0: the losses agree within 1e-5 per epoch and the best heads
  within the training tests' 1e-5.
- In every mode the CLIs train (frozen grouped, --no-gradcache, packed,
  finetune, LoRA, packed finetune, FILIP plain and packed), at dropout 0.1
  and with the cosine schedule: a run stopped after one epoch and resumed
  with --resume-dir equals the unbroken two-epoch run to the bit (its CSV
  row, metrics, best_model.npz and final train state).
- A resume with no snapshot starts fresh; one snapshot is kept; a snapshot
  whose write was cut leaves the one before it read; a snapshot of another
  mode raises.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from protein_clip_tpu.data.tokenizer import EsmTokenizer as JaxTokenizer
from protein_clip_tpu.models import clip as jclip
from protein_clip_tpu.models import esm2 as jesm2
from protein_clip_tpu.train import clip_engine as jengine
from protein_clip_tpu.train import loop as jloop
from protein_clip_tpu_torch.cli import main, main_2protein_filip
from protein_clip_tpu_torch.data.tokenizer import EsmTokenizer
from protein_clip_tpu_torch.models import clip, esm2
from protein_clip_tpu_torch.train import checkpoint, clip_engine, loop, optimizer
from protein_clip_tpu_torch.viz import plots

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))
TINY = ["--esm-config", "tiny", "--esm-dtype", "float32", "--device", "cpu"]
AAS = list("LAGVSERTIDPKQNFYMHWC")
CLIP_RUN = ["--batch-size", "4", "--accumulated-batches", "2", "--num-chunks", "2",
            "--fixture-families", "40", "--lr-schedule", "cosine", "--dropout", "0.1"]
FILIP_RUN = ["--batch-size", "4", "--fixture-families", "40", "--embedding-dim", "32",
             "--lr-schedule", "cosine", "--dropout", "0.1"]
# (name, CLI, its argv beside TINY)
MODES = (
    ("frozen_grouped", main, CLIP_RUN + ["--length-groups", "2"]),
    ("no_gradcache", main, CLIP_RUN + ["--no-gradcache"]),
    ("packed", main, CLIP_RUN + ["--packed"]),
    ("finetune", main, CLIP_RUN + ["--finetune"]),
    ("lora", main, CLIP_RUN + ["--lora-rank", "4"]),
    ("finetune_packed", main, CLIP_RUN + ["--finetune", "--packed"]),
    ("filip", main_2protein_filip, FILIP_RUN),
    ("filip_packed", main_2protein_filip, FILIP_RUN + ["--packed"]),
)


@pytest.fixture(autouse=True)
def no_drawing(monkeypatch):
    """The runs' figures are not drawn here (tests/test_torch_eval.py draws
    them): the similarity matrices are still written."""
    monkeypatch.setattr(plots, "_pyplot", lambda: None)


@pytest.fixture
def deterministic():
    """The CPU's embedding backward adds rows in a varying order across
    threads unless deterministic algorithms are asked for."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


class FakeLoader:
    """Fixed batches of random pairs, as tests/test_resume.py draws them."""

    def __init__(self, n_batches, bs, seed):
        r = np.random.default_rng(seed)
        self.batches = [(["".join(r.choice(AAS, 10)) for _ in range(bs)],
                         ["".join(r.choice(AAS, 20)) for _ in range(bs)])
                        for _ in range(n_batches)]

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


def _flat(tree):
    return {k: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
            for k, v in checkpoint._flatten(tree).items()}


def test_resume_matches_jax(tmp_path):
    """One epoch, then resumed to three, through JAX's fit and the port's,
    from the same parameters and batches at dropout 0."""
    jesm_cfg = jesm2.ESM2Config.tiny()
    jmcfg = jclip.CLIPConfig(input_dim=64, embedding_dim=16, dropout=0.0, esm=jesm_cfg)
    mcfg = clip.CLIPConfig(input_dim=64, embedding_dim=16, dropout=0.0,
                           esm=esm2.ESM2Config.tiny())
    jesm = jesm2.init_params(jax.random.key(1), jesm_cfg)
    jheads = jclip.init_params(jax.random.key(2), jmcfg)
    tr, va = FakeLoader(4, 4, 0), FakeLoader(2, 4, 1)
    jcfg = jengine.EngineConfig(model=jmcfg, batch_size=4, accumulated_batches=2, num_chunks=2)
    for epochs, resume in ((1, False), (3, True)):
        jres = jloop.fit(tmp_path / "jax", jcfg, jheads, jesm, tr, va, JaxTokenizer(), epochs,
                         rng=jax.random.key(0), log=lambda s: None, resume=resume)

    esm = checkpoint.from_numpy_tree(jax.tree.map(np.asarray, jesm), "cpu")
    cfg = clip_engine.EngineConfig(model=mcfg, batch_size=4, accumulated_batches=2,
                                   num_chunks=2)
    for epochs, resume in ((1, False), (3, True)):
        heads = checkpoint.from_numpy_tree(jax.tree.map(np.asarray, jheads), "cpu")
        res = loop.fit(tmp_path / "port", cfg, heads, esm, tr, va, EsmTokenizer(), epochs,
                       seed=0, device="cpu", log=lambda s: None, resume=resume)
    assert len(res.train_losses) == len(jres.train_losses) == 3
    np.testing.assert_allclose(res.train_losses, np.asarray(jres.train_losses, np.float64),
                               rtol=1e-5)
    np.testing.assert_allclose(res.val_losses, np.asarray(jres.val_losses, np.float64),
                               rtol=1e-5)
    want = _flat(jax.tree.map(np.asarray, jres.best_params))
    got = _flat(res.best_params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
    rows = (tmp_path / "port" / "losses_per_epoch.txt").read_text().splitlines()
    assert [r.split(",")[0] for r in rows] == ["Epoch", "1", "2", "3"]
    assert rows == (tmp_path / "jax" / "losses_per_epoch.txt").read_text().splitlines()
    assert [p.name for p in (tmp_path / "port" / "state").iterdir()] == ["epoch_3.pt"]


def _run(cli, argv, data, runs, epochs, resume_dir=None):
    extra = ["--resume-dir", str(resume_dir)] if resume_dir else ["--runs-dir", str(runs)]
    assert cli.main(TINY + argv + ["--synthetic-fixture", "--data-dir", str(data),
                                   "--epochs", str(epochs)] + extra) == 0
    if resume_dir:
        return resume_dir
    (run,) = list(runs.iterdir())
    return run


def _same_state(a, b) -> bool:
    """Two train-state snapshots hold the same tensors and numbers."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_state(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


class Killed(Exception):
    pass


def _killed_after_epoch_1(monkeypatch, cli, argv, data, runs):
    """A two-epoch run (the cosine schedule's horizon is the run's) killed
    once epoch 1's snapshot is written; its run directory."""
    save = loop._save_state

    def save_then_kill(state_dir, epoch, state):
        save(state_dir, epoch, state)
        raise Killed(f"killed after epoch {epoch}")

    monkeypatch.setattr(loop, "_save_state", save_then_kill)
    with pytest.raises(Killed):
        _run(cli, argv, data, runs, 2)
    monkeypatch.setattr(loop, "_save_state", save)
    (run,) = list(runs.iterdir())
    return run


@pytest.mark.parametrize("name,cli,argv", MODES, ids=[m[0] for m in MODES])
def test_resumed_run_equals_unbroken(tmp_path, monkeypatch, deterministic, name, cli, argv):
    data = tmp_path / "data"
    full = _run(cli, argv, data, tmp_path / "full", 2)
    split = _killed_after_epoch_1(monkeypatch, cli, argv, data, tmp_path / "split")
    assert [p.name for p in (split / "state").iterdir()] == ["epoch_1.pt"]
    _run(cli, argv, data, None, 2, resume_dir=split)

    assert (split / "losses_per_epoch.txt").read_text() == \
        (full / "losses_per_epoch.txt").read_text()
    metrics = [[json.loads(r) for r in (run / "metrics.jsonl").read_text().splitlines()]
               for run in (full, split)]
    assert [(m["epoch"], m["train_loss"], m["val_loss"]) for m in metrics[0]] == \
        [(m["epoch"], m["train_loss"], m["val_loss"]) for m in metrics[1]]
    assert len(metrics[0]) == 2
    a, b = (checkpoint.read_npz(run / "best_model.npz") for run in (full, split))
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    # one snapshot kept, equal to the bit
    snaps = [sorted(p.name for p in (run / "state").iterdir()) for run in (full, split)]
    assert snaps == [["epoch_2.pt"], ["epoch_2.pt"]]
    assert _same_state(*(checkpoint.load_train_state(run / "state" / "epoch_2.pt", "cpu")
                         for run in (full, split)))


def test_resume_without_state_starts_fresh(tmp_path):
    run = tmp_path / "new_run"
    _run(main, CLIP_RUN, tmp_path / "data", None, 1, resume_dir=run)
    rows = (run / "losses_per_epoch.txt").read_text().splitlines()
    assert rows[0] == "Epoch,Train Loss,Validation Loss" and len(rows) == 2
    assert [p.name for p in (run / "state").iterdir()] == ["epoch_1.pt"]


def test_cut_snapshot_leaves_the_one_before(tmp_path, monkeypatch, deterministic):
    """A run killed while it writes epoch 2's snapshot: the temporary file is
    cut short, epoch 1's snapshot stays, and the resumed run restores it and
    ends as the unbroken run does."""
    data = tmp_path / "data"
    full = _run(main, CLIP_RUN, data, tmp_path / "full", 2)
    save = torch.save

    def cut_save(obj, path):
        save(obj, path)
        if "epoch_2" in str(path):
            with open(path, "r+b") as f:
                f.truncate(os.path.getsize(path) // 2)
            raise Killed("killed mid-write")

    monkeypatch.setattr(torch, "save", cut_save)
    with pytest.raises(Killed):
        _run(main, CLIP_RUN, data, tmp_path / "split", 2)
    monkeypatch.setattr(torch, "save", save)
    (split,) = list((tmp_path / "split").iterdir())
    assert sorted(p.name for p in (split / "state").iterdir()) == ["epoch_1.pt",
                                                                   "epoch_2.pt.tmp"]
    _run(main, CLIP_RUN, data, None, 2, resume_dir=split)
    assert sorted(p.name for p in (split / "state").iterdir()) == ["epoch_2.pt"]
    # epoch 2 ran once more after the restore: its CSV row is written twice
    rows = (split / "losses_per_epoch.txt").read_text().splitlines()
    assert rows[-1] == (full / "losses_per_epoch.txt").read_text().splitlines()[-1]
    a, b = (checkpoint.read_npz(run / "best_model.npz") for run in (full, split))
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_snapshot_of_another_mode_raises(tmp_path):
    data = tmp_path / "data"
    run = _run(main, CLIP_RUN, data, tmp_path / "runs", 1)
    with pytest.raises(ValueError, match="another tree layout"):
        _run(main, CLIP_RUN + ["--finetune"], data, None, 2, resume_dir=run)
    with pytest.raises(ValueError, match="another tree layout"):
        _run(main, CLIP_RUN + ["--embedding-dim", "64"], data, None, 2, resume_dir=run)


def test_optimizer_state_round_trip():
    """An optimizer state's state_dict loads into a fresh one bound to a
    copy of the tree and steps on identically; a state of other groups or
    shapes raises, naming them."""
    gen = torch.Generator().manual_seed(0)
    tree = {"heads": {"w": torch.randn(3, 4, generator=gen)},
            "esm": {"b": torch.randn(5, generator=gen)}}
    opt = optimizer.multi_transform({"heads": optimizer.build(1e-2, schedule="cosine",
                                                              warmup_steps=1, total_steps=5),
                                     "esm": optimizer.adam(1e-3)}, grad_clip=1.0)

    def step(params, state):
        loss = sum((t ** 2).sum() for t in optimizer.tree_leaves(params))
        loss.backward()
        state.apply()

    a = {k: {n: t.clone() for n, t in v.items()} for k, v in tree.items()}
    sa = opt.init(a)
    for _ in range(2):
        step(a, sa)
    b = {k: {n: t.detach().clone() for n, t in v.items()} for k, v in a.items()}
    sb = opt.init(b)
    sb.load_state_dict(sa.state_dict())
    assert sb.states["heads"].count == 2
    for _ in range(2):
        step(a, sa)
        step(b, sb)
    assert all(torch.equal(x, y) for x, y in zip(optimizer.tree_leaves(a),
                                                 optimizer.tree_leaves(b)))
    with pytest.raises(ValueError, match="groups"):
        optimizer.adam().init(tree["heads"]).load_state_dict(sa.state_dict())
    with pytest.raises(ValueError, match="another tree layout"):
        optimizer.adam().init({"w": torch.zeros(4, 3)}).load_state_dict(
            sa.state_dict()["groups"]["heads"])
