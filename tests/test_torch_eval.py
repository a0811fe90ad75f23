"""The port's offline evals and figures (``eval/retrieval.py``,
``eval/embed.py``, ``eval/pca.py``, ``viz/plots.py``, ``cli.topk``,
``cli.cosine_similarity``) against the JAX package's, on the CPU: tiny ESM
config, float32, the same parameters carried across as numpy.

Candidate embeddings (padded and packed) and ``Embedder`` within 1e-5 of
JAX's; the retrieval ranks and curves equal on draws whose logit margins
are checked first to be far past that (so a 1e-5 difference cannot flip a
rank); the PCA helpers within float64 rounding; the CLIs end to end on the
same checkpoint and backbone npz, their printed accuracies equal and their
matrices within 1e-5; and the figures with matplotlib blocked.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from protein_clip_tpu.cli import cosine_similarity as jcos_cli
from protein_clip_tpu.cli import topk as jtopk_cli
from protein_clip_tpu.data.tokenizer import EsmTokenizer as JaxTokenizer
from protein_clip_tpu.eval import embed as jembed
from protein_clip_tpu.eval import pca as jpca
from protein_clip_tpu.eval import retrieval as jret
from protein_clip_tpu.models import clip as jclip
from protein_clip_tpu.models import esm2 as jesm2
from protein_clip_tpu.models import filip as jfilip
from protein_clip_tpu.train import checkpoint as jckpt
from protein_clip_tpu_torch.cli import cosine_similarity, main, topk
from protein_clip_tpu_torch.data import dataset
from protein_clip_tpu_torch.data.synthetic import write_fixture
from protein_clip_tpu_torch.data.tokenizer import EsmTokenizer
from protein_clip_tpu_torch.eval import embed, pca, retrieval
from protein_clip_tpu_torch.models import clip, esm2, filip
from protein_clip_tpu_torch.train import checkpoint
from protein_clip_tpu_torch.viz import plots

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))
ATOL = 1e-5
D = 16
N = 32
AAS = list("LAGVSERTIDPKQNFYMHWC")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    """(JAX CLIP config, port's, JAX backbone, port's, JAX CLIP heads,
    port's, JAX FILIP heads, port's, their configs)."""
    jmcfg = jclip.CLIPConfig(input_dim=64, embedding_dim=D, esm=jesm2.ESM2Config.tiny())
    mcfg = clip.CLIPConfig(input_dim=64, embedding_dim=D, esm=esm2.ESM2Config.tiny())
    jfcfg = jfilip.FILIPConfig(input_dim=64, embedding_dim=D, esm=jesm2.ESM2Config.tiny())
    fcfg = filip.FILIPConfig(input_dim=64, embedding_dim=D, esm=esm2.ESM2Config.tiny())
    jesm = jesm2.init_params(jax.random.key(1), jmcfg.esm)
    jheads = jclip.init_params(jax.random.key(2), jmcfg)
    jfheads = jfilip.init_params(jax.random.key(3), jfcfg)
    carry = lambda t: checkpoint.from_numpy_tree(_np(t), "cpu")  # noqa: E731
    return dict(jmcfg=jmcfg, mcfg=mcfg, jfcfg=jfcfg, fcfg=fcfg, jesm=jesm, esm=carry(jesm),
                jheads=jheads, heads=carry(jheads), jfheads=jfheads, fheads=carry(jfheads))


class FakeLoader:
    """N random pairs in batches of 4, the same for both packages."""

    def __init__(self, seed, n=N, bs=4):
        rng = np.random.default_rng(seed)
        pairs = [("".join(rng.choice(AAS, int(rng.integers(5, 25)))),
                  "".join(rng.choice(AAS, int(rng.integers(20, 60))))) for _ in range(n)]
        self.batches = [([p for p, _ in pairs[i:i + bs]], [r for _, r in pairs[i:i + bs]])
                        for i in range(0, n, bs)]

    def __iter__(self):
        return iter(self.batches)


def _assert_margins(got: np.ndarray, want: np.ndarray) -> None:
    """Two (Q, N) score matrices of the same draw: every candidate's score
    sits more than four times their largest difference from its query's
    true partner's (a rank flips only within twice it), so the draw holds
    no near-tie that the two packages' roundings could order apart."""
    diff = float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())
    gap = np.abs(want - np.diag(want)[:, None])
    np.fill_diagonal(gap, np.inf)
    assert gap.min() > 4 * diff, f"draw too close to a tie: {gap.min()} against {diff}"


def _logits(pep, rec) -> np.ndarray:
    return np.asarray(pep, np.float64) @ np.asarray(rec, np.float64).T


@pytest.mark.parametrize("packed", [False, True], ids=["padded", "packed"])
def test_encode_candidates_matches_jax(tiny, packed):
    t = tiny
    want = jret.encode_candidates(t["jheads"], t["jesm"], FakeLoader(0), JaxTokenizer(),
                                  t["jmcfg"], N, num_chunks=4, packed=packed)
    got = retrieval.encode_candidates(t["heads"], t["esm"], FakeLoader(0), EsmTokenizer(),
                                      t["mcfg"], N, num_chunks=4, packed=packed, device="cpu")
    for g, w in zip(got, want):
        assert g.shape == (N, D) and g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("packed", [False, True], ids=["padded", "packed"])
def test_evaluate_retrieval_matches_jax(tiny, packed):
    t = tiny
    _assert_margins(
        _logits(*retrieval.encode_candidates(t["heads"], t["esm"], FakeLoader(1),
                                             EsmTokenizer(), t["mcfg"], N, packed=packed,
                                             device="cpu")),
        _logits(*jret.encode_candidates(t["jheads"], t["jesm"], FakeLoader(1), JaxTokenizer(),
                                        t["jmcfg"], N, packed=packed)))
    want = jret.evaluate_retrieval(t["jheads"], t["jesm"], FakeLoader(1), JaxTokenizer(),
                                   t["jmcfg"], N, seed=0, packed=packed)
    got = retrieval.evaluate_retrieval(t["heads"], t["esm"], FakeLoader(1), EsmTokenizer(),
                                       t["mcfg"], N, seed=0, packed=packed, device="cpu")
    np.testing.assert_array_equal(got.ranks, want.ranks)
    np.testing.assert_array_equal(got.accuracies, want.accuracies)
    np.testing.assert_array_equal(got.random_accuracies, want.random_accuracies)
    assert got.top1 == want.top1


def test_eval_allrec_onequery_matches_jax(tiny):
    t = tiny
    for k in (0, 7, N - 1):
        want = jret.eval_allrec_onequery(t["jheads"], t["jesm"], FakeLoader(1), JaxTokenizer(),
                                         t["jmcfg"], k, N)
        got = retrieval.eval_allrec_onequery(t["heads"], t["esm"], FakeLoader(1),
                                             EsmTokenizer(), t["mcfg"], k, N, device="cpu")
        assert got == want and len(got) == 1


def test_evaluate_filip_retrieval_matches_jax(tiny):
    t = tiny
    ha, ma, hb, mb = jret.encode_candidates_tokens(t["jfheads"], t["jesm"], FakeLoader(2),
                                                   JaxTokenizer(), t["jfcfg"], N, num_chunks=4)
    got_tokens = retrieval.encode_candidates_tokens(t["fheads"], t["esm"], FakeLoader(2),
                                                    EsmTokenizer(), t["fcfg"], N, num_chunks=4,
                                                    device="cpu")
    for g, w in zip(got_tokens, (ha, ma, hb, mb)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    _assert_margins(retrieval.filip_score_matrix(*got_tokens, t["fheads"]["temperature"],
                                                 device="cpu"),
                    jret.filip_score_matrix(ha, ma, hb, mb, t["jfheads"]["temperature"]))
    want = jret.evaluate_filip_retrieval(t["jfheads"], t["jesm"], FakeLoader(2),
                                         JaxTokenizer(), t["jfcfg"], N, seed=3, num_chunks=4)
    got = retrieval.evaluate_filip_retrieval(t["fheads"], t["esm"], FakeLoader(2),
                                             EsmTokenizer(), t["fcfg"], N, seed=3,
                                             num_chunks=4, device="cpu")
    np.testing.assert_array_equal(got.ranks, want.ranks)
    np.testing.assert_array_equal(got.accuracies, want.accuracies)
    np.testing.assert_array_equal(got.random_accuracies, want.random_accuracies)


@pytest.mark.parametrize("side", ["pep", "rec"])
def test_embedder_matches_jax(tiny, side):
    """13 sequences of mixed lengths in batches of 8 (a padded last batch),
    returned in the input order."""
    t = tiny
    rng = np.random.default_rng(4)
    seqs = ["".join(rng.choice(AAS, int(k))) for k in rng.integers(3, 90, 13)]
    want = jembed.Embedder(t["jheads"], t["jesm"], t["jmcfg"], side=side, batch_size=8,
                           num_chunks=2)(seqs)
    got = embed.Embedder(t["heads"], t["esm"], t["mcfg"], side=side, batch_size=8,
                         num_chunks=2, device="cpu")(seqs)
    assert got.shape == (13, D) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_pca_helpers_match_jax():
    rng = np.random.default_rng(5)
    a, b = rng.standard_normal((40, 12)), rng.standard_normal((40, 12))
    for g, w in zip(pca.pca2(a), jpca.pca2(a)):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(pca.paired_cosine(a, b), jpca.paired_cosine(a, b), rtol=1e-12)


# ---------------------------------------------------------------------------
# The CLIs end to end, against the JAX package's on the same files
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def files(tiny, tmp_path_factory):
    """A 60-family fixture, the backbone and both heads as npz (JAX's
    export, which both packages read)."""
    d = tmp_path_factory.mktemp("eval_cli")
    write_fixture(d / "data", prefix1="protein1", prefix2="protein2", n_families=60, seed=42)
    for name in ("jesm", "jheads", "jfheads"):
        jckpt.export_npz(d / f"{name}.npz", tiny[name])
    return d


def _cli_argv(files, ckpt: str, runs: str, extra=()) -> list[str]:
    return ["--esm-config", "tiny", "--esm-dtype", "float32", "--esm-weights",
            str(files / "jesm.npz"), "--embedding-dim", str(D), "--checkpoint",
            str(files / f"{ckpt}.npz"), "--data-dir", str(files / "data"), "--batch-size", "4",
            "--runs-dir", str(files / runs), *extra]


def _printed(out: str) -> list[str]:
    return [line for line in out.splitlines()
            if line.startswith(("top-1 accuracy", "top-10 accuracy", "mean rank"))]


@pytest.mark.parametrize("mode", ["padded", "packed", "filip"])
def test_cli_topk_matches_jax(tiny, files, capsys, mode):
    """The split's first 32 pairs, whose margins are checked first: the
    printed accuracies and mean rank equal the JAX CLI's, and the curve is
    drawn."""
    t = tiny
    extra = ["--split", "train", "--n-candidates", str(N), "--num-chunks", "4"]
    extra += {"padded": [], "packed": ["--packed"], "filip": ["--filip"]}[mode]
    ckpt = "jfheads" if mode == "filip" else "jheads"
    train_ds = dataset.generate_datasets(files / "data", "protein1", "protein2", seed=42)[0]
    pairs = next(iter(dataset.PairLoader(train_ds, N, shuffle=False, seed=42)))
    loader = [pairs]
    if mode == "filip":
        tokens = retrieval.encode_candidates_tokens(t["fheads"], t["esm"], loader,
                                                    EsmTokenizer(), t["fcfg"], N, num_chunks=4,
                                                    device="cpu")
        jtokens = jret.encode_candidates_tokens(t["jfheads"], t["jesm"], loader, JaxTokenizer(),
                                                t["jfcfg"], N, num_chunks=4)
        _assert_margins(retrieval.filip_score_matrix(*tokens, t["fheads"]["temperature"],
                                                     device="cpu"),
                        jret.filip_score_matrix(*jtokens, t["jfheads"]["temperature"]))
    else:
        _assert_margins(
            _logits(*retrieval.encode_candidates(t["heads"], t["esm"], loader, EsmTokenizer(),
                                                 t["mcfg"], N, num_chunks=4,
                                                 packed=mode == "packed", device="cpu")),
            _logits(*jret.encode_candidates(t["jheads"], t["jesm"], loader, JaxTokenizer(),
                                            t["jmcfg"], N, num_chunks=4,
                                            packed=mode == "packed")))
    assert jtopk_cli.main(_cli_argv(files, ckpt, f"jax_topk_{mode}", extra)) == 0
    want = _printed(capsys.readouterr().out)
    assert topk.main(_cli_argv(files, ckpt, f"topk_{mode}", extra + ["--device", "cpu"])) == 0
    out = capsys.readouterr().out
    assert _printed(out) == want and len(want) == 3
    (run,) = list((files / f"topk_{mode}").iterdir())
    assert [p.name for p in (run / "figures").iterdir()] == ["figure 1.png"]
    assert "plot saved to" in out


def test_cli_cosine_similarity_matches_jax(files):
    """The three matrices: the trained ones within 1e-5 of the JAX CLI's on
    the same checkpoint and batches; the raw one (heads initialised from
    seed 0 by each package's own generator) a cosine matrix."""
    argv = _cli_argv(files, "jheads", "jax_cos", ["--prefix-a", "protein1"])
    assert jcos_cli.main(argv) == 0
    assert cosine_similarity.main(_cli_argv(files, "jheads", "cos", ["--device", "cpu"])) == 0
    (jrun,), (run,) = (list((files / name).iterdir()) for name in ("jax_cos", "cos"))
    names = sorted(p.name for p in (run / "figures").iterdir())
    assert names == sorted(p.name for p in (jrun / "figures").iterdir()) == [
        f"figure {n}.{ext}" for n in (1, 2, 3) for ext in ("npy", "png")]
    for n in (1, 2, 3):
        got = np.load(run / "figures" / f"figure {n}.npy")
        assert got.shape == (4, 4) and np.isfinite(got).all() and np.abs(got).max() <= 1 + 1e-6
        if n > 1:
            np.testing.assert_allclose(got, np.load(jrun / "figures" / f"figure {n}.npy"),
                                       atol=ATOL)


# ---------------------------------------------------------------------------
# Figures
# ---------------------------------------------------------------------------

def _draw_all(base, loader):
    """The runners' sequence of figures: lengths, a heatmap, the loss
    curves, a plain matrix, a heatmap."""
    matrix = np.eye(4, dtype=np.float32) * 0.5
    plots.plot_protein_lengths(base, base / "data")
    plots.plot_embedding_cosine_similarities(base, "a", loader, None, lambda p, r: matrix)
    plots.plot_loss_curves(base, [2.0, 1.5], [2.1, 1.7], 8, 4)
    plots.plot_similarity_matrix(base, "b", matrix)
    return plots.plot_embedding_cosine_similarities(base, "c", loader, None,
                                                    lambda p, r: -matrix)


def test_figures_without_matplotlib(tmp_path, monkeypatch, capsys):
    """With matplotlib blocked no PNG is drawn and one [viz] line says so,
    but the heatmaps' matrices are written under the numbers they take
    with it."""
    for base in (tmp_path / "with", tmp_path / "without"):
        write_fixture(base / "data", prefix1="protein1", prefix2="protein2", n_families=8,
                      seed=0)
    _draw_all(tmp_path / "with", FakeLoader(6))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setattr(plots, "_SAID_NO_MATPLOTLIB", [False])
    capsys.readouterr()
    last = _draw_all(tmp_path / "without", FakeLoader(6))
    said = [line for line in capsys.readouterr().out.splitlines() if line.startswith("[viz]")]
    assert len(said) == 1 and "matplotlib is not installed" in said[0]
    drawn, bare = (sorted(p.name for p in (tmp_path / b / "figures").iterdir())
                   for b in ("with", "without"))
    assert drawn == ["figure 1.png", "figure 2.npy", "figure 2.png", "figure 3.png",
                     "figure 4.png", "figure 5.npy", "figure 5.png"]
    assert bare == ["figure 2.npy", "figure 5.npy"]
    assert last == str(tmp_path / "without" / "figures" / "figure 5.npy")
    for n in (2, 5):
        np.testing.assert_array_equal(np.load(tmp_path / "with" / "figures" / f"figure {n}.npy"),
                                      np.load(tmp_path / "without" / "figures" / f"figure {n}.npy"))


def test_run_figures_and_epoch_figures(tmp_path):
    """cli.main with --epoch-figures: the lengths, the raw heatmap, two
    heatmaps an epoch, the loss curves and the trained heatmaps, numbered in
    that order; every heatmap's matrix a cosine matrix."""
    assert main.main(["--esm-config", "tiny", "--esm-dtype", "float32", "--device", "cpu",
                      "--batch-size", "4", "--accumulated-batches", "2", "--num-chunks", "2",
                      "--fixture-families", "40", "--synthetic-fixture", "--data-dir",
                      str(tmp_path / "data"), "--runs-dir", str(tmp_path / "runs"),
                      "--epochs", "2", "--epoch-figures"]) == 0
    (run,) = list((tmp_path / "runs").iterdir())
    names = sorted(p.name for p in (run / "figures").iterdir())
    heatmaps = (2, 3, 4, 5, 6, 8, 9)
    assert names == sorted([f"figure {n}.png" for n in range(1, 10)]
                           + [f"figure {n}.npy" for n in heatmaps])
    for n in heatmaps:
        m = np.load(run / "figures" / f"figure {n}.npy")
        assert m.shape == (4, 4) and np.isfinite(m).all() and np.abs(m).max() <= 1 + 1e-6
