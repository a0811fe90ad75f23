"""Run-artifact figures: the port of ``protein_clip_tpu/viz/plots.py``.

The same artifact contract: sequentially numbered ``figures/figure N.png``
inside the run directory, similarity heatmaps de-scaled to raw cosine by
exp(-temperature), loss curves normalised by -log(1/batch), cluster-size
and sequence-length histograms. ``plot_embedding_cosine_similarities``
writes its matrix as ``figure N.npy`` beside the heatmap.

matplotlib is imported inside the drawing code, never with the module:
where it is not installed (the card's machine), no PNG is drawn and one
``[viz]`` line says so, but every figure still takes its number, so the
numbering is the same with and without it, and the similarity matrices are
written as ``.npy`` all the same.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Callable

import numpy as np

# next "figure N" index per figures dir: the existing-file scan runs once
# per folder, later figures take the next number without a stat
_NEXT_FIGURE_INDEX: dict[Path, int] = {}
_SAID_NO_MATPLOTLIB = [False]


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None where matplotlib is
    not installed (said once per process)."""
    try:
        import matplotlib
    except ImportError:
        if not _SAID_NO_MATPLOTLIB[0]:
            print("[viz] matplotlib is not installed: figures are not drawn; the similarity "
                  "matrices are still written as figures/figure N.npy")
            _SAID_NO_MATPLOTLIB[0] = True
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def next_figure(base_path: str | Path) -> Path:
    """Take the next number in ``base_path/figures``: the path of its PNG
    (a number with a PNG or an NPY there is taken)."""
    folder = Path(base_path) / "figures"
    folder.mkdir(parents=True, exist_ok=True)
    n = _NEXT_FIGURE_INDEX.get(folder, 1)
    while any((folder / f"figure {n}{ext}").exists() for ext in (".png", ".npy")):
        n += 1
    _NEXT_FIGURE_INDEX[folder] = n + 1
    return folder / f"figure {n}.png"


def figure(base_path: str | Path, draw: Callable) -> tuple[Path, bool]:
    """Take the next figure number and, where matplotlib is installed,
    ``draw(plt)`` onto a new figure and save it there. Returns (the PNG's
    path, whether it was drawn)."""
    path = next_figure(base_path)
    plt = _pyplot()
    if plt is None:
        return path, False
    draw(plt)
    plt.tight_layout()
    plt.savefig(path)
    plt.close()   # not clf: clf leaks the Figure object across --epoch-figures
    return path, True


def save_plot(base_path: str | Path) -> str:
    """Save pyplot's current figure as the next ``figures/figure N.png``
    (the TPU package's form, for a caller that has drawn it already, so
    with matplotlib installed)."""
    path = next_figure(base_path)
    import matplotlib.pyplot as plt
    plt.tight_layout()
    plt.savefig(path)
    plt.close()
    return str(path)


def _drawn(result: tuple[Path, bool]) -> str:
    path, drawn = result
    return str(path) if drawn else ""


def plot_similarity_matrix(base_path, title: str, matrix: np.ndarray) -> str:
    """A heatmap of a raw cosine matrix; "" where it is not drawn."""
    return _drawn(figure(base_path, lambda plt: _heatmap(plt, title, np.asarray(matrix))))


def plot_embedding_cosine_similarities(base_path, title, loader, tokenizer,
                                       compute_fn: Callable) -> str:
    """First loader batch -> raw-cosine similarity heatmap, and the matrix
    as ``figure N.npy`` (drawn or not). ``compute_fn(peps, recs)`` gives
    the (B, B) raw cosine matrix (already de-scaled). Returns the PNG's
    path, or the NPY's where no PNG is drawn; "" for an empty loader."""
    try:
        peps, recs = next(iter(loader))
    except StopIteration:
        print(f"[viz] skipping '{title}': loader is empty")
        return ""
    matrix = np.asarray(compute_fn(peps, recs))
    path, drawn = figure(base_path, lambda plt: _heatmap(plt, title, matrix))
    np.save(path.with_suffix(".npy"), matrix)
    return str(path if drawn else path.with_suffix(".npy"))


def _heatmap(plt, title: str, matrix: np.ndarray) -> None:
    plt.figure(figsize=(6, 4))
    plt.imshow(matrix, cmap="ocean", vmin=-1, vmax=1)
    plt.colorbar()
    plt.title(title)
    plt.xlabel("Receptor Protein")
    plt.ylabel("Peptide")


def plot_loss_curves(base_path, train_losses, val_losses,
                     train_batch_size: int, val_batch_size: int) -> str:
    norm_t = -math.log(1.0 / train_batch_size)
    norm_v = -math.log(1.0 / val_batch_size)

    def draw(plt):
        plt.plot([v / norm_t for v in train_losses], label="Train Loss")
        plt.plot([v / norm_v for v in val_losses], label="Validation Loss")
        plt.title("Training and Validation Loss Relative to Random")
        plt.xlabel("Epochs")
        plt.ylabel("Loss Relative to Random")
        plt.legend()

    return _drawn(figure(base_path, draw))


def plot_clustering(base_path, data_dir, prefix: str = "protein2") -> str:
    def draw(plt):
        counts: dict[str, int] = {}
        n_rows = 0
        with open(Path(data_dir) / f"{prefix}DB_clustered.tsv") as f:
            for line in f:
                if line.strip():
                    rep = line.split("\t")[0]
                    counts[rep] = counts.get(rep, 0) + 1
                    n_rows += 1
        plt.hist(list(counts.values()), bins=50, log=True)
        plt.xlabel("Number of Protein-Protein Sequences in Cluster")
        plt.ylabel("Number of Clusters")
        plt.title(f"Clustering. NSeq={n_rows}, NClusters={len(counts)}")

    return _drawn(figure(base_path, draw))


def plot_protein_lengths(base_path, data_dir, prefix1: str = "protein1",
                         prefix2: str = "protein2") -> str:
    def draw(plt):
        from ..data.fasta import parse_fasta
        lengths = [len(seq) for prefix in (prefix1, prefix2)
                   for _, seq in parse_fasta(Path(data_dir) / f"{prefix}.fasta")]
        plt.hist(lengths, bins=50, log=True)
        plt.xlabel("Length of Protein Sequence")
        plt.ylabel("Number of Sequences")
        plt.title(f"Distribution of Protein Sequences Lengths in Dataset. "
                  f"NSeq={len(lengths)}")

    return _drawn(figure(base_path, draw))
