"""Post-hoc embedding analysis: the port of ``protein_clip_tpu/eval/pca.py``.

A 2-component PCA scatter of pooled embeddings coloured by retrieval rank
and by paired cosine similarity, by a NumPy SVD (no sklearn); the figures
through ``viz/plots.figure`` (drawn only where matplotlib is installed).
"""

from __future__ import annotations

import numpy as np

from ..viz import plots


def pca2(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(N, D) -> (N, 2) projection + explained-variance ratios."""
    x = np.asarray(x, dtype=np.float64)
    xc = x - x.mean(axis=0, keepdims=True)
    _, s, vt = np.linalg.svd(xc, full_matrices=False)
    var = (s ** 2) / max(len(x) - 1, 1)
    return xc @ vt[:2].T, var[:2] / var.sum()


def paired_cosine(pep_emb: np.ndarray, rec_emb: np.ndarray) -> np.ndarray:
    """Cosine similarity of each (pep_i, rec_i) pair."""
    a = np.asarray(pep_emb, np.float64)
    b = np.asarray(rec_emb, np.float64)
    den = np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)
    return (a * b).sum(-1) / np.maximum(den, 1e-12)


def plot_embedding_pca(base_path, pep_emb, rec_emb, ranks) -> list[str]:
    """Two scatter figures, coloured by top-k rank and by paired cosine
    similarity; the paths drawn ("" where matplotlib is absent)."""
    proj, ratio = pca2(np.asarray(pep_emb))
    paths = []
    for values, label in ((np.asarray(ranks), "retrieval rank"),
                          (paired_cosine(pep_emb, rec_emb), "paired cosine similarity")):
        def draw(plt, values=values, label=label):
            plt.figure(figsize=(6, 4))
            sc = plt.scatter(proj[:, 0], proj[:, 1], c=values, cmap="viridis", s=12)
            plt.colorbar(sc, label=label)
            plt.xlabel(f"PC1 ({ratio[0]:.0%})")
            plt.ylabel(f"PC2 ({ratio[1]:.0%})")
            plt.title(f"Peptide embedding PCA by {label}")

        path, drawn = plots.figure(base_path, draw)
        paths.append(str(path) if drawn else "")
    return paths
