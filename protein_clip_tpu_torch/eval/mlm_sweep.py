"""Masking-rate sweep: the port of ``protein_clip_tpu/eval/mlm_sweep.py``.
For each masking probability, the realised fraction of changed token ids
per sequence (the reference notebook's box-plot data), in pure Python
with one ``random.Random`` (equal to the TPU package's for the same seed).
"""

from __future__ import annotations

import random

import numpy as np

from ..data.tokenizer import EsmTokenizer
from ..models.mlm import changed_fraction, mask_sequence
from ..viz import plots


def sweep(sequences: list[str], probs=(0.05, 0.1, 0.2, 0.3, 0.4, 0.5),
          mask_char: str = ".", seed: int = 42,
          tokenizer: EsmTokenizer | None = None) -> dict[float, list[float]]:
    """{prob: [changed fraction per sequence]}, the probabilities in the
    given order, each sequence masked once per probability by one
    ``random.Random(seed)``."""
    tok = tokenizer or EsmTokenizer()
    rng = random.Random(seed)
    out: dict[float, list[float]] = {}
    for p in probs:
        fracs = []
        for seq in sequences:
            masked = mask_sequence(seq, p, mask_char, rng)
            a = tok.encode(seq)
            b = tok.encode(masked)
            fracs.append(changed_fraction(a, b, np.ones_like(a)))
        out[p] = fracs
    return out


def plot_sweep(base_path, result: dict[float, list[float]]) -> str:
    """The sweep's box plot as the next ``figures/figure N.png`` where
    matplotlib is installed, and its data under the same number either way:
    ``figure N.npy``, a (probabilities, sequences) float array whose rows
    follow ``figure N.probs.npy``. Returns the PNG's path, or the NPY's
    where no PNG is drawn."""
    probs = sorted(result)

    def draw(plt):
        plt.figure()
        plt.boxplot([result[p] for p in probs], tick_labels=[str(p) for p in probs])
        plt.xlabel("Masking probability")
        plt.ylabel("Fraction of changed token ids")
        plt.title("MLM masking rate sweep")

    path, drawn = plots.figure(base_path, draw)
    np.save(path.with_suffix(".npy"), np.asarray([result[p] for p in probs], np.float64))
    np.save(path.with_suffix(".probs.npy"), np.asarray(probs, np.float64))
    return str(path if drawn else path.with_suffix(".npy"))
