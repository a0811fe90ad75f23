"""Nearest-partner query over precomputed embeddings (serving side): the
port of ``protein_clip_tpu/eval/embed.nearest_partners``."""

from __future__ import annotations

import numpy as np


def nearest_partners(query_emb: np.ndarray, corpus_emb: np.ndarray,
                     k: int = 10) -> tuple[np.ndarray, np.ndarray]:
    """Top-k corpus indices + scores per query (dot product — embeddings
    already carry the exp(t/2) scaling on both sides)."""
    scores = np.asarray(query_emb) @ np.asarray(corpus_emb).T
    idx = np.argsort(-scores, axis=1)[:, :k]
    top = np.take_along_axis(scores, idx, axis=1)
    return idx, top
