"""Batch embedding of one side and nearest-partner queries over precomputed
embeddings (serving side): the port of ``protein_clip_tpu/eval/embed.py``."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..data.tokenizer import EsmTokenizer
from ..models import clip
from ..train.gradcache import encode_hidden_chunked
from ..utils.device import resolve_device


@dataclasses.dataclass
class Embedder:
    """Embeds sequences with one side ('pep' or 'rec') of a trained CLIP, in
    eval mode on ``device``."""

    params: dict
    esm_params: dict
    mcfg: clip.CLIPConfig
    side: str = "rec"
    batch_size: int = 64
    num_chunks: int = 4
    tokenizer: EsmTokenizer = dataclasses.field(default_factory=EsmTokenizer)
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @torch.inference_mode()
    def __call__(self, sequences: list[str]) -> np.ndarray:
        """(N, D) scaled embeddings in the sequences' order. Batches are
        length-sorted (each pad bucket reused as far as it goes), a short
        last batch padded to ``batch_size`` with empty sequences, then the
        order is restored."""
        order = sorted(range(len(sequences)), key=lambda i: len(sequences[i]))
        out = np.empty((len(sequences), self.mcfg.embedding_dim), np.float32)
        bs = self.batch_size
        for start in range(0, len(order), bs):
            idx = order[start:start + bs]
            batch = [sequences[i] for i in idx]
            enc = self.tokenizer(batch + [""] * (bs - len(batch)))
            ids, mask = (torch.from_numpy(enc[k]).to(self.device)
                         for k in ("input_ids", "attention_mask"))
            h = encode_hidden_chunked(self.esm_params, ids, mask, self.mcfg.esm,
                                      self.num_chunks)
            emb = clip.encode_side(self.params, self.side, h.float(), mask, self.mcfg,
                                   train=False)
            out[idx] = emb[:len(batch)].float().cpu().numpy()
        return out


def nearest_partners(query_emb: np.ndarray, corpus_emb: np.ndarray,
                     k: int = 10) -> tuple[np.ndarray, np.ndarray]:
    """Top-k corpus indices + scores per query (dot product — embeddings
    already carry the exp(t/2) scaling on both sides)."""
    scores = np.asarray(query_emb) @ np.asarray(corpus_emb).T
    idx = np.argsort(-scores, axis=1)[:, :k]
    top = np.take_along_axis(scores, idx, axis=1)
    return idx, top
