"""Retrieval scoring and ranking: the port of the serving half of
``protein_clip_tpu/eval/retrieval.py``.

``filip_score_matrix`` and ``filip_score_matrix_ragged`` give (Q, N)
late-interaction scores, ``(sim_a + sim_b) / 2`` through the masked max-sim
kernel (``ops/filip.filip_similarity_fused``), which never materialises the
(Q, N, TA, TB) score tensor. Queries stream in row blocks and candidates in
column blocks, one kernel launch per (row block, column block). The
candidate encoders and ``evaluate_*`` need the training loaders and come
with the eval slice.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.filip import filip_similarity_fused
from ..utils.device import resolve_device


def ranks_from_embeddings(pep_emb, rec_emb) -> np.ndarray:
    """1-based rank of the true partner for every query: 1 + the number of
    candidates scoring strictly above it (the self term counts 0)."""
    logits = np.asarray(pep_emb, np.float32) @ np.asarray(rec_emb, np.float32).T
    diag = np.diag(logits)
    return 1 + (logits > diag[:, None]).sum(axis=1)


def topk_curve(ranks: np.ndarray, n: int) -> np.ndarray:
    """Cumulative top-k accuracy curve."""
    top_k = np.zeros(n, dtype=np.int64)
    for r in ranks:
        top_k[min(int(r) - 1, n - 1)] += 1
    return np.cumsum(top_k) / len(ranks)


def random_baseline_curve(n: int, seed: int | None = None) -> np.ndarray:
    """Shuffled-arange baseline: ranks are a permutation of 0..n-1, which
    gives the diagonal accuracy line."""
    perm = np.random.default_rng(seed).permutation(n)
    top_k = np.zeros(n, dtype=np.int64)
    for r in perm:
        top_k[int(r)] += 1
    return np.cumsum(top_k) / n


def _on(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """An array or tensor as a contiguous tensor of ``dtype`` on ``device``."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=dtype).contiguous()


def _filip_score_rows(ha_rows: torch.Tensor, ma_rows: torch.Tensor, hb: torch.Tensor,
                      mb: torch.Tensor, temperature) -> np.ndarray:
    """(rows, cols) direction-averaged scores on the tensors' device."""
    sa, sb = filip_similarity_fused(ha_rows, hb, ma_rows, mb, temperature)
    return ((sa + sb) / 2.0).cpu().numpy()


def filip_score_matrix(ha, mask_a, hb, mask_b, temperature, row_block: int = 64,
                       col_block: int = 4096, device="cuda") -> np.ndarray:
    """(Q, N) late-interaction scores over a dense candidate index: ha
    (Q, TA, D), hb (N, TB, D) float32, masks (Q, TA), (N, TB). Each
    (row block, column block) is one kernel launch on ``device``."""
    device = resolve_device(device)
    n, m = ha.shape[0], hb.shape[0]
    if m == 0:
        return np.zeros((n, 0), np.float32)
    rb, cb = min(row_block, n), min(col_block, m)
    out = np.empty((n, m), np.float32)
    for i in range(0, n, rb):
        ha_rows = _on(ha[i:i + rb], device, torch.float32)
        ma_rows = _on(mask_a[i:i + rb], device, torch.int32)
        for j in range(0, m, cb):
            out[i:i + rb, j:j + cb] = _filip_score_rows(
                ha_rows, ma_rows, _on(hb[j:j + cb], device, torch.float32),
                _on(mask_b[j:j + cb], device, torch.int32), temperature)
    return out


def filip_score_matrix_ragged(ha, mask_a, flat, lengths, temperature, row_block: int = 64,
                              col_block: int = 1024, device="cuda") -> np.ndarray:
    """``filip_score_matrix`` over a ragged candidate index (``embed
    --filip``'s {tokens (sum_L, D), lengths (N,)}). Each column block is
    densified on the host to (block, tb, D), tb its longest row rounded up
    to a multiple of 64, and copied to ``device`` once; every query row
    block is scored against it."""
    device = resolve_device(device)
    lengths = np.asarray(lengths, np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    n, m = ha.shape[0], len(lengths)
    if m == 0:
        return np.zeros((n, 0), np.float32)
    d = flat.shape[1]
    rb, cb = min(row_block, n), min(col_block, m)
    rows = [(_on(ha[i:i + rb], device, torch.float32), _on(mask_a[i:i + rb], device,
                                                            torch.int32))
            for i in range(0, n, rb)]
    out = np.empty((n, m), np.float32)
    for j in range(0, m, cb):
        lens = lengths[j:j + cb]
        tb = max(64, int(-(-int(lens.max()) // 64) * 64))
        hb = np.zeros((len(lens), tb, d), np.float32)
        mb = np.zeros((len(lens), tb), np.int32)
        for r, g in enumerate(range(j, j + len(lens))):
            hb[r, :lengths[g]] = flat[offsets[g]:offsets[g + 1]]
            mb[r, :lengths[g]] = 1
        hb_t, mb_t = _on(hb, device, torch.float32), _on(mb, device, torch.int32)
        for k, (ha_rows, ma_rows) in enumerate(rows):
            out[k * rb:(k + 1) * rb, j:j + cb] = _filip_score_rows(ha_rows, ma_rows, hb_t,
                                                                   mb_t, temperature)
    return out


def filip_ranks_from_tokens(ha, mask_a, hb, mask_b, temperature, row_block: int = 64,
                            device="cuda") -> np.ndarray:
    """Late-interaction ranks over aligned pairs: the (N, N) matrix of
    ``filip_score_matrix`` ranked by ``ranks_from_embeddings``' rule."""
    sim = filip_score_matrix(ha, mask_a, hb, mask_b, temperature, row_block, device=device)
    diag = np.diag(sim)
    return 1 + (sim > diag[:, None]).sum(axis=1)
