"""Retrieval evaluation, scoring and ranking: the port of
``protein_clip_tpu/eval/retrieval.py``.

The reference's top-k protocol: the rank of each query's true partner among
``n_candidates`` (256) candidates, 1 + the number of candidates scoring
strictly above it, and the cumulative top-k accuracy curve against a
shuffled-random baseline. Each side is encoded once (padded through the
chunked backbone, or packed with ``packed=True``) and the whole logit
matrix ranked at once; the reference re-encodes every candidate per query,
with the same ranks.

``filip_score_matrix`` and ``filip_score_matrix_ragged`` give (Q, N)
late-interaction scores, ``(sim_a + sim_b) / 2`` through the masked max-sim
kernel (``ops/filip.filip_similarity_fused``), which never materialises the
(Q, N, TA, TB) score tensor. Queries stream in row blocks and candidates in
column blocks, one kernel launch per (row block, column block).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..data.prefetch import to_device
from ..models import clip
from ..ops.filip import filip_similarity_fused
from ..train.clip_engine import expand_batch, tokenize_pair_batch
from ..train.gradcache import encode_hidden_chunked
from ..utils.device import resolve_device


@dataclasses.dataclass
class RetrievalResult:
    ranks: np.ndarray              # (N,) 1-based rank of each query's true partner
    accuracies: np.ndarray         # (N,) cumulative top-k accuracy
    random_accuracies: np.ndarray

    @property
    def top1(self) -> float:
        return float(self.accuracies[0])


def _collect_pairs(loader, n_candidates: int) -> tuple[list[str], list[str]]:
    """The first ``n_candidates`` pairs the loader yields."""
    peps: list[str] = []
    recs: list[str] = []
    for p, r in loader:
        peps.extend(p)
        recs.extend(r)
        if len(peps) >= n_candidates:
            break
    if len(peps) < n_candidates:
        raise ValueError(f"loader yielded {len(peps)} pairs < {n_candidates} candidates")
    return peps[:n_candidates], recs[:n_candidates]


@torch.inference_mode()
def encode_candidates(params, esm_params, loader, tokenizer, mcfg, n_candidates: int = 256,
                      num_chunks: int = 16, packed: bool = False,
                      device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """Embed both sides of the loader's first ``n_candidates`` pairs once, in
    eval mode on ``device``: (pep_emb, rec_emb), each (N, D) float32. The
    padded path runs the backbone in ``num_chunks`` microbatches
    (``gradcache.encode_hidden_chunked``); ``packed=True`` rides the packed
    path (``packed_engine.embed_packed``), the same embeddings in the
    pairs' order."""
    device = resolve_device(device)
    peps, recs = _collect_pairs(loader, n_candidates)
    if packed:
        from ..train.packed_engine import embed_packed, tokenize_packed
        pep, rec = embed_packed(params, esm_params,
                                to_device(tokenize_packed(tokenizer, peps, recs), device), mcfg)
    else:
        batch = expand_batch(to_device(tokenize_pair_batch(tokenizer, peps, recs), device))
        pep, rec = (clip.encode_side(params, side, encode_hidden_chunked(
            esm_params, batch[f"{side}_ids"], batch[f"{side}_mask"], mcfg.esm,
            num_chunks).float(), batch[f"{side}_mask"], mcfg, train=False)
            for side in ("pep", "rec"))
    return pep.float().cpu().numpy(), rec.float().cpu().numpy()


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


def eval_allrec_onequery(params, esm_params, loader, tokenizer, mcfg, k: int,
                         n_candidates: int = 256, device="cuda") -> list[int]:
    """The reference's ``eval_gc_allrec_onepep``: the rank of query k's true
    partner among the candidate pool, as a one-element list. Prefer
    ``evaluate_retrieval``, which gives all N ranks for that cost."""
    pep, rec = encode_candidates(params, esm_params, loader, tokenizer, mcfg, n_candidates,
                                 device=device)
    return [int(ranks_from_embeddings(pep, rec)[k])]


@torch.inference_mode()
def encode_candidates_tokens(params, esm_params, loader, tokenizer, fcfg,
                             n_candidates: int = 256, num_chunks: int = 16, device="cuda"):
    """Both sides' normalised per-token embeddings of the loader's first
    ``n_candidates`` pairs, encoded once in eval mode: (ha, mask_a, hb,
    mask_b) on ``device``, ha and hb (N, T, D) float32, the masks int32."""
    from ..models import filip as filip_mod

    device = resolve_device(device)
    peps, recs = _collect_pairs(loader, n_candidates)
    batch = expand_batch(to_device(tokenize_pair_batch(tokenizer, peps, recs), device))
    ha, hb = filip_mod.encode_batch_tokens(params, esm_params, batch, fcfg,
                                           num_chunks=num_chunks)
    return ha, batch["pep_mask"], hb, batch["rec_mask"]


def _result(ranks: np.ndarray, n: int, seed: int | None) -> RetrievalResult:
    return RetrievalResult(ranks=ranks, accuracies=topk_curve(ranks, n),
                           random_accuracies=random_baseline_curve(n, seed))


def evaluate_filip_retrieval(params, esm_params, loader, tokenizer, fcfg,
                             n_candidates: int = 256, seed: int | None = None,
                             num_chunks: int = 16, device="cuda") -> RetrievalResult:
    """FILIP top-k retrieval over ``n_candidates`` queries and candidates:
    the late-interaction ranks of ``filip_ranks_from_tokens`` (K4 on the
    card)."""
    ha, ma, hb, mb = encode_candidates_tokens(params, esm_params, loader, tokenizer, fcfg,
                                              n_candidates, num_chunks=num_chunks,
                                              device=device)
    ranks = filip_ranks_from_tokens(ha, ma, hb, mb, params["temperature"], device=device)
    return _result(ranks, n_candidates, seed)


def evaluate_retrieval(params, esm_params, loader, tokenizer, mcfg, n_candidates: int = 256,
                       seed: int | None = None, packed: bool = False,
                       device="cuda") -> RetrievalResult:
    """CLIP top-k retrieval over ``n_candidates`` queries and candidates."""
    pep, rec = encode_candidates(params, esm_params, loader, tokenizer, mcfg, n_candidates,
                                 packed=packed, device=device)
    return _result(ranks_from_embeddings(pep, rec), n_candidates, seed)
