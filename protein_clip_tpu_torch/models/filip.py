"""FILIP late-interaction heads over the ESM-2 backbone: the port of
``protein_clip_tpu/models/filip.py``.

Per-token embeddings from both sides, L2-normalised per token, then the
FILIP similarity: for each pair (i, j), the max over the other side's
tokens, averaged over one's own valid tokens, in both directions.

``filip_similarity`` is the plain version that materialises the
(A, B, TA, TB) score tensor, kept as the oracle;
``ops/filip.filip_similarity_fused`` computes the same scores through the
masked max-sim kernel without it, and is ``forward``'s default (the TPU
training path's choice), differentiable in the tokens and the
temperature. The backbone is frozen: ``encode_batch_tokens`` runs it with
no graph, and only the heads take part in autograd. Head dropout draws
from an explicit ``torch.Generator`` in train mode (``models/heads.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.filip import filip_similarity_fused
from ..train.gradcache import encode_hidden_chunked
from ..utils.device import resolve_device
from . import esm2, heads

Params = dict


@dataclasses.dataclass(frozen=True)
class FILIPConfig:
    input_dim: int = 640
    embedding_dim: int = 128
    h1: int = 2
    h2: int = 2
    dropout: float = 0.1          # training only
    activation: str = "relu"
    esm: esm2.ESM2Config = dataclasses.field(default_factory=esm2.ESM2Config.t30_150M)


def init_params(cfg: FILIPConfig, generator: torch.Generator,
                dtype=torch.float32, device="cuda") -> Params:
    """The two head stacks and the temperature (1.0). The head tree is the
    CLIP heads' tree, so the CLIP checkpoint loaders read it."""
    device = resolve_device(device)
    return {
        "pep": heads.init_head(generator, cfg.input_dim, cfg.embedding_dim,
                               cfg.h1, cfg.h2, dtype, device),
        "rec": heads.init_head(generator, cfg.input_dim, cfg.embedding_dim,
                               cfg.h1, cfg.h2, dtype, device),
        "temperature": torch.tensor(1.0, dtype=dtype, device=device),
    }


def encode_side_tokens(params: Params, side: str, hidden: torch.Tensor,
                       cfg: FILIPConfig, *, train: bool = False,
                       generator: torch.Generator | None = None) -> torch.Tensor:
    """Per-token embeddings (B, T, D), L2-normalised along D in f32
    (dropout at ``cfg.dropout`` in train mode)."""
    x = heads.encode_tokens(params[side], hidden, activation=cfg.activation,
                            dropout_rate=cfg.dropout, train=train, generator=generator)
    x32 = x.float()
    return (x32 / x32.square().sum(-1, keepdim=True).sqrt()).to(x.dtype)


def filip_similarity(ha: torch.Tensor, hb: torch.Tensor, mask_a: torch.Tensor,
                     mask_b: torch.Tensor, temperature) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain FILIP score. ha (A, TA, D), hb (B, TB, D) normalised; masks
    (A, TA), (B, TB) {0, 1}. Returns (sim_a, sim_b), each (A, B).

    Scores are divided by t before the max, and a max over no valid token
    stays f32-min (it is not clamped to 0 as the kernel clamps it)."""
    mask_a = mask_a.bool()
    mask_b = mask_b.bool()
    scores = torch.einsum("atd,bsd->abts", ha.float(), hb.float())
    scores = scores / torch.as_tensor(temperature, dtype=torch.float32, device=scores.device)
    pair = mask_a[:, None, :, None] & mask_b[None, :, None, :]
    masked = torch.where(pair, scores, torch.finfo(torch.float32).min)
    s_a = masked.amax(3)                  # (A, B, TA): max over b-tokens
    s_b = masked.amax(2)                  # (A, B, TB): max over a-tokens

    def masked_mean(t, m, eps=1e-6):
        return torch.where(m, t, 0.0).sum(-1) / m.sum(-1).float().clamp(min=eps)

    return masked_mean(s_a, mask_a[:, None, :]), masked_mean(s_b, mask_b[None, :, :])


def filip_similarity_grouped(ha: torch.Tensor, hb: torch.Tensor, mask_a: torch.Tensor,
                             mask_b: torch.Tensor, temperature
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``include_group`` form: ha (M, B, TA, D), hb (N, B,
    TB, D), masks likewise; every (m, n) group pair scores on its own.
    Returns (sim_a, sim_b), each (M, N, B, B). Pairs score independently,
    so this is ``filip_similarity`` over the flattened groups, regrouped."""
    (M, B, TA, D), (N, B2, TB, _) = ha.shape, hb.shape
    sa, sb = filip_similarity(ha.reshape(M * B, TA, D), hb.reshape(N * B2, TB, D),
                              mask_a.reshape(M * B, TA), mask_b.reshape(N * B2, TB), temperature)

    def regroup(x):
        return x.reshape(M, B, N, B2).permute(0, 2, 1, 3)

    return regroup(sa), regroup(sb)


def token_max_similarity(ha: torch.Tensor, hb: torch.Tensor) -> torch.Tensor:
    """For aligned pair i, the mean over ha[i]'s tokens of the max dot
    product against hb[i]'s tokens, unmasked (the notebook prototype).
    Returns (B,)."""
    return torch.einsum("btd,bsd->bts", ha.float(), hb.float()).amax(-1).mean(-1)


def mean_average_similarity(ha: torch.Tensor, hb: torch.Tensor, mask_a: torch.Tensor,
                            mask_b: torch.Tensor, temperature) -> torch.Tensor:
    """The reference's unused mean-pooling variant: masked tokens summed
    and divided by T (not by the valid count), then dot products / t.
    Returns (A, B)."""
    pa = (ha * mask_a[..., None].to(ha.dtype)).mean(1)
    pb = (hb * mask_b[..., None].to(hb.dtype)).mean(1)
    return torch.einsum("ad,bd->ab", pa.float(), pb.float()) / temperature


def encode_batch_tokens(params: Params, esm_params: Params, batch: dict[str, torch.Tensor],
                        cfg: FILIPConfig, *, train: bool = False,
                        generator: torch.Generator | None = None, num_chunks: int = 1
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Both sides' normalised per-token embeddings (ha, hb) from a batch of
    ``{pep,rec}_{ids,mask}``. The frozen backbone runs with no graph in
    ``num_chunks`` microbatches (``gradcache.encode_hidden_chunked``), and
    its hidden states enter the heads in f32."""
    hidden = [encode_hidden_chunked(esm_params, batch[f"{side}_ids"], batch[f"{side}_mask"],
                                    cfg.esm, num_chunks).float() for side in ("pep", "rec")]
    return tuple(encode_side_tokens(params, side, h, cfg, train=train, generator=generator)
                 for side, h in zip(("pep", "rec"), hidden))


def forward(params: Params, esm_params: Params, batch: dict[str, torch.Tensor],
            cfg: FILIPConfig, *, train: bool = False,
            generator: torch.Generator | None = None, similarity_fn=None,
            num_chunks: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """The FILIP forward -> (sim_a, sim_b), each (B, B). ``similarity_fn``
    defaults to ``ops.filip.filip_similarity_fused`` (the kernel K4 on CUDA
    tensors, its plain version on CPU tensors)."""
    ha, hb = encode_batch_tokens(params, esm_params, batch, cfg, train=train,
                                 generator=generator, num_chunks=num_chunks)
    return (similarity_fn or filip_similarity_fused)(ha, hb, batch["pep_mask"],
                                                     batch["rec_mask"], params["temperature"])
