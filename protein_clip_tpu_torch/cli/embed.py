"""Bulk sequence embedding: FASTA in, an npz index out.

    python -m protein_clip_tpu_torch.cli.embed --checkpoint best_model.npz \\
        --fasta proteins.fasta --side rec --out index.npz [--filip] [--device cpu]

The index is what ``cli.serve --index`` and ``cli.retrieve`` rank against:
``{ids, embeddings}`` pooled CLIP embeddings, or with ``--filip`` a ragged
token-level ``{ids, tokens (sum_L, D), lengths (N,)}`` for late-interaction
retrieval, rows length-sorted and trimmed to their true length. Sequences
are length-sorted and encoded in bucket-padded batches.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import common
from ..data.fasta import parse_fasta
from ..data.tokenizer import PAD_ID
from ..models import clip, esm2, filip
from ..utils import prng
from ..utils.device import resolve_device


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    common.add_common_args(p)
    p.add_argument("--checkpoint", required=True, help="best_model.npz from a training run")
    p.add_argument("--fasta", required=True)
    p.add_argument("--side", default="pep", choices=["pep", "rec"],
                   help="which trained encoder head to apply")
    p.add_argument("--out", required=True, help="output .npz path")
    p.add_argument("--raw-cosine", action="store_true",
                   help="strip the exp(t/2) scale so dot products are raw cosines")
    p.add_argument("--filip", action="store_true",
                   help="token-level index for a FILIP checkpoint: a ragged "
                        "{ids, tokens (sum_L, D), lengths (N,)} npz, length-sorted")
    return p


def _hidden_batches(esm_params, seqs, esm_cfg, tokenizer, device, batch_size: int,
                    pad_batch: bool):
    """Length-sorted batches through the backbone, so each batch pads to a
    short bucket: yields (input indices, f32 hidden states, int32 mask).

    pad_batch: round each batch's row count up to the next power of two
    (capped at batch_size) with empty-sequence filler rows, as the serving
    path does, so coalesced groups of any size take a small set of shapes.
    Filler rows are real (<cls>, <eos>) sequences, which callers slice off;
    all-pad rows would divide by a true length of 0 in token dropout.
    """
    order = sorted(range(len(seqs)), key=lambda i: len(seqs[i]))
    for start in range(0, len(order), batch_size):
        idx = order[start:start + batch_size]
        batch_seqs = [seqs[i] for i in idx]
        if pad_batch:
            n = 1
            while n < len(idx):
                n *= 2
            batch_seqs += [""] * (min(n, batch_size) - len(idx))
        enc = tokenizer(batch_seqs)
        ids = torch.from_numpy(enc["input_ids"]).to(device)
        mask = (ids != PAD_ID).to(torch.int32)
        yield idx, esm2.forward(esm_params, ids, mask, esm_cfg).float(), mask


def embed_sequences(params, esm_params, seqs, side, mcfg, tokenizer, device,
                    batch_size: int = 64, pad_batch: bool = False) -> np.ndarray:
    """Encode sequences -> (N, D) float32 pooled embeddings, in input order
    (``pad_batch`` as in ``_hidden_batches``)."""
    out = np.zeros((len(seqs), mcfg.embedding_dim), np.float32)
    with torch.inference_mode():
        for idx, hidden, mask in _hidden_batches(esm_params, seqs, mcfg.esm, tokenizer,
                                                 device, batch_size, pad_batch):
            emb = clip.encode_side(params, side, hidden, mask, mcfg)
            out[idx] = emb.cpu().numpy()[: len(idx)]
    return out


def embed_sequences_tokens(params, esm_params, seqs, side, fcfg, tokenizer, device,
                           batch_size: int = 64, pad_batch: bool = False
                           ) -> tuple[np.ndarray, np.ndarray]:
    """FILIP token-level encode -> (tokens (N, T, D) float32 L2-normalised,
    mask (N, T) int8), rows in input order and right-padded (zero tokens,
    zero mask) to T = the longest length bucket seen (``pad_batch`` as in
    ``_hidden_batches``)."""
    toks_by_idx: dict[int, np.ndarray] = {}
    mask_by_idx: dict[int, np.ndarray] = {}
    t_max = 0
    with torch.inference_mode():
        for idx, hidden, mask in _hidden_batches(esm_params, seqs, fcfg.esm, tokenizer,
                                                 device, batch_size, pad_batch):
            toks = filip.encode_side_tokens(params, side, hidden, fcfg).cpu().numpy()
            mask = mask.cpu().numpy().astype(np.int8)
            t_max = max(t_max, toks.shape[1])
            for row, i in enumerate(idx):
                toks_by_idx[i] = toks[row]
                mask_by_idx[i] = mask[row]
    out_t = np.zeros((len(seqs), t_max, fcfg.embedding_dim), np.float32)
    out_m = np.zeros((len(seqs), t_max), np.int8)
    for i, toks in toks_by_idx.items():
        out_t[i, :toks.shape[0]] = toks
        out_m[i, :toks.shape[0]] = mask_by_idx[i]
    return out_t, out_m


def embed_sequences_tokens_ragged(params, esm_params, seqs, side, fcfg, tokenizer, device,
                                  batch_size: int = 64) -> tuple[np.ndarray, np.ndarray]:
    """FILIP token-level encode, ragged -> (flat (sum_L, D) float32, lengths
    (N,) int32): each row trimmed to its true token length, rows
    concatenated in input order. This is the bulk-index form: its host
    memory is the data's size, where the dense form pads every row to the
    longest."""
    rows: list[np.ndarray] = [np.zeros((0, fcfg.embedding_dim), np.float32)] * len(seqs)
    lengths = np.zeros(len(seqs), np.int32)
    with torch.inference_mode():
        for idx, hidden, mask in _hidden_batches(esm_params, seqs, fcfg.esm, tokenizer,
                                                 device, batch_size, False):
            toks = filip.encode_side_tokens(params, side, hidden, fcfg).cpu().numpy()
            true_lens = mask.sum(1).cpu().numpy()
            for row, i in enumerate(idx):
                rows[i] = toks[row, :true_lens[row]]
                lengths[i] = true_lens[row]
    flat = (np.concatenate(rows, axis=0) if rows
            else np.zeros((0, fcfg.embedding_dim), np.float32))
    return flat, lengths


def filip_config(mcfg: clip.CLIPConfig) -> filip.FILIPConfig:
    """The FILIP config of the same heads and backbone (the head trees are
    the same)."""
    return filip.FILIPConfig(input_dim=mcfg.input_dim, embedding_dim=mcfg.embedding_dim,
                             h1=mcfg.h1, h2=mcfg.h2, dropout=mcfg.dropout,
                             activation=mcfg.activation, esm=mcfg.esm)


def load_model(args) -> tuple[clip.CLIPConfig, dict, dict, torch.device]:
    """(config, head params, backbone params, device) from the CLI args."""
    device = resolve_device(args.device)
    esm_cfg = common.esm_config(args.esm_config, args.esm_dtype,
                                fast_gelu=args.fast_gelu, exact_gelu=args.exact_gelu)
    esm_params = common.load_esm(args, esm_cfg, device)
    mcfg = clip.CLIPConfig(input_dim=esm_cfg.hidden_size, embedding_dim=args.embedding_dim,
                           h1=args.h1, h2=args.h2, dropout=args.dropout,
                           activation=args.activation, esm=esm_cfg)
    params, esm_params = common.load_clip_checkpoint(args.checkpoint, mcfg, esm_params,
                                                     device)
    return mcfg, params, esm_params, device


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    prng.set_seed(args.seed)
    mcfg, params, esm_params, device = load_model(args)
    records = parse_fasta(args.fasta)
    ids = [r[0] for r in records]
    seqs = [r[1] for r in records]
    if args.filip:
        # rows stored length-sorted, so the scorer's densified column blocks
        # stay tight
        order = sorted(range(len(seqs)), key=lambda i: len(seqs[i]))
        ids = [ids[i] for i in order]
        seqs = [seqs[i] for i in order]
        flat, lengths = embed_sequences_tokens_ragged(
            params, esm_params, seqs, args.side, filip_config(mcfg), common.make_tokenizer(),
            device, batch_size=args.batch_size)
        np.savez(args.out, ids=np.asarray(ids), tokens=flat, lengths=lengths)
        print(f"wrote {len(ids)} ragged token embeddings "
              f"({flat.shape[0]} x {flat.shape[1]} total) to {args.out}")
        return 0
    emb = embed_sequences(params, esm_params, seqs, args.side, mcfg,
                          common.make_tokenizer(), device, batch_size=args.batch_size)
    if args.raw_cosine:
        emb = emb / np.exp(float(params["temperature"]) / 2.0)
    np.savez(args.out, ids=np.asarray(ids), embeddings=emb)
    print(f"wrote {len(ids)} x {emb.shape[1]} embeddings to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
