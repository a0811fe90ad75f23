"""Bulk sequence embedding: FASTA in, an ``{ids, embeddings}`` npz index out.

    python -m protein_clip_tpu_torch.cli.embed --checkpoint best_model.npz \\
        --fasta proteins.fasta --side rec --out index.npz [--device cpu]

The index is what ``cli.serve --index`` ranks ``/topk`` against. Sequences
are length-sorted and encoded in bucket-padded batches; rows return in
input order.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import common
from ..data.fasta import parse_fasta
from ..data.tokenizer import PAD_ID
from ..models import clip, esm2
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
                   help="token-level FILIP index (not ported yet)")
    return p


def embed_sequences(params, esm_params, seqs, side, mcfg, tokenizer, device,
                    batch_size: int = 64, pad_batch: bool = False) -> np.ndarray:
    """Encode sequences -> (N, D) float32, length-sorted internally so each
    batch pads to a short bucket; results return in input order.

    pad_batch: round each batch's row count up to the next power of two
    (capped at batch_size) with empty-sequence filler rows, as the serving
    path does, so coalesced groups of any size take a small set of shapes.
    Filler rows are real (<cls>, <eos>) sequences, sliced off before
    returning; all-pad rows would divide by a true length of 0 in token
    dropout.
    """
    order = sorted(range(len(seqs)), key=lambda i: len(seqs[i]))
    out = np.zeros((len(seqs), mcfg.embedding_dim), np.float32)
    with torch.inference_mode():
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
            hidden = esm2.forward(esm_params, ids, mask, mcfg.esm)
            emb = clip.encode_side(params, side, hidden.float(), mask, mcfg)
            out[idx] = emb.cpu().numpy()[: len(idx)]
    return out


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
    if args.filip:
        raise NotImplementedError("embed --filip is not ported yet "
                                  "(ROADMAP queue 1: FILIP serving, kernel K4)")
    prng.set_seed(args.seed)
    mcfg, params, esm_params, device = load_model(args)
    records = parse_fasta(args.fasta)
    ids = [r[0] for r in records]
    seqs = [r[1] for r in records]
    emb = embed_sequences(params, esm_params, seqs, args.side, mcfg,
                          common.make_tokenizer(), device, batch_size=args.batch_size)
    if args.raw_cosine:
        emb = emb / np.exp(float(params["temperature"]) / 2.0)
    np.savez(args.out, ids=np.asarray(ids), embeddings=emb)
    print(f"wrote {len(ids)} x {emb.shape[1]} embeddings to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
