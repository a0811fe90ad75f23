"""Offline retrieval: a query FASTA against an index built by ``cli.embed``.

    python -m protein_clip_tpu_torch.cli.embed --checkpoint best_model.npz \\
        --fasta receptors.fasta --side rec --out index.npz [--filip]
    python -m protein_clip_tpu_torch.cli.retrieve --checkpoint best_model.npz \\
        --index index.npz --queries peptides.fasta --side pep --k 10 \\
        --out hits.tsv [--filip] [--device cpu]

Only the queries are encoded. Output TSV:
``query_id<TAB>rank<TAB>hit_id<TAB>score``. CLIP scores are the scaled dot
products the training loss ranks by (pass --raw-cosine at both embed and
retrieve time for raw cosines). With ``--filip`` the index is ``embed
--filip``'s token-level one and the scores are direction-averaged FILIP
max-sim through the masked max-sim kernel (``ops/filip.py``); --raw-cosine
then multiplies the temperature back out.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from . import common
from .embed import embed_sequences, embed_sequences_tokens, filip_config, load_model
from ..data.fasta import parse_fasta
from ..eval.embed import nearest_partners
from ..eval.retrieval import filip_score_matrix, filip_score_matrix_ragged
from ..ops.filip import clamped_temperature
from ..utils import prng


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    common.add_common_args(p)
    p.add_argument("--checkpoint", required=True, help="best_model.npz from a training run")
    p.add_argument("--index", required=True,
                   help="npz from cli.embed ({ids, embeddings}, or with --filip "
                        "{ids, tokens, lengths})")
    p.add_argument("--queries", required=True, help="query FASTA")
    p.add_argument("--side", default="pep", choices=["pep", "rec"],
                   help="which trained head encodes the QUERIES (the index should hold "
                        "the other side)")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--out", default="-", help="output TSV path ('-' = stdout)")
    p.add_argument("--raw-cosine", action="store_true",
                   help="strip the exp(t/2) scale from query embeddings (match an index "
                        "built with --raw-cosine); with --filip, multiply the "
                        "temperature back out so scores are raw mean-max cosines")
    p.add_argument("--filip", action="store_true",
                   help="late-interaction retrieval against a token-level index from "
                        "`embed --filip`")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    prng.set_seed(args.seed)
    mcfg, params, esm_params, device = load_model(args)
    records = parse_fasta(args.queries)
    qids = [r[0] for r in records]
    seqs = [r[1] for r in records]
    with np.load(args.index, allow_pickle=False) as index:
        corpus_ids = [str(i) for i in index["ids"]]
        k = min(args.k, len(corpus_ids))
        if args.filip:
            tokens, lengths, mask = common.read_token_index(index, mcfg.embedding_dim)
            q_t, q_m = embed_sequences_tokens(params, esm_params, seqs, args.side,
                                              filip_config(mcfg), common.make_tokenizer(),
                                              device, batch_size=args.batch_size)
            t = params["temperature"]
            if lengths is not None:
                sim = filip_score_matrix_ragged(q_t, q_m, tokens, lengths, t, device=device)
            else:
                sim = filip_score_matrix(q_t, q_m, tokens, mask, t, device=device)
            if args.raw_cosine:
                # the same clamped scalar the scorer divided by
                sim = sim * clamped_temperature(t)
            idx = np.argsort(-sim, axis=1)[:, :k]
            scores = np.take_along_axis(sim, idx, axis=1)
        else:
            corpus = np.asarray(index["embeddings"], np.float32)
            if corpus.shape[1] != mcfg.embedding_dim:
                raise ValueError(f"index embedding dim {corpus.shape[1]} != model "
                                 f"--embedding-dim {mcfg.embedding_dim}")
            qemb = embed_sequences(params, esm_params, seqs, args.side, mcfg,
                                   common.make_tokenizer(), device, batch_size=args.batch_size)
            if args.raw_cosine:
                qemb = qemb / np.exp(float(params["temperature"]) / 2.0)
            idx, scores = nearest_partners(qemb, corpus, k=k)

    out = sys.stdout if args.out == "-" else open(args.out, "w")
    try:
        out.write("query_id\trank\thit_id\tscore\n")
        for q, qid in enumerate(qids):
            for rank in range(k):
                out.write(f"{qid}\t{rank + 1}\t{corpus_ids[idx[q, rank]]}"
                          f"\t{scores[q, rank]:.6f}\n")
    finally:
        if out is not sys.stdout:
            out.close()
    if out is not sys.stdout:
        print(f"wrote top-{k} hits for {len(qids)} queries to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
