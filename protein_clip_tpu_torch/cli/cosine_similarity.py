"""Offline cosine-similarity eval (the port of
``protein_clip_tpu.cli.cosine_similarity``, the reference's
``cosine_similarity.py``).

    python -m protein_clip_tpu_torch.cli.cosine_similarity \\
        --checkpoint runs/<ts>/best_model.npz --data-dir d \\
        [--prefix-a peptide --prefix-b receptor] [--device cpu]

The raw cosine-similarity matrix of a train batch under CLIP heads
initialised from seed 0 (over the checkpoint's backbone where it brings
one), and the trained matrices of the checkpoint on the next train batch
and the first val batch: three heatmaps in a new run directory's
``figures/`` (drawn where matplotlib is installed), each matrix written
beside them as ``figure N.npy``. The checkpoint is any CLIP checkpoint the
port serves (heads, {heads, esm}, {heads, lora}). Runs on cuda unless
--device cpu.
"""

from __future__ import annotations

import argparse

import torch

from . import common
from ._clip_runner import similarity_fn
from ..data.dataset import PairLoader, generate_datasets
from ..models import clip
from ..utils import prng, rundir
from ..utils.device import resolve_device
from ..viz import plots


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    common.add_common_args(p)
    common.add_data_args(p)
    p.add_argument("--checkpoint", required=True, help="best_model.npz from a training run")
    p.add_argument("--prefix-a", default="protein1")
    p.add_argument("--prefix-b", default="protein2")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    prng.set_seed(args.seed)
    run_dir = rundir.make_run_dir(args.runs_dir)
    print(f"All run info will be saved to {run_dir}")

    esm_cfg = common.esm_config(args.esm_config, args.esm_dtype, fast_gelu=args.fast_gelu,
                                exact_gelu=args.exact_gelu)
    esm_params = common.load_esm(args, esm_cfg, device)
    tokenizer = common.make_tokenizer()
    mcfg = clip.CLIPConfig(input_dim=esm_cfg.hidden_size, embedding_dim=args.embedding_dim,
                           h1=args.h1, h2=args.h2, dropout=args.dropout,
                           activation=args.activation, esm=esm_cfg)
    raw_params = clip.init_params(mcfg, torch.Generator().manual_seed(0), device=device)
    # a finetuned or LoRA checkpoint brings its backbone, which the raw
    # heads run on too (as in the TPU package)
    best_params, esm_params = common.load_clip_checkpoint(args.checkpoint, mcfg, esm_params,
                                                          device)

    data_dir = common.ensure_data(args, args.prefix_a, args.prefix_b)
    train_ds, val_ds, _ = generate_datasets(data_dir, args.prefix_a, args.prefix_b,
                                            seed=args.seed)
    train_loader = PairLoader(train_ds, args.batch_size, shuffle=True, drop_last=True,
                              seed=args.seed)
    val_loader = PairLoader(val_ds, args.batch_size, shuffle=False, drop_last=True,
                            seed=args.seed)
    for title, loader, params in (
            ("Raw Embedding Cosine Similarities", train_loader, raw_params),
            ("Trained Embedding Cosine Similarities on Train Set", train_loader, best_params),
            ("Trained Embedding Cosine Similarities on Val Set", val_loader, best_params)):
        plots.plot_embedding_cosine_similarities(
            run_dir, title, loader, tokenizer,
            similarity_fn(params, esm_params, mcfg, tokenizer, device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
