"""Top-k retrieval eval (the port of ``protein_clip_tpu.cli.topk``, the
reference's ``topk.py``).

    python -m protein_clip_tpu_torch.cli.topk --checkpoint runs/<ts>/best_model.npz \\
        --data-dir d --prefix-a peptide --prefix-b receptor [--split val] \\
        [--n-candidates 256] [--packed | --filip] [--device cpu]

The rank of each query's true partner among --n-candidates candidates of
the split, printed as the top-1 and top-10 accuracy and the mean rank, and
drawn as the cumulative top-k accuracy curve against the shuffled-random
baseline (``figures/figure N.png`` in a new run directory, where matplotlib
is installed). Each side is encoded once (``eval/retrieval.py``), padded
in --num-chunks backbone microbatches or, with --packed, packed; --filip
ranks a FILIP checkpoint by late interaction (the masked max-sim kernel
K4 on the card). The checkpoint is any the port serves: heads, a finetune
run's {heads, esm}, a LoRA run's {heads, lora}, or FILIP heads. The
backbone comes from --esm-config / --esm-weights as in training. Runs on
cuda unless --device cpu.
"""

from __future__ import annotations

import argparse

import numpy as np

from . import common
from ..data.dataset import PairLoader, generate_datasets
from ..eval.retrieval import evaluate_filip_retrieval, evaluate_retrieval
from ..models import clip, filip
from ..utils import prng, rundir
from ..utils.device import resolve_device
from ..viz import plots


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    common.add_common_args(p)
    common.add_data_args(p)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--n-candidates", type=int, default=256)
    p.add_argument("--filip", action="store_true",
                   help="late-interaction retrieval for a FILIP checkpoint (token-level "
                        "max-sim scores through the fused kernel)")
    p.add_argument("--packed", action="store_true",
                   help="sequence-packed candidate encoding (the same ranks, fewer pad "
                        "tokens)")
    p.add_argument("--prefix-a", default="protein1")
    p.add_argument("--prefix-b", default="protein2")
    p.add_argument("--split", default="val", choices=["train", "val", "test"])
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
    heads = dict(input_dim=esm_cfg.hidden_size, embedding_dim=args.embedding_dim, h1=args.h1,
                 h2=args.h2, dropout=args.dropout, activation=args.activation, esm=esm_cfg)
    mcfg = clip.CLIPConfig(**heads)
    params, esm_params = common.load_clip_checkpoint(args.checkpoint, mcfg, esm_params, device)

    data_dir = common.ensure_data(args, args.prefix_a, args.prefix_b)
    datasets = dict(zip(("train", "val", "test"),
                        generate_datasets(data_dir, args.prefix_a, args.prefix_b,
                                          seed=args.seed)))
    loader = PairLoader(datasets[args.split], args.batch_size, shuffle=False, drop_last=True,
                        seed=args.seed)
    if args.filip:
        result = evaluate_filip_retrieval(params, esm_params, loader, tokenizer,
                                          filip.FILIPConfig(**heads),
                                          n_candidates=args.n_candidates,
                                          num_chunks=args.num_chunks, device=device)
    else:
        result = evaluate_retrieval(params, esm_params, loader, tokenizer, mcfg,
                                    n_candidates=args.n_candidates, packed=args.packed,
                                    device=device)
    print(f"top-1 accuracy: {result.top1:.4f}")
    if args.n_candidates >= 10:
        print(f"top-10 accuracy: {result.accuracies[9]:.4f}")
    print(f"mean rank: {result.ranks.mean():.1f} / {args.n_candidates}")

    k_vals = np.linspace(0, args.n_candidates, args.n_candidates)

    def draw(plt):
        plt.figure(figsize=(6, 4))
        plt.plot(k_vals, result.accuracies, label="Model Top-k accuracy", color="blue")
        plt.plot(k_vals, result.random_accuracies, label="Random Top-k accuracy",
                 color="orange")
        plt.title("Top-k Val Accuracy")
        plt.ylabel("Accuracy")
        plt.xlabel("Top-k")
        plt.legend()

    path, drawn = plots.figure(run_dir, draw)
    if drawn:
        print(f"Top-k Val Accuracy plot saved to {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
