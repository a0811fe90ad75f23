"""FILIP training on protein-protein pairs (the port of
``protein_clip_tpu.cli.main_2protein_filip``).

    python -m protein_clip_tpu_torch.cli.main_2protein_filip --synthetic-fixture \\
        --data-dir d2 --epochs 1 [--use-dcl] [--device cpu]

The reference recipe: token-level late interaction over the frozen ESM-2
t30 backbone, batch 10, 10 epochs, no GradCache, one pad bucket; an ingest
filter of length <= 2000. The masked max-sim kernel K4 scores every train
and eval batch on the card, forward and (through its plain backward)
backward, so the batch can grow past 10: raise --num-chunks and
--length-groups with it (e.g. --batch-size 128 --num-chunks 8
--length-groups 4). The run writes the CSV, ``metrics.jsonl`` and
``best_model.npz`` of the FILIP heads and temperature (the CLIP heads'
tree, which ``embed``/``serve``/``retrieve --filip`` read). Runs on cuda
unless --device cpu.

Not ported yet, each raising ``NotImplementedError`` before anything
loads: --packed (packed FILIP and its --scatter-tiers), --finetune and
--lora-rank (FILIP's unfrozen modes), --resume-dir and a mesh. The figures
of the TPU package's run need matplotlib and are skipped.
"""

from __future__ import annotations

import argparse

from . import common
from ..data.dataset import PairLoader, generate_datasets
from ..models import filip
from ..train import clip_engine, filip_engine, loop
from ..utils import prng, rundir
from ..utils.device import resolve_device


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    common.add_common_args(p)
    common.add_train_args(p)
    common.add_mesh_args(p)
    p.set_defaults(batch_size=10, num_chunks=1, length_groups=1)
    p.add_argument("--scatter-tiers", type=int, default=4,
                   help="with --packed: per-length-tier token buffers for the max-sim "
                        "(packed FILIP is not ported yet)")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--max-sequence-length", type=int, default=2000)
    p.add_argument("--use-dcl", action="store_true",
                   help="diagonal-masked denominator (decoupled contrastive loss; off in the "
                        "reference)")
    p.add_argument("--epoch-figures", action="store_true",
                   help="per-epoch cosine heatmaps (figures are not ported: skipped)")
    return p


def check_filip_args(args) -> None:
    """The TPU package's mutual exclusions (SystemExit), then the options
    this port does not run yet (NotImplementedError; resume and a mesh
    through ``common.check_train_args``), before anything is loaded."""
    if args.finetune and args.lora_rank:
        raise SystemExit("--finetune and --lora-rank are mutually exclusive "
                         "(full vs parameter-efficient)")
    if (args.finetune or args.lora_rank) and args.length_groups > 1:
        raise SystemExit("FILIP --finetune/--lora-rank train on plain or --packed batches "
                         "(drop --length-groups)")
    if (args.finetune or args.lora_rank) and args.packed and args.pack_tiers > 1:
        raise SystemExit("packed FILIP --finetune/--lora-rank supports flat packing only "
                         "(drop --pack-tiers; --scatter-tiers compose)")
    refused = [
        (args.packed, "--packed: packed FILIP (train/filip_packed.py, --scatter-tiers; "
                      "ROADMAP queue 1: packed FILIP)"),
        (args.finetune, "--finetune: FILIP's unfrozen modes (ROADMAP queue 1: FILIP's "
                        "unfrozen modes)"),
        (bool(args.lora_rank), "--lora-rank: FILIP's unfrozen modes (ROADMAP queue 1: "
                               "FILIP's unfrozen modes)"),
    ]
    for hit, what in refused:
        if hit:
            raise NotImplementedError(f"not ported yet: {what}")
    common.check_train_args(args)


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    check_filip_args(args)
    device = resolve_device(args.device)
    generator = prng.set_seed(args.seed)
    run_dir = rundir.make_run_dir(args.runs_dir)
    print(f"All run info will be saved to {run_dir}")

    esm_cfg = common.esm_config(args.esm_config, args.esm_dtype, fast_gelu=args.fast_gelu,
                                exact_gelu=args.exact_gelu)
    esm_params = common.load_esm(args, esm_cfg, device)
    tokenizer = common.make_tokenizer()
    mcfg = filip.FILIPConfig(input_dim=esm_cfg.hidden_size, embedding_dim=args.embedding_dim,
                             h1=args.h1, h2=args.h2, dropout=args.dropout,
                             activation=args.activation, esm=esm_cfg)
    params = filip.init_params(mcfg, generator, device=device)

    data_dir = common.ensure_data(args, "protein1", "protein2")
    train_ds, val_ds, test_ds = generate_datasets(data_dir, "protein1", "protein2",
                                                  seed=args.seed,
                                                  max_sequence_length=args.max_sequence_length)
    train_loader = PairLoader(train_ds, args.batch_size, shuffle=True, drop_last=True,
                              seed=args.seed)
    val_loader = PairLoader(val_ds, args.batch_size, shuffle=False, drop_last=True,
                            seed=args.seed)
    test_loader = PairLoader(test_ds, args.batch_size, shuffle=False, drop_last=True,
                             seed=args.seed)
    print("[viz] figures skipped: viz/plots is not ported (ROADMAP queue 1)")

    cfg = clip_engine.EngineConfig(
        model=mcfg, batch_size=args.batch_size, accumulated_batches=1, learning_rate=args.lr,
        num_chunks=args.num_chunks, length_groups=args.length_groups,
        scatter_tiers=args.scatter_tiers, filip_use_dcl=args.use_dcl,
        weight_decay=args.weight_decay, warmup_steps=args.warmup_steps,
        lr_schedule=args.lr_schedule, grad_clip=args.grad_clip,
        total_steps=args.epochs * len(train_loader))
    loop.fit(run_dir, cfg, params, esm_params, train_loader, val_loader, tokenizer,
             args.epochs, seed=args.seed, device=device, use_gradcache=False,
             test_loader=test_loader, engine=filip_engine)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
