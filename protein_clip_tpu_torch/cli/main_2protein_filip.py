"""FILIP training on protein-protein pairs (the port of
``protein_clip_tpu.cli.main_2protein_filip``).

    python -m protein_clip_tpu_torch.cli.main_2protein_filip --synthetic-fixture \\
        --data-dir d2 --epochs 1 [--use-dcl] [--packed [--scatter-tiers 4]
        | --packed --pack-tiers 4] [--finetune | --lora-rank 8] [--device cpu]

The reference recipe: token-level late interaction over the frozen ESM-2
t30 backbone, batch 10, 10 epochs, no GradCache, one pad bucket; an ingest
filter of length <= 2000. The masked max-sim kernel K4 scores every train
and eval batch on the card, forward and (through its plain backward)
backward, so the batch can grow past 10: raise --num-chunks and
--length-groups with it (e.g. --batch-size 128 --num-chunks 8
--length-groups 4), or pack the rows with --packed (train/filip_packed.py:
flat packing, the tokens scattered into per-length-tier buffers, 4 tiers
by default, whose rectangular K4 blocks make up the scores; with
--pack-tiers N the rows themselves come in up to N widths, and each (pep
pack, rec pack) pair is one K4 block).

--finetune (an f32 master backbone at --backbone-lr) and --lora-rank R
(adapters on the frozen base) train the backbone too, through the
token-level two-pass step (train/filip_finetune.py, train/filip_lora.py:
remat and the attention backward K5 on the card), on one pad bucket or
with --packed.

The run writes the CSV, ``metrics.jsonl`` and ``best_model.npz``: the
FILIP heads and temperature (the CLIP heads' tree, which
``embed``/``serve``/``retrieve``/``topk --filip`` read), beside the
finetuned backbone or the adapters as the CLIP unfrozen modes save them;
a train-state snapshot after every epoch (``--resume-dir <run dir>``
continues from it), and the figures of ``cli/_clip_runner.py`` with the
direction-averaged FILIP similarity as the heatmaps. Runs on cuda unless
--device cpu.

With --dp N > 1 every mode trains on N ranks (``parallel/engine.py``:
each rank scores its rows against the gathered receptor tokens), one pad
bucket or flat-packed; --scatter-tiers and --length-groups are ignored
there, and a --batch-size the data axis does not divide exits. --tp N
shards the backbone over N ranks the Megatron way (every unpacked mode,
alone or with --dp; K4 scores the tokens, which the model ranks share);
--packed with --tp raises, as in the TPU package.

Not ported yet, raising ``NotImplementedError`` before anything loads:
--pp. Refused as in the TPU package: --finetune or --lora-rank with
--packed --pack-tiers, or with --length-groups; and, where the TPU package
fails, --esm-dtype int8 with an unfrozen mode.
"""

from __future__ import annotations

import argparse

import torch

from . import common
from ._clip_runner import (check_mesh, eval_view, figure_hooks, full_backbone, mesh_engine_of,
                           run_dir_of)
from ..data.dataset import PairLoader, generate_datasets
from ..data.prefetch import to_device
from ..models import filip
from ..parallel import distributed
from ..train import clip_engine, filip_engine, filip_finetune, filip_lora, loop, packed_engine
from ..utils import prng
from ..utils.device import resolve_device
from ..viz import plots


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    common.add_common_args(p)
    common.add_train_args(p)
    common.add_mesh_args(p)
    p.set_defaults(batch_size=10, num_chunks=1, length_groups=1)
    p.add_argument("--scatter-tiers", type=int, default=4,
                   help="with --packed: per-length-tier token buffers for the max-sim, "
                        "scored in tier-pair blocks (1: one buffer at the row width)")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--max-sequence-length", type=int, default=2000)
    p.add_argument("--use-dcl", action="store_true",
                   help="diagonal-masked denominator (decoupled contrastive loss; off in the "
                        "reference)")
    return p


def filip_similarity_viz(params, esm_params, mcfg, tokenizer, device):
    """(peps, recs) -> the direction-averaged similarity matrix (sim_a +
    sim_b) / 2 of one batch, in eval mode, for the heatmaps."""

    @torch.inference_mode()
    def compute(peps, recs):
        batch = clip_engine.expand_batch(
            to_device(clip_engine.tokenize_pair_batch(tokenizer, peps, recs), device))
        sim_a, sim_b = filip.forward(params, esm_params, batch, mcfg, train=False)
        return ((sim_a + sim_b) / 2.0).cpu().numpy()

    return compute


def check_filip_args(args) -> None:
    """The TPU package's mutual exclusions (SystemExit), then the options
    this port does not run yet or refuses (``common.check_train_args``:
    NotImplementedError for --pp, and int8 with an unfrozen mode), before
    anything is loaded."""
    if args.finetune and args.lora_rank:
        raise SystemExit("--finetune and --lora-rank are mutually exclusive "
                         "(full vs parameter-efficient)")
    if (args.finetune or args.lora_rank) and args.length_groups > 1:
        raise SystemExit("FILIP --finetune/--lora-rank train on plain or --packed batches "
                         "(drop --length-groups)")
    if (args.finetune or args.lora_rank) and args.packed and args.pack_tiers > 1:
        raise SystemExit("packed FILIP --finetune/--lora-rank supports flat packing only "
                         "(drop --pack-tiers; --scatter-tiers compose)")
    common.check_train_args(args)


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    common.maybe_init_distributed(args)
    return run_filip_training(args)


def run_filip_training(args) -> int:
    check_filip_args(args)
    check_mesh(args)
    launched = common.launch(args, run_filip_training)
    if launched is not None:
        return launched
    esm_cfg = common.esm_config(args.esm_config, args.esm_dtype, fast_gelu=args.fast_gelu,
                                exact_gelu=args.exact_gelu)
    mesh_engine = mesh_engine_of(args, arch="filip", packed=args.packed, ignored={
        "--length-groups": args.length_groups,
        "--scatter-tiers": args.scatter_tiers if args.packed else 1}, esm=esm_cfg)
    packed_engine.clear_tier_width_cache()      # a run packs from its own first batch
    device = resolve_device(args.device)
    generator = prng.set_seed(args.seed)
    run_dir = run_dir_of(args)

    esm_params = common.load_esm(args, esm_cfg, device)
    tokenizer = common.make_tokenizer()
    mcfg = filip.FILIPConfig(input_dim=esm_cfg.hidden_size, embedding_dim=args.embedding_dim,
                             h1=args.h1, h2=args.h2, dropout=args.dropout,
                             activation=args.activation, esm=esm_cfg)
    params = filip.init_params(mcfg, generator, device=device)
    params, esm_params, engine = common.unfrozen_params(
        args, params, esm_params, device, finetune_engine=filip_finetune,
        lora_engine=filip_lora, frozen_engine=filip_engine)
    view = eval_view(args, mcfg)

    def similarity(p, esm=None):
        esm = full_backbone(mesh_engine, esm_params) if esm is None else esm
        return filip_similarity_viz(*view(p, esm), mcfg, tokenizer, device)

    data_dir = common.primary_first(common.ensure_data, args, "protein1", "protein2")
    train_ds, val_ds, test_ds = common.primary_first(
        generate_datasets, data_dir, "protein1", "protein2", seed=args.seed,
        max_sequence_length=args.max_sequence_length)
    train_loader = PairLoader(train_ds, args.batch_size, shuffle=True, drop_last=True,
                              seed=args.seed)
    val_loader = PairLoader(val_ds, args.batch_size, shuffle=False, drop_last=True,
                            seed=args.seed)
    test_loader = PairLoader(test_ds, args.batch_size, shuffle=False, drop_last=True,
                             seed=args.seed)
    if distributed.is_primary():
        plots.plot_clustering(run_dir, data_dir, prefix="protein2")
        plots.plot_protein_lengths(run_dir, data_dir)
        plots.plot_embedding_cosine_similarities(run_dir, "Raw Embedding Cosine Similarities",
                                                 train_loader, tokenizer,
                                                 similarity(params, esm_params))
    if mesh_engine:
        # a rank keeps only its slices of the backbone from here on
        params, esm_params = mesh_engine.prepare_params(params), mesh_engine.prepare_esm(esm_params)

    cfg = clip_engine.EngineConfig(
        model=mcfg, batch_size=args.batch_size, accumulated_batches=1, learning_rate=args.lr,
        num_chunks=args.num_chunks, length_groups=1 if mesh_engine else args.length_groups,
        packed=args.packed, packed_tiers=args.pack_tiers,
        scatter_tiers=1 if mesh_engine else args.scatter_tiers,
        filip_use_dcl=args.use_dcl, backbone_lr=args.backbone_lr,
        weight_decay=args.weight_decay, warmup_steps=args.warmup_steps,
        lr_schedule=args.lr_schedule, grad_clip=args.grad_clip,
        total_steps=args.epochs * len(train_loader))
    epoch_hook, finish = figure_hooks(args, run_dir, train_loader, val_loader, tokenizer,
                                      similarity)
    result = loop.fit(run_dir, cfg, params, esm_params, train_loader, val_loader, tokenizer,
                      args.epochs, seed=args.seed, device=device, use_gradcache=False,
                      test_loader=test_loader, epoch_hook=epoch_hook,
                      resume=args.resume_dir is not None, engine=mesh_engine or engine)
    finish(result, args.batch_size)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
