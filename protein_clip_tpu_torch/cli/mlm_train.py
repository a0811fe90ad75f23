"""MLM training (the port of ``protein_clip_tpu.cli.mlm_train``): the
masked-token objective over the shared ESM-2 stack, on one device or a
(data, model) mesh.

    python -m protein_clip_tpu_torch.cli.mlm_train --synthetic-fixture --data-dir d \\
        --epochs 1 [--side a|b|both] [--mask-prob 0.15] [--packed]
        [--finetune | --lora-rank 8 [--lora-ffn]] [--dp N] [--tp N] [--device cpu]

Trains the LM head (dense, gelu, LayerNorm, the decoder tied to the token
embedding; ``esm2.init_lm_head``) on token-level masking at --mask-prob
(``models/mlm.mask_tokens``, from a generator on the device seeded from
--seed + 2): over the frozen backbone by default; with --finetune the f32
master backbone trains too (cast to the compute dtype inside the graph, at
--backbone-lr, default 1e-5), and with --lora-rank adapters on the frozen
base (default 1e-4). The unfrozen steps are one value-and-grad over the
batch with per-layer rematerialisation: K1 forward, K5 backward on the
card. --packed packs the training side's sequences into rows
(``train/packed_engine.tokenize_packed_rows``): segment-masked attention,
RoPE restarts and per-segment token-dropout ratios, so the loss equals the
unpacked one. Each mode writes ``losses_per_epoch.txt`` (``Epoch,Train
Loss,Validation Loss``) and, at each better validation loss,
``best_model.npz``: the head, or {esm, head} / {lora, head}, the flat npz
both packages read.

--dp N and --tp N (and both: a (data, model) mesh of --dp x --tp ranks,
one a device, started by ``common.launch`` as the CLIP CLIs' ranks are, or
joined with --coordinator/--num-processes/--process-id or under torchrun)
run ``parallel/mlm_step.py``: each data index trains on its rows of the
batch (packed: its shard of ``tokenize_packed_rows_sharded``), with masks
from the step's generator and the data index, the loss the mean over every
shard's masked positions and the gradients averaged over the data axis;
the model axis shards the backbone (and the --finetune masters) the
Megatron way. Every mode composes with the mesh; int8 trains the head only,
as on one device. Rank 0 writes the run, ``best_model.npz`` in the
one-device layout.

Refused, where the TPU package fails or ignores the flag: --esm-dtype int8
with --finetune or --lora-rank (the int8 tree has no weights to train);
--resume-dir (the TPU package's MLM run keeps no train state) and
--pack-tiers > 1 (MLM packs one width, as the TPU package's does).
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from . import common
from ._clip_runner import run_dir_of
from ..data.dataset import PairLoader, generate_datasets
from ..data.prefetch import prefetch_to_device
from ..models import esm2, mlm
from ..parallel import distributed, mlm_step, sharding
from ..parallel.mesh import check_model_axis, make_mesh
from ..parallel.step import tp_model_config
from ..train import checkpoint, finetune, lora, optimizer as opt_mod
from ..train.mlm_engine import make_steps
from ..train.packed_engine import (derive_segments, tokenize_packed_rows,
                                   tokenize_packed_rows_sharded)
from ..utils import prng
from ..utils.device import resolve_device


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    common.add_common_args(p)
    common.add_train_args(p)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--mask-prob", type=float, default=0.15)
    p.add_argument("--prefix-a", default="peptide")
    p.add_argument("--prefix-b", default="receptor")
    p.add_argument("--side", default="b", choices=["a", "b", "both"],
                   help="which side's sequences to train on")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel ranks, one a device (parallel/mlm_step.py): the batch "
                        "shards over the 'data' axis, the loss is the mean over every shard's "
                        "masked positions and the gradients are averaged; composes with "
                        "--packed (rows dealt per shard), --finetune, --lora-rank and --tp")
    common.add_tp_arg(p)
    common.add_launch_args(p)
    return p


def check_mlm_args(args) -> None:
    """The TPU package's exclusion (SystemExit), the refusals the module
    docstring names, and the mesh, before anything is loaded."""
    if args.finetune and args.lora_rank:
        raise SystemExit("--finetune and --lora-rank are mutually exclusive")
    if args.esm_dtype == "int8" and (args.finetune or args.lora_rank):
        raise NotImplementedError(
            f"{'--finetune' if args.finetune else '--lora-rank'} with --esm-dtype int8: the "
            "unfrozen MLM modes train a bf16 or f32 backbone, and the int8 tree has no weights "
            "to train (the TPU package fails on it); train with --esm-dtype bfloat16")
    if args.resume_dir is not None:
        raise SystemExit("cli.mlm_train keeps no train state to resume from (nor does the TPU "
                         "package's); drop --resume-dir")
    if args.pack_tiers > 1:
        raise SystemExit("cli.mlm_train packs its rows at one width (tokenize_packed_rows); "
                         "drop --pack-tiers")
    if args.dp < 1:
        raise SystemExit(f"--dp {args.dp}: cli.mlm_train takes a positive data axis")
    seqs = args.batch_size * (2 if args.side == "both" else 1)
    if not args.packed and seqs % args.dp:
        raise SystemExit(f"the {seqs} sequences a batch holds must be divisible by --dp "
                         f"{args.dp} (batches shard over the data axis)")
    check_model_axis(common.esm_config(args.esm_config, args.esm_dtype), args.tp)


def batch_inputs(arrs: tuple, packed: bool) -> dict:
    """(ids, mask, seg, pos) of a batch on its device: plain (ids, mask), or
    the packed wire's int8 rows with their segments and positions."""
    if packed:
        ids, seg, pos = derive_segments(arrs[0])
        return {"ids": ids, "mask": (seg > 0).to(torch.int32), "seg": seg, "pos": pos}
    ids, mask = arrs
    return {"ids": ids.to(torch.int32), "mask": mask.to(torch.int32), "seg": None, "pos": None}


def draw_masks(generator: torch.Generator, inputs: dict, p: float) -> tuple:
    """(masked ids, labels) of a batch's inputs (``mlm.mask_tokens``)."""
    return mlm.mask_tokens(generator, inputs["ids"], inputs["mask"], p)


def trainable_tree(args, mode: str, lm_head: dict, esm_params: dict,
                   cfg: esm2.ESM2Config, device) -> tuple:
    """(trainable tree, view, the optimizer groups' tree name): the head
    alone; an f32 master copy of the backbone beside it (cast to the
    compute dtype inside the graph); or LoRA adapters (from a generator
    seeded --seed + 1) merged into the frozen base (a rank's slices of it
    where ``cfg`` has a model axis)."""
    if mode == "finetune":
        return ({"esm": finetune.init_params(esm_params, {})["esm"], "head": lm_head},
                lambda t, _: finetune._cast_esm(t["esm"], cfg.compute_dtype), "esm")
    if mode == "lora":
        targets = lora.ATTN_TARGETS + (lora.FFN_TARGETS if args.lora_ffn else ())
        gen = torch.Generator(device=device).manual_seed(args.seed + 1)
        alpha = lora.default_alpha(args.lora_rank)
        return ({"lora": lora.init_lora(gen, esm_params, args.lora_rank, targets),
                 "head": lm_head},
                lambda t, e: lora.merge_lora(e, t["lora"], alpha, cfg.model_axis), "lora")
    return lm_head, None, None


def make_optimizer(args, mode: str, group: str | None, total_steps: int):
    """Adam (AdamW under --weight-decay) at --lr with the schedule flags over
    ``total_steps``; in the unfrozen modes a second group for the backbone
    or adapters at --backbone-lr (default 1e-5 finetune, 1e-4 LoRA), and
    --grad-clip by the whole tree's norm."""
    kw = dict(weight_decay=args.weight_decay, warmup_steps=args.warmup_steps,
              schedule=args.lr_schedule, total_steps=total_steps)
    if mode == "head":
        return opt_mod.build(args.lr, grad_clip=args.grad_clip, **kw)
    bb_lr = args.backbone_lr or (1e-4 if mode == "lora" else 1e-5)
    return opt_mod.multi_transform({group: opt_mod.build(bb_lr, **kw),
                                    "head": opt_mod.build(args.lr, **kw)},
                                   grad_clip=args.grad_clip)


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    common.maybe_init_distributed(args)
    return run_mlm_training(args)


def run_mlm_training(args) -> int:
    check_mlm_args(args)
    launched = common.launch(args, run_mlm_training)
    if launched is not None:
        return launched
    device = resolve_device(args.device)
    generator = prng.set_seed(args.seed)
    run_dir = run_dir_of(args)
    primary = distributed.is_primary()

    esm_cfg = common.esm_config(args.esm_config, args.esm_dtype, fast_gelu=args.fast_gelu,
                                exact_gelu=args.exact_gelu)
    mesh = (make_mesh(data=args.dp, model=args.tp, esm_cfg=esm_cfg)
            if common.mesh_size(args) > 1 else None)
    esm_params = common.load_esm(args, esm_cfg, device)
    tokenizer = common.make_tokenizer()
    lm_head = esm2.init_lm_head(esm_cfg, generator, device=device)

    data_dir = common.primary_first(common.ensure_data, args, args.prefix_a, args.prefix_b)
    train_ds, val_ds, _ = common.primary_first(generate_datasets, data_dir, args.prefix_a,
                                               args.prefix_b, seed=args.seed)
    train_loader = PairLoader(train_ds, args.batch_size, shuffle=True, drop_last=True,
                              seed=args.seed)
    val_loader = PairLoader(val_ds, args.batch_size, shuffle=False, drop_last=True,
                            seed=args.seed)

    mode = "finetune" if args.finetune else "lora" if args.lora_rank else "head"
    step_cfg = esm_cfg if mesh is None else tp_model_config(esm_cfg, mesh)
    trainable, view, group = trainable_tree(args, mode, lm_head, esm_params, step_cfg, device)
    if mode == "finetune":
        esm_params = {}      # the masters carry the backbone
    if mesh is not None:
        # a rank keeps only its slices of the backbone (or the masters)
        trainable = sharding.shard_params(mesh, trainable)
        esm_params = sharding.shard_params(mesh, esm_params)
        if primary:
            print(f"[mesh] MLM training over {mesh.shape} on "
                  f"{distributed.backend_for(args.device)} ranks")
    opt_state = make_optimizer(args, mode, group, len(train_loader) * args.epochs).init(trainable)
    if mesh is None:
        train_step, eval_step = make_steps(esm_cfg, mode, view)
        masks_of = draw_masks
        export = lambda tree: tree  # noqa: E731
    else:
        train_step, eval_step = mlm_step.make_sharded_mlm_steps(esm_cfg, mesh, mode, view)
        masks_of = lambda gen, inputs, p: mlm_step.rank_masks(gen, inputs, p, mesh)  # noqa
        export = lambda tree: sharding.gather_params(mesh, tree)  # noqa: E731
    mask_gen = torch.Generator(device=device).manual_seed(args.seed + 2)

    def prepare(batch):
        a, b = batch
        seqs = {"a": list(a), "b": list(b), "both": list(a) + list(b)}[args.side]
        if args.packed:
            arrs = ((tokenize_packed_rows(tokenizer, seqs),) if mesh is None else
                    (tokenize_packed_rows_sharded(tokenizer, seqs, mesh.data),))
        else:
            enc = tokenizer(seqs)
            arrs = (torch.from_numpy(enc["input_ids"]), torch.from_numpy(enc["attention_mask"]))
        return arrs if mesh is None else mlm_step.rank_rows(arrs, mesh)

    losses_path = run_dir / "losses_per_epoch.txt"
    best_val = float("inf")
    with open(losses_path if primary else os.devnull, "w") as f:
        f.write("Epoch,Train Loss,Validation Loss\n")
        for epoch in range(args.epochs):
            t0 = time.perf_counter()
            train = []
            for arrs in prefetch_to_device(train_loader, prepare, device):
                inputs = batch_inputs(arrs, args.packed)
                trainable, opt_state, loss = train_step(
                    trainable, opt_state, esm_params, inputs,
                    masks_of(mask_gen, inputs, args.mask_prob))
                train.append(loss)
            val = []
            for arrs in prefetch_to_device(val_loader, prepare, device):
                inputs = batch_inputs(arrs, args.packed)
                val.append(eval_step(trainable, esm_params, inputs,
                                     masks_of(mask_gen, inputs, args.mask_prob)))
            # the losses stay on the device until the epoch's end
            tl = sum(map(float, train)) / max(len(train), 1)
            vl = sum(map(float, val)) / len(val) if val else float("nan")
            f.write(f"{epoch + 1},{tl:.4f},{vl:.4f}\n")
            f.flush()
            if vl < best_val:
                best_val = vl
                full = export(trainable)
                if primary:
                    checkpoint.export_npz(run_dir / "best_model.npz", full)
                del full
            if primary:
                print(f"Epoch {epoch + 1}/{args.epochs} - Train Loss: {tl:.4f}, "
                      f"Val Loss: {vl:.4f} ({time.perf_counter() - t0:.1f}s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
