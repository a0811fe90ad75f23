"""The CLIP training run behind ``main.py`` and ``main_2protein.py``: the
port of ``protein_clip_tpu/cli/_clip_runner.run_clip_training`` on one
device, for the frozen backbone and the unfrozen modes (``--finetune``,
``--lora-rank``), which train on one pad bucket (``length_groups`` 1).

The figures of the TPU package's run (``viz/plots.py``: lengths, clusters,
cosine heatmaps, loss curves) need matplotlib and are not ported: the run
prints one line saying so and writes the CSV, ``metrics.jsonl`` and
``best_model.npz``.
"""

from __future__ import annotations

import torch

from . import common
from ..data.dataset import PairLoader, generate_datasets
from ..models import clip
from ..train import clip_engine, finetune, lora, loop
from ..utils import prng, rundir
from ..utils.device import resolve_device


def run_clip_training(args, *, prefix_a: str, prefix_b: str,
                      max_sequence_length: int | None = None) -> int:
    common.check_train_args(args)
    device = resolve_device(args.device)
    generator = prng.set_seed(args.seed)
    run_dir = rundir.make_run_dir(args.runs_dir)
    print(f"All run info will be saved to {run_dir}")

    esm_cfg = common.esm_config(args.esm_config, args.esm_dtype, fast_gelu=args.fast_gelu,
                                exact_gelu=args.exact_gelu)
    esm_params = common.load_esm(args, esm_cfg, device)
    tokenizer = common.make_tokenizer()
    mcfg = clip.CLIPConfig(input_dim=esm_cfg.hidden_size, embedding_dim=args.embedding_dim,
                           h1=args.h1, h2=args.h2, dropout=args.dropout,
                           activation=args.activation, esm=esm_cfg)
    params = clip.init_params(mcfg, generator, device=device)
    engine = None
    if args.finetune:
        # the backbone joins the trainable params as an f32 master copy; the
        # esm_params slot of the step is ignored
        params = finetune.init_params(esm_params, params)
        esm_params, engine = {}, finetune
    elif args.lora_rank:
        # esm_params stays: the frozen base the adapters merge into
        targets = lora.ATTN_TARGETS + (lora.FFN_TARGETS if args.lora_ffn else ())
        lora_gen = torch.Generator(device=device).manual_seed(args.seed + 1)
        params = lora.init_params(lora.init_lora(lora_gen, esm_params, args.lora_rank, targets),
                                  params)
        engine = lora
    unfrozen = engine is not None

    data_dir = common.ensure_data(args, prefix_a, prefix_b)
    train_ds, val_ds, test_ds = generate_datasets(data_dir, prefix_a, prefix_b, seed=args.seed,
                                                  max_sequence_length=max_sequence_length)
    train_loader = PairLoader(train_ds, args.batch_size, shuffle=True, drop_last=True,
                              seed=args.seed)
    val_loader = PairLoader(val_ds, args.batch_size, shuffle=False, drop_last=True,
                            seed=args.seed)
    test_loader = PairLoader(test_ds, args.batch_size, shuffle=False, drop_last=True,
                             seed=args.seed)
    print("[viz] figures skipped: viz/plots is not ported (ROADMAP queue 1)")

    steps_per_epoch = (len(train_loader) if args.no_gradcache
                       else len(train_loader) // args.accumulated_batches)
    cfg = clip_engine.EngineConfig(
        model=mcfg, batch_size=args.batch_size, accumulated_batches=args.accumulated_batches,
        learning_rate=args.lr, num_chunks=args.num_chunks,
        length_groups=1 if args.no_gradcache or unfrozen else args.length_groups,
        backbone_lr=args.backbone_lr, weight_decay=args.weight_decay,
        warmup_steps=args.warmup_steps, lr_schedule=args.lr_schedule, grad_clip=args.grad_clip,
        total_steps=args.epochs * steps_per_epoch)
    loop.fit(run_dir, cfg, params, esm_params, train_loader, val_loader, tokenizer,
             args.epochs, seed=args.seed, device=device, use_gradcache=not args.no_gradcache,
             test_loader=test_loader, engine=engine)
    return 0
