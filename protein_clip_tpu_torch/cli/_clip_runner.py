"""The CLIP training run behind ``main.py`` and ``main_2protein.py``: the
port of ``protein_clip_tpu/cli/_clip_runner.run_clip_training``, for the
frozen backbone (length-grouped, or packed with ``--packed``, flat or in
``--pack-tiers`` widths) and the unfrozen modes (``--finetune``,
``--lora-rank``), which train on one pad bucket (``length_groups`` 1) or
flat-packed. With ``--dp N`` or ``--tp N`` > 1 it trains on the ranks of
the (data, model) mesh (``parallel/engine.MeshEngine``, started by
``common.launch``): one pad bucket, or flat-packed on the data axis alone,
with the TPU package's refusals: ``--no-gradcache``, a ``--batch-size`` the
data axis does not divide and ``--pack-tiers`` exit, ``--packed`` with
``--tp`` raises, and ``--length-groups`` is ignored. Under ``--tp`` a rank
holds its Megatron slices of the backbone (or of the finetune masters);
the run's files are written in the one-device layout.

The run writes the CSV, ``metrics.jsonl``, ``best_model.npz``, a
train-state snapshot after every epoch (``state/``; ``--resume-dir <run
dir>`` continues from it) and the TPU package's figures (``viz/plots.py``:
the cluster sizes for ``main_2protein``, the lengths, the raw cosine
heatmap, per epoch with ``--epoch-figures``, the loss curves and the
trained heatmaps), drawn where matplotlib is installed; the heatmaps'
matrices are written as ``figures/figure N.npy`` either way.
"""

from __future__ import annotations

import functools
from pathlib import Path

import torch

from . import common
from ..data.dataset import PairLoader, generate_datasets
from ..data.prefetch import to_device
from ..models import clip, esm2
from ..parallel import distributed
from ..parallel.engine import PACKED_TP, MeshEngine
from ..parallel.mesh import check_model_axis
from ..train import clip_engine, finetune, lora, loop, packed_engine
from ..utils import prng, rundir
from ..utils.device import resolve_device
from ..viz import plots


def similarity_fn(params, esm_params, mcfg, tokenizer, device):
    """(peps, recs) -> the raw cosine matrix (logits de-scaled by
    exp(-temperature)) of one batch, in eval mode, for the heatmaps."""

    @torch.inference_mode()
    def compute(peps, recs):
        batch = clip_engine.expand_batch(
            to_device(clip_engine.tokenize_pair_batch(tokenizer, peps, recs), device))
        pep, rec = clip.forward(params, esm_params, batch, mcfg, train=False)
        return clip.cosine_similarity_matrix(pep, rec, params["temperature"]).cpu().numpy()

    return compute


def eval_view(args, mcfg):
    """(params, esm_params) -> (head params, backbone params) for the
    heatmaps, from any mode's trainable tree in the one-device layout: a
    finetune master backbone cast to the compute dtype; LoRA adapters merged
    into the frozen base ``esm_params``."""

    @torch.inference_mode()
    def view(params, esm_params):
        if args.finetune:
            return params["heads"], esm2.cast_params(params["esm"], mcfg.esm.compute_dtype)
        if args.lora_rank:
            return params["heads"], lora.merge_lora(esm_params, params["lora"],
                                                    lora.default_alpha(args.lora_rank))
        return params, esm_params

    return view


def full_backbone(mesh_engine, esm_params: dict) -> dict:
    """The frozen backbone in the one-device layout for the heatmaps:
    gathered over the model group on a mesh (collective), else itself."""
    return mesh_engine.export_esm(esm_params) if mesh_engine else esm_params


def figure_hooks(args, run_dir: Path, train_loader, val_loader, tokenizer, similarity):
    """(epoch_hook for ``loop.fit``, the end-of-run figures): the trained
    heatmaps on the first train and val batch, per epoch under
    ``--epoch-figures``. Both run on every rank: ``similarity(params)``
    gives a heatmap's ``compute_fn`` from params in the one-device layout
    (gathering the frozen backbone on a mesh), and rank 0 draws."""

    def heatmaps(params, suffix: str = ""):
        compute = similarity(params)
        if not distributed.is_primary():
            return
        for name, loader in (("Train", train_loader), ("Val", val_loader)):
            plots.plot_embedding_cosine_similarities(
                run_dir, f"Trained Embedding Cosine Similarities on {name} Set{suffix}",
                loader, tokenizer, compute)

    def epoch_hook(epoch, best_params):
        if args.epoch_figures:
            heatmaps(best_params, f" - Epoch {epoch + 1}")

    def finish(result, train_batch_size: int):
        if distributed.is_primary():
            plots.plot_loss_curves(run_dir, result.train_losses, result.val_losses,
                                   train_batch_size, args.batch_size)
        heatmaps(result.best_params)

    return epoch_hook, finish


def run_dir_of(args) -> Path:
    """``--resume-dir`` when given (the run it continues), else a new
    timestamped directory under ``--runs-dir``, made by rank 0 and named to
    every rank."""
    if args.resume_dir:
        run_dir = Path(args.resume_dir)
    else:
        made = str(rundir.make_run_dir(args.runs_dir)) if distributed.is_primary() else None
        run_dir = Path(distributed.broadcast_object(made))
    if distributed.is_primary():
        print(f"All run info will be saved to {run_dir}")
    return run_dir


def check_mesh(args) -> None:
    """The TPU package's mesh refusals, before anything loads (in the
    process that starts the ranks too): a --batch-size the data axis does
    not divide and --packed --pack-tiers exit; --packed with --tp, and a
    --tp that does not divide the backbone's heads and FFN width, raise
    ValueError."""
    dp, tp, pp = common.resolve_mesh_shape(args)
    if dp * tp * pp == 1:
        return
    if args.batch_size % dp:
        raise SystemExit(f"--batch-size {args.batch_size} must be divisible by --dp {dp} "
                         "(batches shard over the data axis)")
    if args.packed and args.pack_tiers > 1:
        raise SystemExit("mesh --packed training supports flat packing only (drop --pack-tiers)")
    if args.packed and tp > 1:
        raise ValueError(PACKED_TP)
    check_model_axis(common.esm_config(args.esm_config, args.esm_dtype), tp)


def mesh_engine_of(args, *, arch: str, packed: bool, ignored: dict, esm=None):
    """The mesh engine of a rank, or None on one device. ``ignored`` maps a
    flag to the value the run would have: the mesh takes one bucket (and
    FILIP one token buffer a side), and a flag set otherwise is noted on
    rank 0 and ignored."""
    dp, tp, pp = common.resolve_mesh_shape(args)
    if dp * tp * pp == 1:
        return None
    for flag, value in ignored.items():
        if value > 1 and distributed.is_primary():
            print(f"[mesh] {flag} ignored under a mesh (use --packed for padding-waste cuts)"
                  if flag == "--length-groups" else
                  f"[mesh] {flag} ignored under a mesh (flat token buffers per shard)")
    mode = "finetune" if args.finetune else "lora" if args.lora_rank else "frozen"
    engine = MeshEngine(data=dp, model=tp, stages=pp, arch=arch, mode=mode, packed=packed,
                        esm=esm)
    if distributed.is_primary():
        print(f"[mesh] {arch.upper()} training over {engine.mesh.shape} on "
              f"{distributed.backend_for(args.device)} ranks")
    return engine


def run_clip_training(args, *, prefix_a: str, prefix_b: str, plot_cluster: bool = False,
                      max_sequence_length: int | None = None) -> int:
    common.check_train_args(args)
    if common.mesh_size(args) > 1 and args.no_gradcache:
        raise SystemExit("mesh training (--dp) drives the global-batch gradcache path "
                         "(drop --no-gradcache)")
    unfrozen = bool(args.finetune or args.lora_rank)
    length_groups = 1 if args.no_gradcache or unfrozen else args.length_groups
    packed = args.packed and not args.no_gradcache
    check_mesh(args)
    launched = common.launch(args, functools.partial(
        run_clip_training, prefix_a=prefix_a, prefix_b=prefix_b, plot_cluster=plot_cluster,
        max_sequence_length=max_sequence_length))
    if launched is not None:
        return launched
    esm_cfg = common.esm_config(args.esm_config, args.esm_dtype, fast_gelu=args.fast_gelu,
                                exact_gelu=args.exact_gelu)
    mesh_engine = mesh_engine_of(args, arch="clip", packed=packed,
                                 ignored={"--length-groups": length_groups}, esm=esm_cfg)
    packed_engine.clear_tier_width_cache()      # a run packs from its own first batch
    device = resolve_device(args.device)
    generator = prng.set_seed(args.seed)
    run_dir = run_dir_of(args)

    esm_params = common.load_esm(args, esm_cfg, device)
    tokenizer = common.make_tokenizer()
    mcfg = clip.CLIPConfig(input_dim=esm_cfg.hidden_size, embedding_dim=args.embedding_dim,
                           h1=args.h1, h2=args.h2, dropout=args.dropout,
                           activation=args.activation, esm=esm_cfg)
    params = clip.init_params(mcfg, generator, device=device)
    params, esm_params, engine = common.unfrozen_params(
        args, params, esm_params, device, finetune_engine=finetune, lora_engine=lora)
    view = eval_view(args, mcfg)

    def similarity(p, esm=None):
        esm = full_backbone(mesh_engine, esm_params) if esm is None else esm
        return similarity_fn(*view(p, esm), mcfg, tokenizer, device)

    data_dir = common.primary_first(common.ensure_data, args, prefix_a, prefix_b)
    train_ds, val_ds, test_ds = common.primary_first(
        generate_datasets, data_dir, prefix_a, prefix_b, seed=args.seed,
        max_sequence_length=max_sequence_length)
    train_loader = PairLoader(train_ds, args.batch_size, shuffle=True, drop_last=True,
                              seed=args.seed)
    val_loader = PairLoader(val_ds, args.batch_size, shuffle=False, drop_last=True,
                            seed=args.seed)
    test_loader = PairLoader(test_ds, args.batch_size, shuffle=False, drop_last=True,
                             seed=args.seed)

    if distributed.is_primary():
        if plot_cluster:
            plots.plot_clustering(run_dir, data_dir, prefix=prefix_b)
        plots.plot_protein_lengths(run_dir, data_dir, prefix1=prefix_a, prefix2=prefix_b)
        plots.plot_embedding_cosine_similarities(run_dir, "Raw Embedding Cosine Similarities",
                                                 train_loader, tokenizer,
                                                 similarity(params, esm_params))
    if mesh_engine:
        # a rank keeps only its slices of the backbone from here on
        params, esm_params = mesh_engine.prepare_params(params), mesh_engine.prepare_esm(esm_params)

    steps_per_epoch = (len(train_loader) if args.no_gradcache
                       else len(train_loader) // args.accumulated_batches)
    cfg = clip_engine.EngineConfig(
        model=mcfg, batch_size=args.batch_size, accumulated_batches=args.accumulated_batches,
        learning_rate=args.lr, num_chunks=args.num_chunks,
        length_groups=1 if mesh_engine else length_groups, packed=packed,
        packed_tiers=args.pack_tiers,
        backbone_lr=args.backbone_lr, weight_decay=args.weight_decay,
        warmup_steps=args.warmup_steps, lr_schedule=args.lr_schedule, grad_clip=args.grad_clip,
        total_steps=args.epochs * steps_per_epoch)
    epoch_hook, finish = figure_hooks(args, run_dir, train_loader, val_loader, tokenizer,
                                      similarity)
    result = loop.fit(run_dir, cfg, params, esm_params, train_loader, val_loader, tokenizer,
                      args.epochs, seed=args.seed, device=device,
                      use_gradcache=not args.no_gradcache, test_loader=test_loader,
                      epoch_hook=epoch_hook, resume=args.resume_dir is not None,
                      engine=mesh_engine or engine)
    finish(result, args.batch_size if args.no_gradcache
           else args.batch_size * args.accumulated_batches)
    return 0
