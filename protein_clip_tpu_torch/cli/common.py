"""Shared CLI wiring for the port's entry points: the serving ones
(``embed``, ``serve``, ``retrieve``) and the training ones (``main``,
``main_2protein``, ``main_2protein_filip``). The argument sets they read,
the device, the backbone, checkpoint and token-index loaders, the training
data, and the tokenizer.

Entry points run on ``cuda`` unless ``--device cpu`` is given; asking for
CUDA where there is none raises, and nothing falls back to the CPU. A mesh
(``--dp`` or ``--tp`` > 1) runs one rank a device (``launch``), never two on
a card.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np
import torch

from ..data.synthetic import write_fixture
from ..data.tokenizer import EsmTokenizer
from ..models import clip, esm2
from ..ops import attention
from ..parallel import distributed
from ..parallel.distributed import backend_for
from ..parallel.mesh import rank_device
from ..train import checkpoint, finetune, lora

ESM_FAMILIES = ("t30_150M", "t6_8M", "t12_35M", "t33_650M", "t36_3B", "t48_15B", "tiny")


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--batch-size", type=int, default=16,
                   help="sequences per backbone forward")
    p.add_argument("--embedding-dim", type=int, default=128)
    p.add_argument("--h1", type=int, default=2)
    p.add_argument("--h2", type=int, default=2)
    p.add_argument("--dropout", type=float, default=0.1,
                   help="head dropout (training only; serving runs eval mode)")
    p.add_argument("--activation", default="relu", choices=["relu", "tanh", "gelu"],
                   help="head FFN activation")
    p.add_argument("--esm-config", default="t30_150M", choices=ESM_FAMILIES)
    p.add_argument("--esm-weights", default=None,
                   help="npz from tools/convert_esm_weights.py, or a HF checkpoint "
                        "directory (model.safetensors or pytorch_model.bin); omit for "
                        "random init (smoke runs)")
    p.add_argument("--fast-gelu", action="store_true",
                   help="tanh-approximate FFN gelu in the backbone")
    p.add_argument("--exact-gelu", action="store_true",
                   help="force exact-erf gelu (the default, and the parity contract), "
                        "even under --esm-dtype int8")
    p.add_argument("--esm-dtype", default="bfloat16",
                   choices=["bfloat16", "float32", "int8"],
                   help="backbone compute dtype; int8 = post-training w8a8 quantised "
                        "backbone (bf16 activations and attention; implies the tanh gelu "
                        "unless --exact-gelu)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions of the kernels")


def add_data_args(p: argparse.ArgumentParser) -> None:
    """The paired corpus and the run directory: the training entry points'
    and the offline evals' (``topk``, ``cosine_similarity``)."""
    p.add_argument("--data-dir", default="data",
                   help="directory with the paired FASTAs and the cluster TSV cache")
    p.add_argument("--runs-dir", default="runs")
    p.add_argument("--synthetic-fixture", action="store_true",
                   help="write a synthetic corpus into --data-dir when the FASTAs are "
                        "missing (no-network environments)")
    p.add_argument("--fixture-families", type=int, default=160,
                   help="synthetic corpus size; must be large enough that the 15%% val "
                        "split fills at least one batch")
    p.add_argument("--num-chunks", type=int, default=16,
                   help="backbone microbatches per global step (per encoded side in the "
                        "evals)")


def add_train_args(p: argparse.ArgumentParser) -> None:
    """The training entry points' arguments beside ``add_common_args``."""
    add_data_args(p)
    p.add_argument("--length-groups", type=int, default=4,
                   help="length-sorted encode groups per global batch (1 = one pad bucket)")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight-decay", type=float, default=0.0,
                   help="decoupled (AdamW) weight decay; 0 = the reference's plain Adam")
    p.add_argument("--warmup-steps", type=int, default=0,
                   help="linear LR warmup over this many optimizer steps")
    p.add_argument("--lr-schedule", choices=["constant", "cosine"], default="constant",
                   help="cosine decays to 0 over the run's optimizer-step horizon")
    p.add_argument("--grad-clip", type=float, default=0.0,
                   help="> 0: clip gradients to this global L2 norm before Adam")
    p.add_argument("--packed", action="store_true",
                   help="sequence-packed encoding (segment-masked rows; supersedes "
                        "--length-groups; train/packed_engine.py, and with --finetune or "
                        "--lora-rank the packed two-pass step of train/finetune.py, flat "
                        "packing only); with --no-gradcache it is ignored; in cli.mlm_train "
                        "it packs the training side's sequences")
    p.add_argument("--pack-tiers", type=int, default=1,
                   help="with --packed: >1 packs each side into width-tiered row groups "
                        "(short sequences ride narrower rows, cutting attention cost on "
                        "long-tailed length distributions); the frozen steps only")
    p.add_argument("--finetune", action="store_true",
                   help="unfreeze the ESM-2 backbone: end-to-end training via the two-pass "
                        "gradcache and the attention backward K5 (train/finetune.py; the "
                        "reference is frozen-only). The f32 master backbone trains at "
                        "--backbone-lr")
    p.add_argument("--backbone-lr", type=float, default=None,
                   help="with --finetune: backbone learning rate (heads stay at --lr). "
                        "Default None resolves per mode: 1e-5 for full finetune, 1e-4 for "
                        "LoRA adapters (zero-init adapters want a hotter rate)")
    p.add_argument("--lora-rank", type=int, default=0,
                   help="> 0: LoRA parameter-efficient finetuning (train/lora.py): low-rank "
                        "adapters on the attention projections, base backbone frozen; "
                        "adapter LR = --backbone-lr (default 1e-4 here). Mutually "
                        "exclusive with --finetune")
    p.add_argument("--lora-ffn", action="store_true",
                   help="with --lora-rank: also adapt the FFN wi/wo")
    p.add_argument("--resume-dir", default=None,
                   help="continue the run in this run directory from its newest state "
                        "snapshot (state/epoch_<n>.pt, written after every epoch) up to "
                        "--epochs; the same flags as the run it continues")
    p.add_argument("--epoch-figures", action="store_true",
                   help="per-epoch cosine heatmaps of the best heads (figures/, drawn where "
                        "matplotlib is installed; the matrices as .npy always)")


def add_mesh_args(p: argparse.ArgumentParser) -> None:
    """The mesh flags of the CLIP and FILIP training entry points (the TPU
    package's): the data axis trains on ``--dp`` ranks and the model axis
    shards the backbone over ``--tp``, one rank a device; ``--dp 1 --tp 1``
    (the default) is the single-device path unchanged. --pp and
    --pp-microbatches other than 1 raise (``check_single_device``)."""
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel ranks, one a device (parallel/engine.py): each encodes "
                        "its rows, the embeddings (FILIP: the receptor tokens) are gathered so "
                        "the negatives span the global batch, the gradients averaged; composes "
                        "with --packed (flat), --finetune, --lora-rank. Started plainly the CLI "
                        "starts the ranks itself (gloo on --device cpu, NCCL on CUDA: one card "
                        "a rank); under torchrun it joins that world. 0 = the ranks the launch "
                        "provides (WORLD_SIZE, else the visible cards, else 1 on the CPU) over "
                        "--tp x --pp")
    add_tp_arg(p)
    p.add_argument("--pp", type=int, default=1, help="pipeline stages (1 only: not ported)")
    p.add_argument("--pp-microbatches", type=int, default=None,
                   help="with --pp: microbatches a step (not ported)")
    add_launch_args(p)


def add_tp_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks, one a device (parallel/sharding.py): the backbone's "
                        "heads and FFN columns split the Megatron way over the 'model' axis, "
                        "each rank holding its slices (the finetune f32 masters too); composes "
                        "with --dp (--dp x --tp ranks) and with every unpacked mode")


def add_launch_args(p: argparse.ArgumentParser) -> None:
    """The flags that join ranks across processes or hosts."""
    p.add_argument("--coordinator", default=None,
                   help="host:port of the rendezvous when the ranks span several processes or "
                        "hosts: every process runs the same command with --num-processes and "
                        "its --process-id, and starts --dp / --num-processes ranks of its own")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)


def check_train_args(args) -> None:
    """Raise on the training options this port does not run yet (pipeline
    stages), on --finetune with --lora-rank and on either of
    them with --packed --pack-tiers (as the TPU package does), and on either
    of them with --esm-dtype int8, before anything is loaded."""
    if args.finetune and args.lora_rank:
        raise SystemExit("--finetune and --lora-rank are mutually exclusive "
                         "(full vs parameter-efficient)")
    flag = "--finetune" if args.finetune else "--lora-rank" if args.lora_rank else None
    if args.esm_dtype == "int8" and flag:
        raise NotImplementedError(
            f"{flag} with --esm-dtype int8: the unfrozen modes train a bf16 or f32 "
            "backbone, and the int8 tree has no weights to train (the TPU package "
            "fails on it too); train with --esm-dtype bfloat16")
    if args.packed and args.pack_tiers > 1 and flag:
        raise SystemExit("--finetune/--lora-rank with --packed support flat packing only "
                         "(drop --pack-tiers)")
    check_single_device(args)


def check_single_device(args) -> None:
    """Raise on the mesh axis this port does not run yet: --pp and
    --pp-microbatches other than 1 (the data and model axes, --dp and
    --tp, run)."""
    if (getattr(args, "pp", 1) != 1
            or getattr(args, "pp_microbatches", None) not in (None, 1)):
        raise NotImplementedError("not ported yet: --pp/--pp-microbatches other than 1: "
                                  "pipeline stages, multi-device training beyond the data and "
                                  "model axes (ROADMAP queue 1: multi-device, PP)")


def resolve_mesh_shape(args) -> tuple[int, int, int]:
    """(dp, tp, pp), --dp 0 resolved to the ranks the launch provides
    (WORLD_SIZE, else the visible cards on CUDA, else 1 on the CPU) over
    tp x pp."""
    dp, tp, pp = args.dp, args.tp, getattr(args, "pp", 1)
    if dp == 0:
        if "WORLD_SIZE" in os.environ:
            ranks = int(os.environ["WORLD_SIZE"])
        elif torch.device(args.device).type == "cuda":
            ranks = torch.cuda.device_count()
        else:
            ranks = 1
        dp = max(1, ranks // (tp * pp))
    return dp, tp, pp


def mesh_size(args) -> int:
    dp, tp, pp = resolve_mesh_shape(args)
    return dp * tp * pp


def _check_cards(device: torch.device, n_local: int, n: int) -> None:
    """One rank a card: fewer visible cards than local ranks raise; the
    mesh never shares a card, moves to the CPU or drops ranks."""
    visible = torch.cuda.device_count() if device.type == "cuda" else 0
    if device.type == "cuda" and visible < n_local:
        raise RuntimeError(f"a mesh of {n} ranks needs {n_local} CUDA cards on this host, one "
                           f"rank a card; {visible} visible (pass --device cpu for gloo ranks "
                           "on the CPU, or --dp 1 --tp 1)")


def maybe_init_distributed(args) -> None:
    """Join the world this process was started into, before anything else
    (the TPU package's ``jax.distributed`` join): under ``torchrun``
    (WORLD_SIZE set) with a mesh, as rank RANK at ``env://``, on card
    LOCAL_RANK; WORLD_SIZE must equal the mesh. Also checks the
    --coordinator flags. Otherwise a no-op: ``launch`` starts the ranks."""
    if args.coordinator and (args.num_processes is None or args.process_id is None):
        raise SystemExit("--coordinator needs --num-processes and --process-id")
    if "WORLD_SIZE" not in os.environ or distributed.is_initialized():
        return
    n, world = mesh_size(args), int(os.environ["WORLD_SIZE"])
    if n == 1 and world == 1:
        return
    if world != n:
        raise SystemExit(f"torchrun started {world} ranks but --dp x --tp x --pp is {n}")
    device = torch.device(args.device)
    local = int(os.environ.get("LOCAL_RANK", "0"))
    _check_cards(device, local + 1, n)
    args.device = str(rank_device(device.type, local))
    distributed.initialize(int(os.environ["RANK"]), world, "env://", backend_for(device),
                           torch.device(args.device))


def _rank_entry(local_rank: int, entry, args) -> None:
    args = argparse.Namespace(**vars(args))
    args.device = str(rank_device(torch.device(args.device).type, local_rank))
    entry(args)


def launch(args, entry) -> int | None:
    """Start the ranks of the mesh the flags ask for when this process is
    not a rank already: ``entry(args)`` runs on each, with ``args.device``
    the rank's device. Started plainly, the ranks are this host's (a free
    localhost port); with --coordinator, process --process-id starts its
    share, global ranks process-id x share + j, at that address. One local
    rank runs in this process, more are spawned. Returns 0 once they have
    all finished (a rank's error is raised), or None when this process
    trains itself (no mesh, or already a rank)."""
    n = mesh_size(args)
    if n == 1 or distributed.is_initialized():
        return None
    device = torch.device(args.device)
    if args.coordinator:
        if n % args.num_processes:
            raise SystemExit(f"--num-processes {args.num_processes} does not divide the mesh's "
                             f"{n} ranks")
        n_local = n // args.num_processes
        base, init = args.process_id * n_local, f"tcp://{args.coordinator}"
    else:
        n_local, base, init = n, 0, f"tcp://127.0.0.1:{distributed.free_port()}"
    _check_cards(device, n_local, n)
    if n_local == 1:
        args.device = str(rank_device(device.type, 0))
        distributed.initialize(base, n, init, backend_for(device), torch.device(args.device))
        try:
            return entry(args)
        finally:
            distributed.shutdown()
    distributed.spawn(_rank_entry, (entry, args), n_local, world=n, init_method=init,
                      backend=backend_for(device), device_type=device.type, base_rank=base)
    return 0


def primary_first(fn, *fn_args, **kwargs):
    """``fn(...)`` on rank 0, then on the other ranks once it is done, so
    what it writes (a fixture, a cluster cache) is there for them to read."""
    if distributed.is_primary():
        out = fn(*fn_args, **kwargs)
    distributed.barrier()
    if not distributed.is_primary():
        out = fn(*fn_args, **kwargs)
    return out


def unfrozen_params(args, params: dict, esm_params: dict, device: torch.device, *,
                    finetune_engine, lora_engine, frozen_engine=None) -> tuple:
    """(params, esm_params, engine) of the mode the flags pick: --finetune
    adds the backbone to the trainable params as an f32 master copy and
    empties the step's esm_params slot, which it ignores; --lora-rank adds
    adapters (attention, and the FFN under --lora-ffn) and keeps esm_params,
    the frozen base they merge into; otherwise the heads train alone on
    frozen_engine."""
    if args.finetune:
        return finetune.init_params(esm_params, params), {}, finetune_engine
    if args.lora_rank:
        targets = lora.ATTN_TARGETS + (lora.FFN_TARGETS if args.lora_ffn else ())
        lora_gen = torch.Generator(device=device).manual_seed(args.seed + 1)
        return (lora.init_params(lora.init_lora(lora_gen, esm_params, args.lora_rank, targets),
                                 params), esm_params, lora_engine)
    return params, esm_params, frozen_engine


def ensure_data(args, prefix_a: str, prefix_b: str) -> Path:
    """``--data-dir``, holding ``<prefix_a>.fasta`` and ``<prefix_b>.fasta``;
    with ``--synthetic-fixture`` a missing pair is written from ``--seed``.
    Downloading Propedia or PDB pairs needs the network and is not ported."""
    data_dir = Path(args.data_dir)
    fa, fb = data_dir / f"{prefix_a}.fasta", data_dir / f"{prefix_b}.fasta"
    if not (fa.exists() and fb.exists()):
        if not args.synthetic_fixture:
            raise FileNotFoundError(
                f"{fa} and {fb} are needed: pass --synthetic-fixture for a generated "
                "corpus (downloads, data/fetch.py in the TPU package, are not ported)")
        print(f"[data] writing synthetic fixture into {data_dir}")
        write_fixture(data_dir, prefix1=prefix_a, prefix2=prefix_b,
                      n_families=args.fixture_families, seed=args.seed)
    return data_dir


def esm_config(name: str, dtype_name: str, fast_gelu: bool = False,
               exact_gelu: bool = False) -> esm2.ESM2Config:
    """The named family with ``fused`` attention. On CUDA the attention
    kernels take every family in bf16 and in f32 (head_dim 16, 24, 32, 64 or
    128). int8 quantises the weights (``load_esm``); activations stay bf16
    and attention runs the bf16 kernels.

    The gelu resolves as in the TPU package: int8 implies tanh unless
    --exact-gelu; --exact-gelu gives erf; then --fast-gelu gives tanh; with
    neither flag the PCT_GELU A/B knob, read here, names it (default erf)."""
    dtype = torch.float32 if dtype_name == "float32" else torch.bfloat16
    if dtype_name == "int8" and not exact_gelu:
        fast_gelu = True
    if exact_gelu:
        gelu = "erf"
    elif fast_gelu:
        gelu = "tanh"
    else:
        gelu = os.environ.get("PCT_GELU", "erf")
    return getattr(esm2.ESM2Config, name)(compute_dtype=dtype, gelu=gelu)


def load_esm(args, cfg: esm2.ESM2Config, device: torch.device) -> dict:
    """Backbone parameters on ``device`` in the compute dtype: random init
    (seed 0, like the TPU package), an npz from
    ``tools/convert_esm_weights.py`` (or the port's ``export_npz``), or a HF
    checkpoint directory, read (``checkpoint.read_hf_checkpoint``), converted
    (``esm2.convert_hf_state_dict``, f32) and cast to the compute dtype on
    the host, as the TPU package's ``load_esm`` does, then moved to
    ``device``; ``--esm-dtype int8`` quantises them
    after the load (``esm2.quantize_params``). Raises before loading when
    the attention kernels lack the config's head dim on CUDA. Under
    ``PCT_FFN_PALLAS=1`` the FFN's wi runs K6 in the compute dtype, bf16 or
    f32 (K6-f32), on every family."""
    if device.type == "cuda" and cfg.attention_impl == "fused":
        attention.check_config(cfg.compute_dtype, cfg.head_dim)
    dtype = cfg.compute_dtype

    def finish(params):
        if args.esm_dtype == "int8":
            print("[esm] int8 w8a8 backbone (post-training quantisation)")
            return esm2.quantize_params(params)
        return params

    if args.esm_weights is None:
        print("[esm] random init (pass --esm-weights for pretrained)")
        gen = torch.Generator(device=device).manual_seed(0)
        return finish(esm2.init_params(cfg, gen, dtype=dtype, device=device))
    path = Path(args.esm_weights)
    if path.suffix == ".npz":
        return finish(checkpoint.load_npz(path, esm2.abstract_params(cfg, dtype), device))
    # a HF checkpoint directory, converted on the fly
    print(f"[esm] HF checkpoint {path}")
    sd = checkpoint.read_hf_checkpoint(path)
    unread = sorted(set(sd) - set(esm2.hf_shapes(cfg)))
    if unread:
        print(f"[esm] {len(unread)} tensors of {path} the backbone does not read: "
              f"{unread[:4]}{' ...' if len(unread) > 4 else ''}")
    # converted in f32 on the host and cast there, each leaf moved once in
    # the compute dtype: the card holds what the npz branch's load holds
    params = esm2.convert_hf_state_dict(sd, cfg)
    del sd
    return finish(checkpoint.from_numpy_tree(params, device, dtype))


def load_clip_checkpoint(path, mcfg: clip.CLIPConfig, esm_params: dict,
                         device: torch.device) -> tuple[dict, dict]:
    """A best_model.npz that is heads-only (frozen runs), the finetune
    engine's combined {heads, esm}, or a LoRA run's {heads, lora}. Returns
    (head_params, esm_params): a finetuned checkpoint carries its own
    backbone, in the compute dtype also when ``esm_params`` is int8; a LoRA
    checkpoint's adapters merge into ``esm_params`` (the base it trained
    against) at ``lora.default_alpha`` of its rank, and raise on an int8
    base."""
    with np.load(path, allow_pickle=False) as data:
        keys = data.files
        lora_shapes = {k[len("lora/"):]: data[k].shape for k in keys if k.startswith("lora/")}
    head_like = clip.abstract_params(mcfg)
    quantized = "w_q" in esm_params["layers"]["attn"]["q"]
    if lora_shapes:
        if quantized:
            raise NotImplementedError(
                f"{path} holds LoRA adapters, which merge into a bf16 or f32 base; "
                "--esm-dtype int8 quantised it (the TPU package fails on it too): serve "
                "with --esm-dtype bfloat16")
        lora_like: dict = {}
        for key, shape in lora_shapes.items():
            name, ab = key.rsplit("/", 1)
            lora_like.setdefault(name, {})[ab] = torch.empty(shape, device="meta")
        tree = checkpoint.load_npz(path, {"lora": lora_like, "heads": head_like}, device)
        rank = next(iter(tree["lora"].values()))["a"].shape[-1]
        print(f"[checkpoint] LoRA adapters found (rank {rank}) — merging into the loaded "
              "backbone")
        with torch.no_grad():
            merged = lora.merge_lora(esm_params, tree["lora"], lora.default_alpha(rank))
        return tree["heads"], merged
    if any(k.startswith("heads/") for k in keys):
        like = {"heads": head_like, "esm": esm2.abstract_params(mcfg.esm, mcfg.esm.compute_dtype)}
        tree = checkpoint.load_npz(path, like, device)
        print("[checkpoint] finetuned backbone found — using the checkpoint's "
              "own ESM weights" + (f" in {mcfg.esm.compute_dtype}, not int8" if quantized
                                   else ""))
        return tree["heads"], tree["esm"]
    return checkpoint.load_npz(path, head_like, device), esm_params


def read_token_index(index, embedding_dim: int
                     ) -> tuple[np.ndarray, np.ndarray | None, np.ndarray | None]:
    """(tokens, lengths, mask) of an opened FILIP index npz: ``embed
    --filip``'s ragged {tokens (sum_L, D), lengths (N,)}, or a legacy dense
    {tokens (N, T, D), mask (N, T)}; the form it lacks is None. Raises on a
    pooled or malformed index."""
    if "tokens" not in index:
        raise ValueError("--filip needs a token-level index from `embed --filip` "
                         "({ids, tokens, lengths}); this index holds pooled embeddings")
    tokens = np.asarray(index["tokens"], np.float32)
    lengths = np.asarray(index["lengths"], np.int32) if "lengths" in index else None
    mask = np.asarray(index["mask"], np.int32) if "mask" in index else None
    if lengths is None and mask is None:
        raise ValueError("malformed FILIP index: has 'tokens' but neither 'lengths' "
                         "(ragged, what `embed --filip` writes) nor 'mask' (legacy dense); "
                         "rebuild the index with `embed --filip`")
    if tokens.shape[-1] != embedding_dim:
        raise ValueError(f"index token dim {tokens.shape[-1]} != model "
                         f"--embedding-dim {embedding_dim}")
    return tokens, lengths, mask


def make_tokenizer() -> EsmTokenizer:
    return EsmTokenizer()
