"""Shared CLI wiring for the port's entry points: the serving ones
(``embed``, ``serve``, ``retrieve``) and the training ones (``main``,
``main_2protein``). The argument sets they read, the device, the backbone,
checkpoint and token-index loaders, the training data, and the tokenizer.

Entry points run on ``cuda`` unless ``--device cpu`` is given; asking for
CUDA where there is none raises, and nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..data.synthetic import write_fixture
from ..data.tokenizer import EsmTokenizer
from ..models import clip, esm2
from ..ops import attention
from ..train import checkpoint, lora

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
                   help="npz from tools/convert_esm_weights.py; omit for random "
                        "init (smoke runs)")
    p.add_argument("--fast-gelu", action="store_true",
                   help="tanh-approximate FFN gelu in the backbone")
    p.add_argument("--exact-gelu", action="store_true",
                   help="force exact-erf gelu (the default, and the parity contract)")
    p.add_argument("--esm-dtype", default="bfloat16",
                   choices=["bfloat16", "float32", "int8"],
                   help="backbone compute dtype (int8 is not ported yet)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions of the kernels")


def add_train_args(p: argparse.ArgumentParser) -> None:
    """The training entry points' arguments beside ``add_common_args``."""
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
                   help="backbone microbatches per global step")
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
                   help="sequence-packed encoding (not ported yet: raises)")
    p.add_argument("--finetune", action="store_true",
                   help="unfreeze the ESM-2 backbone: end-to-end training via the two-pass "
                        "gradcache and the attention backward K5 (train/finetune.py; the "
                        "reference is frozen-only). The f32 master backbone trains at "
                        "--backbone-lr. Not with --packed (not ported yet: raises)")
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
                   help="continue a run from its state snapshot (not ported yet: raises)")


def add_mesh_args(p: argparse.ArgumentParser) -> None:
    """The multi-device mesh flags. The port trains on one device: any
    value other than 1 raises (``check_train_args``)."""
    p.add_argument("--dp", type=int, default=1, help="data-parallel axis (1 only)")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel axis (1 only)")
    p.add_argument("--pp", type=int, default=1, help="pipeline stages (1 only)")


def check_train_args(args) -> None:
    """Raise on the training options this port does not run yet, and on
    --finetune with --lora-rank (as the TPU package does), before anything
    is loaded."""
    if args.finetune and args.lora_rank:
        raise SystemExit("--finetune and --lora-rank are mutually exclusive "
                         "(full vs parameter-efficient)")
    refused = [
        (args.packed, "--packed: the packed train step (ROADMAP queue 1: the packed "
                      "CLIP train step, then the packed finetune and LoRA steps)"),
        (args.resume_dir is not None, "--resume-dir: train-state snapshots and resume "
                                      "(ROADMAP queue 1)"),
        ((args.dp, args.tp, args.pp) != (1, 1, 1), "--dp/--tp/--pp other than 1: "
                                                   "multi-device training (ROADMAP queue 1: "
                                                   "multi-device)"),
    ]
    for hit, what in refused:
        if hit:
            raise NotImplementedError(f"not ported yet: {what}")


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
    kernel takes bf16 at head_dim 32 (t30_150M) only: ``load_esm`` refuses
    the other families (head_dim 16, 24, 64 or 128) and float32 there."""
    dtype = torch.float32 if dtype_name == "float32" else torch.bfloat16
    if dtype_name == "int8" and not exact_gelu:
        fast_gelu = True  # as in the TPU package: int8 implies tanh gelu
    gelu = "tanh" if fast_gelu and not exact_gelu else "erf"
    return getattr(esm2.ESM2Config, name)(compute_dtype=dtype, gelu=gelu)


def load_esm(args, cfg: esm2.ESM2Config, device: torch.device) -> dict:
    """Backbone parameters on ``device`` in the compute dtype: random init
    (seed 0, like the TPU package) or an npz from
    ``tools/convert_esm_weights.py`` (or the port's ``export_npz``). Raises
    before loading when the attention kernel does not take the config."""
    if args.esm_dtype == "int8":
        raise NotImplementedError("--esm-dtype int8 is not ported yet "
                                  "(ROADMAP queue 1: int8 w8a8)")
    if device.type == "cuda" and cfg.attention_impl == "fused":
        attention.check_config(cfg.compute_dtype, cfg.head_dim)
    dtype = cfg.compute_dtype
    if args.esm_weights is None:
        print("[esm] random init (pass --esm-weights for pretrained)")
        gen = torch.Generator(device=device).manual_seed(0)
        return esm2.init_params(cfg, gen, dtype=dtype, device=device)
    path = Path(args.esm_weights)
    if path.suffix != ".npz":
        raise NotImplementedError(f"--esm-weights {path}: only .npz is read; HF "
                                  "checkpoint directories are not ported yet "
                                  "(ROADMAP queue 1: HF-directory loader)")
    return checkpoint.load_npz(path, esm2.abstract_params(cfg, dtype), device)


def load_clip_checkpoint(path, mcfg: clip.CLIPConfig, esm_params: dict,
                         device: torch.device) -> tuple[dict, dict]:
    """A best_model.npz that is heads-only (frozen runs), the finetune
    engine's combined {heads, esm}, or a LoRA run's {heads, lora}. Returns
    (head_params, esm_params): a finetuned checkpoint carries its own
    backbone; a LoRA checkpoint's adapters merge into ``esm_params`` (the
    base it trained against) at ``lora.default_alpha`` of its rank."""
    with np.load(path, allow_pickle=False) as data:
        keys = data.files
        lora_shapes = {k[len("lora/"):]: data[k].shape for k in keys if k.startswith("lora/")}
    head_like = clip.abstract_params(mcfg)
    if lora_shapes:
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
              "own ESM weights")
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
