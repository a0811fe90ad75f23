"""Shared CLI wiring for the port's serving entry points (``embed``,
``serve``): the argument subset they read, the device, the backbone and
checkpoint loaders, and the tokenizer.

Entry points run on ``cuda`` unless ``--device cpu`` is given; asking for
CUDA where there is none raises, and nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..data.tokenizer import EsmTokenizer
from ..models import clip, esm2
from ..ops import attention
from ..train import checkpoint

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
    """A best_model.npz that is heads-only (frozen runs) or the finetune
    engine's combined {heads, esm}. Returns (head_params, esm_params): a
    finetuned checkpoint carries its own backbone."""
    with np.load(path, allow_pickle=False) as data:
        keys = data.files
    if any(k.startswith("lora/") for k in keys):
        raise NotImplementedError(f"{path} holds LoRA adapters, which are not "
                                  "ported yet (ROADMAP queue 1: LoRA checkpoints)")
    head_like = clip.abstract_params(mcfg)
    if any(k.startswith("heads/") for k in keys):
        like = {"heads": head_like, "esm": esm2.abstract_params(mcfg.esm, mcfg.esm.compute_dtype)}
        tree = checkpoint.load_npz(path, like, device)
        print("[checkpoint] finetuned backbone found — using the checkpoint's "
              "own ESM weights")
        return tree["heads"], tree["esm"]
    return checkpoint.load_npz(path, head_like, device), esm_params


def make_tokenizer() -> EsmTokenizer:
    return EsmTokenizer()
