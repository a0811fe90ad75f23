"""FILIP with LoRA adapters: the port of ``protein_clip_tpu/train/filip_lora.py``.

The FILIP finetune two-pass step (``train/filip_finetune.py``, one bucket
or packed) with the backbone view swapped for the adapter merge
(``train/lora.py``): the frozen compute-dtype base rides the ``esm_params``
slot, gradients reach only the adapters and the FILIP token heads, and the
temperature takes its gradient in the tail as in the full finetune. The
eval step runs the frozen FILIP eval on the merged weights.
"""

from __future__ import annotations

from typing import Callable

from . import filip_finetune
from .clip_engine import EngineConfig
from .lora import esm_view, init_params, make_optimizer  # noqa: F401

__all__ = ["init_params", "make_optimizer", "make_train_step", "make_eval_step"]


def make_train_step(cfg: EngineConfig, similarity_fn: Callable | None = None,
                    use_dcl: bool | None = None):
    """(params, opt_state, esm_params, batch, generator) -> (params,
    opt_state, loss), with esm_params the frozen base."""
    return filip_finetune.make_train_step(cfg, similarity_fn, use_dcl, view=esm_view(cfg))


def make_eval_step(cfg: EngineConfig, similarity_fn: Callable | None = None,
                   use_dcl: bool | None = None):
    return filip_finetune.make_eval_step(cfg, similarity_fn, use_dcl, view=esm_view(cfg))
