"""The MLM training steps of one device: the port of the step functions in
``protein_clip_tpu/cli/mlm_train.py``, which ``cli.mlm_train`` runs and
``parallel/mlm_step.py`` wraps for the (data, model) mesh.

The loss is the masked cross-entropy over the batch's masked positions,
``reduce(sum, count)`` of ``models/mlm.mlm_loss_terms``: their mean on one
device (``local_mean``), the mean over every data shard's positions on a
mesh (``parallel/mlm_step.global_mean``).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models import esm2, mlm


def local_mean(s: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The mean over the masked positions (0 where none is)."""
    return s / c.clamp(min=1.0)


def make_steps(cfg: esm2.ESM2Config, mode: str, view: Callable[[dict, dict], dict] | None = None,
               reduce: Callable = local_mean) -> tuple[Callable, Callable]:
    """(train_step, eval_step) of a mode. ``train_step(trainable, opt_state,
    esm_params, inputs, masks) -> (trainable, opt_state, loss)`` with
    ``inputs`` from ``batch_inputs`` and ``masks`` from ``draw_masks``;
    ``eval_step(trainable, esm_params, inputs, masks) -> loss``. In mode
    "head" the trainable tree is the LM head over ``esm_params``; otherwise
    {esm or lora, head}, ``view(trainable, esm_params)`` giving the
    compute-dtype backbone, run with remat. ``reduce(sum, count)`` is the
    loss of the masked positions' terms."""
    remat = mode != "head"

    def loss_of(trainable, esm_params, inputs, masks, remat_now):
        esm_p = view(trainable, esm_params) if mode != "head" else esm_params
        head = trainable if mode == "head" else trainable["head"]
        masked, labels = masks
        return reduce(*mlm.mlm_loss_terms(esm_p, head, masked, inputs["mask"], labels, cfg,
                                          remat=remat_now, segment_ids=inputs["seg"],
                                          positions=inputs["pos"]))

    def train_step(trainable, opt_state, esm_params, inputs, masks):
        loss = loss_of(trainable, esm_params, inputs, masks, remat)
        loss.backward()
        opt_state.apply()
        return trainable, opt_state, loss.detach()

    @torch.no_grad()
    def eval_step(trainable, esm_params, inputs, masks):
        return loss_of(trainable, esm_params, inputs, masks, False)

    return train_step, eval_step
