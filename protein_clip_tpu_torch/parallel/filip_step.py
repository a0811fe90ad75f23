"""The data-parallel FILIP step: the port of
``protein_clip_tpu/parallel/filip_step.py``.

Late interaction needs every token, not pooled vectors: each rank encodes
its rows, gathers the receptor side's normalised tokens (b_local, TB, D)
and masks of every rank, and scores its own peptides against the global
batch: the masked max-sim (K4 on the card) gives rectangular (b_local,
B_global) blocks of both direction matrices. Both FILIP losses reduce row
by row (the denominator sums over the columns), so a rank owns whole rows;
the loss is the sum over the ranks of their rows' terms (``row_loss``). The
gather's backward brings each rank's cotangents of a rank's tokens home, and
the gradients are averaged over the ranks (``step.update``).

Dropout draws from a generator of the rank's data index, so a parity run
with JAX runs at dropout 0. With a 'model' axis the backbone runs on the
rank's Megatron slices (``step.tp_model_config``) and K4 keeps scoring:
the heads and tokens are replicated over the model group, where the TPU
package falls back to its lax ``filip_similarity`` under GSPMD.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models import filip
from ..ops.filip import filip_similarity_fused
from ..train.clip_engine import EngineConfig, _update, expand_batch
from .distributed import gather_rows, global_sum
from .mesh import Mesh, local_batch_size
from .step import local_chunks, on_rank, tp_model_config


def _diag_mask(b_local: int, b_global: int, index: int, device) -> torch.Tensor:
    """(b_local, b_global) bool: True where the column is the row's global
    position (index * b_local + i), the one place the gather's column order
    lives."""
    rows = torch.arange(b_local, device=device)[:, None] + index * b_local
    return torch.arange(b_global, device=device)[None, :] == rows


def _row_direction_loss_sum(logits_rows: torch.Tensor, diag_rows: torch.Tensor, index: int,
                            use_dcl: bool = False) -> torch.Tensor:
    """The sum (not the mean) of the rank's rows' cross-entropy terms:
    logsumexp(row) - its positive, in f32; with ``use_dcl`` the positive
    leaves the denominator."""
    logits_rows = logits_rows.float()
    if use_dcl:
        logits_rows = logits_rows.masked_fill(
            _diag_mask(*logits_rows.shape, index, logits_rows.device), float("-inf"))
    return torch.sum(torch.logsumexp(logits_rows, dim=1) - diag_rows)


def local_diagonals(sim_rows: torch.Tensor, b_local: int, b_global: int,
                    index: int) -> torch.Tensor:
    """The positive logits of the rank's rows: row i's at global column
    index * b_local + i."""
    return torch.where(_diag_mask(b_local, b_global, index, sim_rows.device), sim_rows,
                       0.0).sum(1)


def row_loss(sim_a: torch.Tensor, sim_b: torch.Tensor, index: int,
             use_dcl: bool = False, group=None) -> torch.Tensor:
    """The global FILIP loss from this rank's (b_local, B_global) rows of
    both directions: 0.5 * the sum over the data ``group``'s ranks of their
    rows' terms / B_global, the same value on every rank."""
    b_local, b_global = sim_a.shape
    sums = sum(_row_direction_loss_sum(s, local_diagonals(s, b_local, b_global, index), index,
                                       use_dcl) for s in (sim_a, sim_b))
    return 0.5 * global_sum(sums, group) / b_global


def mesh_row_loss(mesh: Mesh, use_dcl: bool) -> Callable:
    """row_loss(sim_a, sim_b) of this rank's place on the mesh's data axis."""
    return lambda sim_a, sim_b: row_loss(sim_a, sim_b, mesh.index, use_dcl, mesh.data_group)


def gathered_similarity(sim_fn: Callable, group=None) -> Callable:
    """sim(ha, hb, mask_a, mask_b, t): ``sim_fn`` of this rank's A rows
    against every rank's B rows of the data ``group``, (b_local, B_global)
    each way."""
    def sim(ha, hb, mask_a, mask_b, temperature):
        return sim_fn(ha, gather_rows(hb, group), mask_a, gather_rows(mask_b, group),
                      temperature)

    return sim


def make_sharded_filip_train_step(cfg: EngineConfig, mesh: Mesh):
    """The frozen FILIP step over a rank's rows of ``tokenize_pair_batch``
    batches of ``cfg.batch_size`` pairs (FILIP accumulates no batches): K4
    (``filip_similarity_fused``) against the gathered receptor side."""
    sim = gathered_similarity(filip_similarity_fused, mesh.data_group)
    loss = mesh_row_loss(mesh, cfg.filip_use_dcl)
    b_local = local_batch_size(cfg.batch_size, mesh)
    n_chunks = local_chunks(cfg.num_chunks, b_local, mesh)
    mcfg = tp_model_config(cfg.model, mesh)

    def step(params, opt_state, esm_params, batch, generator):
        sim_a, sim_b = filip.forward(params, esm_params, expand_batch(batch), mcfg,
                                     train=True, generator=generator, similarity_fn=sim,
                                     num_chunks=n_chunks)
        return _update(loss(sim_a, sim_b), params, opt_state)

    return on_rank(step, mesh, b_local, packed=False)


def make_sharded_filip_eval_step(cfg: EngineConfig, mesh: Mesh, view: Callable):
    """The FILIP eval step over a rank's rows of a padded batch, in eval
    mode with no graph, on the (heads, backbone) ``view`` gives."""
    sim = gathered_similarity(filip_similarity_fused, mesh.data_group)
    loss = mesh_row_loss(mesh, cfg.filip_use_dcl)
    mcfg = tp_model_config(cfg.model, mesh)

    @torch.inference_mode()
    def step(params, esm_params, batch):
        heads, esm = view(params, esm_params)
        batch = expand_batch(batch)
        n_chunks = local_chunks(cfg.num_chunks, batch["pep_ids"].shape[0], mesh)
        return loss(*filip.forward(heads, esm, batch, mcfg, similarity_fn=sim,
                                   num_chunks=n_chunks))

    return step
