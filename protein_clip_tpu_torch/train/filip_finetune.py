"""FILIP with the backbone unfrozen: the port of
``protein_clip_tpu/train/filip_finetune.py``, a two-pass step at token level.

The CLIP finetune step (``train/finetune.py``) caches pooled embeddings;
FILIP's late interaction reads every token of both sides, so what the
passes hand over is the normalised token tensor:

  pass 1   every chunk through the backbone and the token heads with no
           graph: (B, T, D) normalised tokens a side (packed: (R, L, D), in
           the packs' row order);
  tail     the max-sim (K4 on the card) and the FILIP InfoNCE,
           differentiated with respect to the parameters it reaches (the
           temperature) and the two token tensors;
  pass 2   each chunk again with a graph (remat, K5 on the card), fed its
           own slice of its side's token gradient: chunk i's rows, not a
           gradient every chunk shares as in pooled CLIP. In the packed
           step the scatter moves each valid token to one slot, so a
           chunk's rows of the gradient are its tokens' gradients; gap and
           pad tokens go to the dump slot and get 0.

The cache is small: B T D 4 bytes a side (about 33.5 MB at batch 128, T
512, D 128). The packed tail is ``train/filip_packed``'s scatter (flat or
by scatter tiers), max-sim and loss; its chunks take the same tokens on
both sides (``finetune._packed_machinery``'s rule).

Dropout: one host seed per chunk and side (``finetune._chunk_seeds``), so
pass 2 redraws pass 1's masks (the TPU package splits a key per chunk).
Params ``{"esm": f32 masters, "heads": FILIP heads}`` and the two-group
Adam are ``train/finetune.py``'s; ``esm_view`` is the hook LoRA
(``train/filip_lora.py``) replaces with the adapter merge. Length groups
and width-tiered packs are refused, as in the TPU package.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models import esm2, filip, heads
from ..ops.filip import filip_similarity_fused
from ..ops.infonce import filip_loss
from . import packed_engine as pe
from .clip_engine import EngineConfig, expand_batch
from .filip_engine import _snap_chunks
from .filip_packed import _l2_normalize_tokens, _scatter_side, _sim_from_tiers
from .finetune import (_chunk_seeds, _chunked, _generator, _packed_forward,  # noqa: F401
                       _packed_sides, esm_view, init_params, make_optimizer)

Params = dict

__all__ = ["init_params", "make_optimizer", "make_train_step", "make_train_step_packed",
           "make_token_loss", "make_packed_token_loss", "make_eval_step"]


def _check_plain(cfg: EngineConfig) -> None:
    if cfg.length_groups > 1:
        raise ValueError("FILIP finetune trains on plain (tokenize_pair_batch) or packed "
                         "(cfg.packed) batches; grouped FILIP finetune is not wired")


def _token_machinery(cfg: EngineConfig, sim_fn: Callable, use_dcl: bool,
                     view: Callable[[Params, Params], Params]):
    """(encode_chunk, prepare, tail) of the one-bucket step.
    ``encode_chunk(params, esm_params, side, chunk)`` gives a chunk's (b, T,
    D) normalised tokens on the backbone ``view`` makes; ``prepare(batch,
    generator)`` the expanded batch and each side's chunks with their
    seeds; ``tail(params, HA, HB, batch)`` the loss."""
    mcfg = cfg.model
    n = _snap_chunks(cfg.batch_size, cfg.num_chunks)

    def encode_chunk(params, esm_params, side, chunk):
        h = esm2.forward(view(params, esm_params), chunk["ids"], chunk["mask"], mcfg.esm,
                         remat=cfg.remat)
        return filip.encode_side_tokens(params["heads"], side, h.float(), mcfg, train=True,
                                        generator=_generator(chunk["seed"], h.device))

    def prepare(batch, generator):
        batch = expand_batch(batch)
        seeds = _chunk_seeds(generator, n)
        return batch, {side: _chunked(batch, side, n, s) for side, s in zip(pe.SIDES, seeds)}

    def tail(params, HA, HB, batch):
        return filip_loss(*sim_fn(HA, HB, batch["pep_mask"], batch["rec_mask"],
                                  params["heads"]["temperature"]), use_dcl)

    return encode_chunk, prepare, tail


def _resolve(cfg: EngineConfig, similarity_fn, use_dcl, view):
    return (similarity_fn or filip_similarity_fused,
            cfg.filip_use_dcl if use_dcl is None else use_dcl, view or esm_view(cfg))


def make_token_loss(cfg: EngineConfig, similarity_fn: Callable | None = None,
                    use_dcl: bool | None = None,
                    view: Callable[[Params, Params], Params] | None = None):
    """loss(params, esm_params, batch, generator): the one-bucket step's
    loss in one graph, with the same chunks and dropout seeds as its two
    passes (the form the two passes' gradients are held against)."""
    encode_chunk, prepare, tail = _token_machinery(cfg, *_resolve(cfg, similarity_fn, use_dcl,
                                                                  view))

    def loss(params, esm_params, batch, generator):
        batch, chunks = prepare(batch, generator)
        H = [torch.cat([encode_chunk(params, esm_params, side, c) for c in chunks[side]])
             for side in pe.SIDES]
        return tail(params, *H, batch)

    return loss


def make_train_step(cfg: EngineConfig, similarity_fn: Callable | None = None,
                    use_dcl: bool | None = None,
                    view: Callable[[Params, Params], Params] | None = None):
    """The unfrozen FILIP step over ``tokenize_pair_batch`` batches, or with
    ``cfg.packed`` over ``tokenize_packed`` ones: (params, opt_state,
    esm_params, batch, generator) -> (params, opt_state, loss).
    ``esm_params`` is ignored by the full finetune (the backbone lives in
    params) and is the frozen base under LoRA's ``view``."""
    if cfg.packed:
        return make_train_step_packed(cfg, similarity_fn, use_dcl, view=view)
    _check_plain(cfg)
    encode_chunk, prepare, tail = _token_machinery(cfg, *_resolve(cfg, similarity_fn, use_dcl,
                                                                  view))

    def step(params, opt_state, esm_params, batch, generator):
        loss = token_passes(encode_chunk, tail, params, esm_params, *prepare(batch, generator))
        opt_state.apply()
        return params, opt_state, loss

    return step


def token_passes(encode_chunk, tail, params, esm_params, batch, chunks) -> torch.Tensor:
    """The two passes of the one-bucket step over ``_token_machinery``'s
    pieces and ``prepare``'s (batch, chunks): the gradients accumulate into
    the parameters' ``.grad``; returns the loss, detached."""
    with torch.no_grad():
        H = {side: torch.cat([encode_chunk(params, esm_params, side, c)
                              for c in chunks[side]]) for side in pe.SIDES}
    for h in H.values():
        h.requires_grad_(True)
    loss = tail(params, H["pep"], H["rec"], batch)
    loss.backward()
    for side in pe.SIDES:
        for c, g in zip(chunks[side], H[side].grad.split(len(chunks[side][0]["ids"]))):
            encode_chunk(params, esm_params, side, c).backward(g)
    return loss.detach()


def _packed_token_machinery(cfg: EngineConfig, sim_fn: Callable, use_dcl: bool,
                            rows_per_chunk: int, view: Callable[[Params, Params], Params]):
    """(chunk_tokens, prepare, tail) of the packed step.
    ``chunk_tokens(params, esm_params, side, chunk, seed)`` gives a chunk's
    (r, L, D) normalised tokens; ``prepare(batch, generator)`` per side
    (chunks, seeds, expanded pack, scatter tiers or None), chunked by
    ``finetune._packed_sides`` (the same tokens a chunk on both sides);
    ``tail(params, X, sides)`` the loss of the two sides' (R, L, D) token
    tensors."""
    mcfg = cfg.model
    n_seqs = cfg.batch_size                 # FILIP accumulates no batches

    def chunk_tokens(params, esm_params, side, chunk, seed):
        h = _packed_forward(cfg, view, params, esm_params, chunk)
        x = heads.encode_tokens(params["heads"][side], h.float(), mcfg.activation,
                                dropout_rate=mcfg.dropout, train=True,
                                generator=_generator(seed, h.device))
        return _l2_normalize_tokens(x)

    def prepare(batch, generator):
        return {side: (chunks, seeds, pack, batch.get(f"{side}_stiers"))
                for side, (pack, chunks, seeds, _)
                in _packed_sides(batch, rows_per_chunk, generator).items()}

    def tail(params, X, sides):
        tiers = {side: _scatter_side(X[side], pack, stiers, n_seqs)
                 for side, (_, _, pack, stiers) in sides.items()}
        return filip_loss(*_sim_from_tiers(tiers["pep"], tiers["rec"],
                                           params["heads"]["temperature"], sim_fn, n_seqs),
                          use_dcl)

    return chunk_tokens, prepare, tail


def _scan_tokens(chunk_tokens, params, esm_params, sides) -> dict:
    """Each side's (R, L, D) token tensor, its chunks in the pack's row order."""
    return {side: torch.cat([chunk_tokens(params, esm_params, side, c, s)
                             for c, s in zip(chunks, seeds)])
            for side, (chunks, seeds, _, _) in sides.items()}


def make_packed_token_loss(cfg: EngineConfig, similarity_fn: Callable | None = None,
                           use_dcl: bool | None = None, rows_per_chunk: int | None = None,
                           view: Callable[[Params, Params], Params] | None = None):
    """loss(params, esm_params, batch, generator): the packed step's loss in
    one graph, with the same chunks and dropout seeds as its two passes."""
    sim_fn, use_dcl, view = _resolve(cfg, similarity_fn, use_dcl, view)
    chunk_tokens, prepare, tail = _packed_token_machinery(
        cfg, sim_fn, use_dcl, pe._default_rows_per_chunk(rows_per_chunk), view)

    def loss(params, esm_params, batch, generator):
        sides = prepare(batch, generator)
        return tail(params, _scan_tokens(chunk_tokens, params, esm_params, sides), sides)

    return loss


def make_train_step_packed(cfg: EngineConfig, similarity_fn: Callable | None = None,
                           use_dcl: bool | None = None, rows_per_chunk: int | None = None,
                           view: Callable[[Params, Params], Params] | None = None):
    """The unfrozen FILIP step over ``tokenize_packed`` batches of
    ``cfg.batch_size`` pairs (flat packing; scatter tiers compose), with
    ``make_train_step``'s signature."""
    pe.check_flat(cfg.packed_tiers)
    sim_fn, use_dcl, view = _resolve(cfg, similarity_fn, use_dcl, view)
    chunk_tokens, prepare, tail = _packed_token_machinery(
        cfg, sim_fn, use_dcl, pe._default_rows_per_chunk(rows_per_chunk), view)

    def step(params, opt_state, esm_params, batch, generator):
        pe._validate_packed_batch(batch, cfg.batch_size)
        loss = packed_token_passes(chunk_tokens, tail, params, esm_params,
                                   prepare(batch, generator))
        opt_state.apply()
        return params, opt_state, loss

    return step


def packed_token_passes(chunk_tokens, tail, params, esm_params, sides) -> torch.Tensor:
    """The two passes of the packed step over ``_packed_token_machinery``'s
    pieces and ``prepare``'s sides: the gradients accumulate into the
    parameters' ``.grad``; returns the loss, detached."""
    with torch.no_grad():
        X = _scan_tokens(chunk_tokens, params, esm_params, sides)
    for x in X.values():
        x.requires_grad_(True)
    loss = tail(params, X, sides)
    loss.backward()
    for side, (chunks, seeds, _, _) in sides.items():
        grads = X[side].grad.split([len(c["ids"]) for c in chunks])
        for chunk, seed, g in zip(chunks, seeds, grads):
            chunk_tokens(params, esm_params, side, chunk, seed).backward(g)
    return loss.detach()


def make_eval_step(cfg: EngineConfig, similarity_fn: Callable | None = None,
                   use_dcl: bool | None = None,
                   view: Callable[[Params, Params], Params] | None = None):
    """The frozen FILIP eval step (packed or one bucket, as cfg says) on the
    backbone ``view`` makes: the finetuned master cast to the compute dtype."""
    from .filip_engine import make_eval_step as frozen_eval

    base = frozen_eval(cfg, similarity_fn, use_dcl)
    view = view or esm_view(cfg)

    def step(params, esm_params, batch):
        with torch.no_grad():
            backbone = view(params, esm_params)
        return base(params["heads"], backbone, batch)

    return step
