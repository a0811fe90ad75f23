"""End-to-end finetuning, the unfrozen-backbone CLIP engine: the port of
``protein_clip_tpu/train/finetune.py`` (its plain path).

The backbone trains with the heads, at the same global batch, through the
two-pass ``gradcache_value_and_grad``: pass 1 encodes every chunk without a
graph, the global InfoNCE (K2/K3 on the card) is differentiated with respect
to the concatenated embeddings, and pass 2 replays each chunk with a graph,
per-layer rematerialisation (``remat``) and the attention backward K5, and
feeds it its slice of the embeddings' gradients.

Mixed precision as in the TPU package: the master backbone stays f32 (Adam
moments in f32), and each chunk's encode casts it to the compute dtype
inside the graph, so autograd routes that chunk's bf16 gradients back
through the cast and accumulates them into the master's f32 ``.grad``. A
bf16 copy made once per step would sum the 16 chunks' gradients in bf16.

Dropout: the step's generator gives one seed per chunk and side, on the
host; each chunk's encode seeds a generator of its own from it, in both
passes, so pass 2 draws the masks of pass 1 (the gradcache invariant; the
TPU package splits one key per chunk).

Params: ``{"esm": <esm2 params, f32>, "heads": <clip params>}``. The step is
``(params, opt_state, esm_params, batch, generator) -> (params, opt_state,
loss)`` like the frozen engine's, so ``loop.fit`` drives it; the
``esm_params`` slot is ignored (the backbone lives inside params). Two
learning rates (``make_optimizer``): heads at ``cfg.learning_rate``, backbone
at ``cfg.backbone_lr`` (default 1e-5). The packed finetune step is not
ported (ROADMAP queue 1).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..models import clip, esm2
from . import optimizer as opt_mod
from .clip_engine import EngineConfig, default_loss_fn, expand_batch, make_eval_step as _eval
from .gradcache import gradcache_value_and_grad

Params = dict[str, Any]

__all__ = ["init_params", "make_optimizer", "esm_view", "make_train_step",
           "make_train_step_packed", "make_eval_step"]


def _master(tree):
    if isinstance(tree, dict):
        return {k: _master(v) for k, v in tree.items()}
    return tree.detach().to(torch.float32, copy=True)


def init_params(esm_params: Params, head_params: Params) -> Params:
    """The finetune tree: an f32 master copy of the backbone (Adam's
    moment updates underflow in bf16) beside the heads."""
    return {"esm": _master(esm_params), "heads": head_params}


def make_optimizer(cfg: EngineConfig) -> opt_mod.MultiOptimizer:
    """Two groups: heads at cfg.learning_rate, backbone at cfg.backbone_lr
    (default 1e-5: 1e-3 would wreck a pretrained backbone); the schedule
    and weight-decay knobs apply to both at their own peak rates, and
    cfg.grad_clip clips the whole tree."""
    bb_lr = cfg.backbone_lr if cfg.backbone_lr is not None else 1e-5
    return opt_mod.multi_transform({"esm": opt_mod.from_config(cfg, lr=bb_lr, grad_clip=0.0),
                                    "heads": opt_mod.from_config(cfg, grad_clip=0.0)},
                                   grad_clip=cfg.grad_clip)


def _cast_esm(esm_params: Params, dtype: torch.dtype) -> Params:
    return esm2.cast_params(esm_params, dtype)


def _chunk_seeds(generator: torch.Generator | None, n: int) -> list[list[int | None]]:
    """Per-side, per-chunk dropout seeds, drawn once per step from the
    step's generator; None without one (dropout 0 or eval). The seeds are
    drawn on the host: a CUDA generator's Philox seed and offset are host
    state, so a CPU generator seeded from them draws the seeds and the
    step's generator moves its offset on for the next step, with no sync
    with the card."""
    if generator is None:
        return [[None] * n, [None] * n]
    if generator.device.type == "cuda":
        offset = generator.get_offset()
        generator.set_offset(offset + 4)       # Philox offsets step by 4
        generator = torch.Generator().manual_seed(
            (generator.initial_seed() * 1_000_003 + offset) % 2 ** 63)
    return torch.randint(0, 2 ** 62, (2, n), generator=generator).tolist()


def _chunked(batch: dict, side: str, n: int, seeds: list) -> list[dict]:
    ids, mask = batch[f"{side}_ids"], batch[f"{side}_mask"]
    if ids.shape[0] % n:
        raise ValueError(f"global batch {ids.shape[0]} not divisible by num_chunks {n}")
    return [{"ids": i, "mask": m, "seed": s}
            for i, m, s in zip(ids.chunk(n), mask.chunk(n), seeds)]


def _encoder(cfg: EngineConfig, side: str, esm_view: Callable[[Params], Params]):
    """encode_fn(params, chunk) -> (b, D): the backbone that ``esm_view``
    makes of the params, then ``side``'s heads with the chunk's own dropout
    generator."""
    mcfg = cfg.model

    def fn(params, chunk):
        h = esm2.forward(esm_view(params), chunk["ids"], chunk["mask"], mcfg.esm,
                         remat=cfg.remat)
        gen = (None if chunk["seed"] is None
               else torch.Generator(device=chunk["ids"].device).manual_seed(chunk["seed"]))
        return clip.encode_side(params["heads"], side, h.float(), chunk["mask"], mcfg,
                                train=True, generator=gen)

    return fn


def _two_pass_step(cfg: EngineConfig, loss_fn: Callable,
                   esm_view: Callable[[Params, Params], Params]):
    """The unfrozen step over one bucket: ``esm_view(params, esm_params)``
    gives the compute-dtype backbone each chunk runs on."""
    n = cfg.num_chunks

    def step(params, opt_state, esm_params, batch, generator):
        batch = expand_batch(batch)
        seeds = _chunk_seeds(generator, n)

        def view(p):
            return esm_view(p, esm_params)

        loss = gradcache_value_and_grad(
            _encoder(cfg, "pep", view), loss_fn, params, _chunked(batch, "pep", n, seeds[0]),
            _chunked(batch, "rec", n, seeds[1]), encode_fn_y=_encoder(cfg, "rec", view))
        opt_state.apply()
        return params, opt_state, loss

    return step


def _check_plain(cfg: EngineConfig, what: str) -> None:
    if cfg.packed:
        raise NotImplementedError(f"the packed {what} step is not ported yet (ROADMAP "
                                  "queue 1: the packed finetune and LoRA steps)")
    if cfg.length_groups > 1:
        raise ValueError(f"{what} trains on plain (tokenize_pair_batch) batches; "
                         "length-grouped training is not wired")


def esm_view(cfg: EngineConfig) -> Callable[[Params, Params], Params]:
    """(params, esm_params) -> the backbone a chunk runs on: the f32 master
    cast to the compute dtype inside the graph (esm_params is ignored)."""
    dtype = cfg.model.esm.compute_dtype
    return lambda params, _: _cast_esm(params["esm"], dtype)


def make_train_step(cfg: EngineConfig, loss_fn: Callable | None = None):
    """The unfrozen step over ``tokenize_pair_batch`` batches: (params,
    opt_state, _, batch, generator) -> (params, opt_state, loss), with
    ``opt_state`` from ``make_optimizer(cfg).init(params)``."""
    _check_plain(cfg, "finetune")
    return _two_pass_step(cfg, loss_fn or default_loss_fn(), esm_view(cfg))


def make_train_step_packed(cfg: EngineConfig, loss_fn: Callable | None = None):
    raise NotImplementedError("the packed finetune step is not ported yet (ROADMAP queue 1: "
                              "the packed finetune and LoRA steps)")


def make_eval_step(cfg: EngineConfig, loss_fn: Callable | None = None):
    """The frozen engine's eval step on the finetuned backbone, cast to the
    compute dtype."""
    base = _eval(cfg, loss_fn)
    view = esm_view(cfg)

    def step(params, esm_params, batch):
        with torch.no_grad():
            esm_c = view(params, esm_params)
        return base(params["heads"], esm_c, batch)

    return step
