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
at ``cfg.backbone_lr`` (default 1e-5).

With ``cfg.packed`` the step runs the same two passes over chunks of packed
rows (``make_train_step_packed``, flat packing). Pooling is a sum over each
sequence's tokens, so a chunk yields (n, D) partial token sums (zero for the
sequences it does not hold) and pass 2 feeds every chunk the same global
gradient of the sums: nothing per chunk is cached between the passes.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..models import clip, esm2
from . import optimizer as opt_mod
from . import packed_engine as pe
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
    if cfg.length_groups > 1:
        raise ValueError(f"{what} trains on plain (tokenize_pair_batch) or packed "
                         "(cfg.packed) batches; length-grouped training is not wired")


def esm_view(cfg: EngineConfig) -> Callable[[Params, Params], Params]:
    """(params, esm_params) -> the backbone a chunk runs on: the f32 master
    cast to the compute dtype inside the graph (esm_params is ignored)."""
    dtype = cfg.model.esm.compute_dtype
    return lambda params, _: _cast_esm(params["esm"], dtype)


def make_train_step(cfg: EngineConfig, loss_fn: Callable | None = None):
    """The unfrozen step over ``tokenize_pair_batch`` batches, or with
    ``cfg.packed`` over ``tokenize_packed`` ones: (params, opt_state, _,
    batch, generator) -> (params, opt_state, loss), with ``opt_state`` from
    ``make_optimizer(cfg).init(params)``."""
    if cfg.packed:
        return make_train_step_packed(cfg, loss_fn)
    _check_plain(cfg, "finetune")
    return _two_pass_step(cfg, loss_fn or default_loss_fn(), esm_view(cfg))


def _chunk_pack(pack: dict, rows_per_chunk: int) -> list[dict]:
    """One expanded pack's rows in chunks: the most equal chunks, at most
    R // rows_per_chunk of them, that divide R (the frozen path's rule)."""
    R = pack["ids"].shape[0]
    n = max(1, R // rows_per_chunk)
    while R % n:
        n -= 1
    keys = ("ids", "seg", "pos", "owner")
    return [dict(zip(keys, parts)) for parts in zip(*(pack[k].chunk(n) for k in keys))]


def _default_expand_sides(batch: dict) -> dict[str, dict]:
    """The device-side maps of a flat packed batch, per side."""
    if "pep_packs" in batch or "rec_packs" in batch:
        raise ValueError("the packed finetune and LoRA steps take flat packing only "
                         "(packed_tiers=1)")
    batch = pe.expand_packed_batch(batch)
    return {side: {k: batch[f"{side}_{k}"] for k in ("ids", "seg", "pos", "owner")}
            for side in pe.SIDES}


def _generator(seed: int | None, device) -> torch.Generator | None:
    return None if seed is None else torch.Generator(device=device).manual_seed(seed)


def _packed_machinery(cfg: EngineConfig, loss_fn: Callable, rows_per_chunk: int,
                      view: Callable[[Params, Params], Params]):
    """The pieces of the packed two-pass step: (chunk_sums, scan_sums, tail,
    prepare). ``prepare(batch, generator)`` gives, per side, (chunks, chunk
    seeds, tail seed); ``chunk_sums`` one chunk's (n, D) token sums and (n,)
    counts; ``scan_sums`` their sums over each side's chunks, as ({side:
    sums}, {side: counts}); ``tail`` the loss of those (masked mean, pooled
    FFN, scale, InfoNCE)."""
    mcfg = cfg.model
    n_seqs = cfg.global_batch
    drop = dict(dropout_rate=mcfg.dropout, train=True, activation=mcfg.activation)

    def chunk_sums(params, esm_params, side, chunk, seed):
        h = esm2.forward(view(params, esm_params), chunk["ids"],
                         (chunk["seg"] > 0).to(torch.int32), mcfg.esm, remat=cfg.remat,
                         segment_ids=chunk["seg"], positions=chunk["pos"])
        return pe._token_sums(params["heads"][side], h.float(), chunk["owner"], n_seqs,
                              generator=_generator(seed, h.device), **drop)

    def scan_sums(params, esm_params, sides):
        sums, counts = {}, {}
        for side, (chunks, seeds, _) in sides.items():
            sums[side], counts[side] = chunk_sums(params, esm_params, side, chunks[0], seeds[0])
            for chunk, seed in zip(chunks[1:], seeds[1:]):
                s, c = chunk_sums(params, esm_params, side, chunk, seed)
                sums[side], counts[side] = sums[side] + s, counts[side] + c
        return sums, counts

    def tail(params, sums, counts, sides):
        t = params["heads"]["temperature"]
        pep, rec = (pe._finish_pool(params["heads"][side], sums[side], counts[side], t,
                                    generator=_generator(sides[side][2], t.device), **drop)
                    for side in pe.SIDES)
        return loss_fn(pep, rec)

    def prepare(batch, generator):
        packs = _default_expand_sides(batch)
        # constant tokens a chunk across the sides: rows narrower than the
        # widest side's take proportionally more rows a chunk (JAX's rule;
        # the frozen step chunks each side at rows_per_chunk)
        l_max = max(p["ids"].shape[1] for p in packs.values())
        chunks = {side: _chunk_pack(p, rows_per_chunk * (l_max // p["ids"].shape[1]))
                  for side, p in packs.items()}
        # one seed a chunk and the last for the tail's pooled-FFN dropout
        seeds = _chunk_seeds(generator, max(map(len, chunks.values())) + 1)
        return {side: (chunks[side], s[:len(chunks[side])], s[-1])
                for side, s in zip(pe.SIDES, seeds)}

    return chunk_sums, scan_sums, tail, prepare


def make_packed_loss(cfg: EngineConfig, loss_fn: Callable | None = None,
                     rows_per_chunk: int | None = None,
                     view: Callable[[Params, Params], Params] | None = None):
    """loss(params, esm_params, batch, generator): the packed step's loss in
    one graph, with the same chunks and dropout seeds as its two passes
    (the form the two-pass gradients are held against). ``view`` is
    ``make_train_step_packed``'s."""
    _, scan_sums, tail, prepare = _packed_machinery(
        cfg, loss_fn or default_loss_fn(), pe._default_rows_per_chunk(rows_per_chunk),
        view or esm_view(cfg))

    def loss(params, esm_params, batch, generator):
        sides = prepare(batch, generator)
        return tail(params, *scan_sums(params, esm_params, sides), sides)

    return loss


def make_train_step_packed(cfg: EngineConfig, loss_fn: Callable | None = None,
                           rows_per_chunk: int | None = None,
                           view: Callable[[Params, Params], Params] | None = None):
    """The unfrozen step over ``tokenize_packed`` batches of
    ``cfg.global_batch`` pairs (flat packing), with ``make_train_step``'s
    signature; ``view(params, esm_params)`` gives the backbone each chunk
    runs on (default ``esm_view(cfg)``: the f32 master cast to the compute
    dtype).

    Pass 1 adds every chunk's token sums and counts with no graph; the tail
    is differentiated with respect to the parameters it reaches and the
    sums; pass 2 replays each chunk with a graph (remat, K5) and feeds it
    the whole gradient of its side's sums, which the chunk's owner product
    restricts to its own sequences. The counts take no gradient."""
    pe.check_flat(cfg.packed_tiers, cfg.scatter_tiers)
    chunk_sums, scan_sums, tail, prepare = _packed_machinery(
        cfg, loss_fn or default_loss_fn(), pe._default_rows_per_chunk(rows_per_chunk),
        view or esm_view(cfg))

    def step(params, opt_state, esm_params, batch, generator):
        pe._validate_packed_batch(batch, cfg.global_batch)
        sides = prepare(batch, generator)
        with torch.no_grad():
            sums, counts = scan_sums(params, esm_params, sides)
        for t in sums.values():
            t.requires_grad_(True)
        loss = tail(params, sums, counts, sides)
        loss.backward()
        for side, (chunks, seeds, _) in sides.items():
            for chunk, seed in zip(chunks, seeds):
                chunk_sums(params, esm_params, side, chunk, seed)[0].backward(sums[side].grad)
        opt_state.apply()
        return params, opt_state, loss.detach()

    return step


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
