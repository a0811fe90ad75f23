"""Packed rows on the data axis: the port of
``protein_clip_tpu/parallel/packed_step.py``.

The host deals the pairs of the global batch to the shards (equal counts,
balanced by receptor tokens), packs each shard's sequences into its own
rows and stacks them shard-major; each rank runs the packed engine on its
shard's rows (K1 over packed segments on the card), pools or scatters its
own sequences, and the gather makes the negatives span the global batch, as
in ``step.py`` (CLIP) and ``filip_step.py`` (FILIP).

Wire (``tokenize_packed_sharded``), per side:

- ``{side}_ids`` (n_shards * R, L) int8, shard-major: every shard has R
  rows (a multiple of 8), a short shard all-<pad> rows (segment 0
  everywhere: out of attention and pooling);
- ``{side}_operm`` (n_shards, b_local) int32: each shard's owner
  permutation over its LOCAL pair indices; both sides of a pair go to the
  same shard at the same local index, so the gathered order agrees between
  the sides and the InfoNCE diagonal stays aligned;
- ``pair_shard_order`` (B,): the pairs in shard-major order.

A rank keeps its shard's rows and operm (``shard_of``): a flat packed batch
of b_local pairs (``packed_engine.tokenize_packed``'s wire), which the
single-device packed machinery runs unchanged. Flat packing only.
"""

from __future__ import annotations

import warnings
from typing import Callable

import numpy as np
import torch

from ..data.packing import pack_sequences
from ..data.tokenizer import EOS_ID, PAD_ID, EsmTokenizer
from ..ops.filip import filip_similarity_fused
from ..train import packed_engine as pe
from ..train.clip_engine import EngineConfig, _update
from ..train.filip_packed import filip_sim_packed
from .filip_step import gathered_similarity, mesh_row_loss
from .mesh import Mesh, local_batch_size
from .step import check_flat, check_shard, on_rank

__all__ = ["tokenize_packed_sharded", "shard_of", "make_sharded_packed_filip_step",
           "make_sharded_packed_filip_eval_step"]


def _deal_pairs(pep_lens, rec_lens, n_shards: int) -> list[list[int]]:
    """Pair indices per shard, in equal counts, balancing receptor tokens
    (the larger cost): longest first into the lightest shard, then the
    lightest members of over-full shards move to the least-loaded shard
    with room."""
    n = len(rec_lens)
    b_local = n // n_shards
    order = sorted(range(n), key=lambda i: -rec_lens[i])
    shards: list[list[int]] = [[] for _ in range(n_shards)]
    load = [0] * n_shards
    for i in order:
        s = int(np.argmin(load))
        shards[s].append(i)
        load[s] += rec_lens[i]
    for s in range(n_shards):
        while len(shards[s]) > b_local:
            j = min(range(len(shards[s])), key=lambda k: rec_lens[shards[s][k]])
            i = shards[s].pop(j)
            load[s] -= rec_lens[i]
            t = min((u for u in range(n_shards) if len(shards[u]) < b_local),
                    key=lambda u: load[u])
            shards[t].append(i)
            load[t] += rec_lens[i]
    return shards


def tokenize_packed_sharded(tokenizer: EsmTokenizer, peps: list[str], recs: list[str],
                            n_shards: int, pep_row_len: int | None = None,
                            rec_row_len: int | None = None) -> dict[str, torch.Tensor]:
    """Both sides packed per shard and stacked shard-major (module doc). Row
    widths follow each side's longest sequence (``tokenize_packed``'s rule);
    a longer sequence is truncated with its <eos> kept, and warned about."""
    n = len(peps)
    if n % n_shards:
        raise ValueError(f"global batch {n} not divisible by {n_shards}")
    b_local = n // n_shards
    pep_encs = [tokenizer.encode(s) for s in peps]
    rec_encs = [tokenizer.encode(s) for s in recs]
    shards = _deal_pairs([len(e) for e in pep_encs], [len(e) for e in rec_encs], n_shards)

    out = {}
    for side, encs, explicit in (("pep", pep_encs, pep_row_len), ("rec", rec_encs, rec_row_len)):
        row_len = pe._row_len_for(max(len(e) for e in encs), explicit)
        clamped = 0
        clipped = []
        for e in encs:
            if len(e) > row_len:   # keep eos, like tokenize_packed
                e = np.concatenate((e[: row_len - 1], [EOS_ID]))
                clamped += 1
            clipped.append(e)
        if clamped:
            warnings.warn(f"tokenize_packed_sharded: {clamped} {side} sequence(s) longer than "
                          f"row_len={row_len} were truncated (eos kept)", stacklevel=2)
        packs = []
        for members in shards:
            packed = pack_sequences([clipped[i] for i in members], row_len, row_multiple=1)
            packs.append((packed.ids, pe.scan_order_operm(packed,
                                                          np.arange(b_local, dtype=np.int32))))
        r_max = -(-max(p.shape[0] for p, _ in packs) // 8) * 8
        ids = np.full((n_shards, r_max, row_len), PAD_ID, np.int8)
        for s, (p, _) in enumerate(packs):
            ids[s, : p.shape[0]] = p.astype(np.int8)
        out[f"{side}_ids"] = torch.from_numpy(ids.reshape(n_shards * r_max, row_len))
        out[f"{side}_operm"] = torch.from_numpy(np.stack([o for _, o in packs]))
    out["pair_shard_order"] = torch.from_numpy(
        np.concatenate([np.asarray(m, np.int32) for m in shards]))
    return out


def shard_of(batch: dict[str, torch.Tensor], index: int) -> dict[str, torch.Tensor]:
    """Shard ``index``'s part of a ``tokenize_packed_sharded`` batch: its
    rows and its operm, a flat packed batch of b_local pairs."""
    out = {}
    for side in pe.SIDES:
        operm = batch[f"{side}_operm"]
        rows = batch[f"{side}_ids"].shape[0] // operm.shape[0]
        out[f"{side}_ids"] = batch[f"{side}_ids"][index * rows:(index + 1) * rows].contiguous()
        out[f"{side}_operm"] = operm[index].contiguous()
    return out


def make_sharded_packed_filip_step(cfg: EngineConfig, mesh: Mesh):
    """The frozen packed FILIP step over a rank's shard of
    ``tokenize_packed_sharded`` batches of ``cfg.batch_size`` pairs: its
    tokens scattered into one (b_local, L, D) buffer a side (no scatter
    tiers), the receptor side's gathered, its rows of both directions."""
    check_flat(cfg.packed_tiers)
    sim = gathered_similarity(filip_similarity_fused, mesh.data_group)
    loss = mesh_row_loss(mesh, cfg.filip_use_dcl)
    rows_per_chunk = pe._default_rows_per_chunk(None)
    b_local = local_batch_size(cfg.batch_size, mesh)

    def step(params, opt_state, esm_params, batch, generator):
        sim_a, sim_b = filip_sim_packed(params, esm_params, batch, cfg.model, b_local,
                                        rows_per_chunk=rows_per_chunk, train=True,
                                        generator=generator, similarity_fn=sim)
        return _update(loss(sim_a, sim_b), params, opt_state)

    return on_rank(step, mesh, b_local, packed=True)


def make_sharded_packed_filip_eval_step(cfg: EngineConfig, mesh: Mesh, view: Callable):
    """The packed FILIP eval step over a rank's shard, in eval mode, on the
    (heads, backbone) ``view`` gives."""
    sim = gathered_similarity(filip_similarity_fused, mesh.data_group)
    loss = mesh_row_loss(mesh, cfg.filip_use_dcl)
    rows_per_chunk = pe._default_rows_per_chunk(None)

    @torch.inference_mode()
    def step(params, esm_params, batch):
        check_shard(batch, None)
        heads, esm = view(params, esm_params)
        b_local = batch["pep_operm"].shape[0]
        return loss(*filip_sim_packed(heads, esm, batch, cfg.model, b_local,
                                      rows_per_chunk=rows_per_chunk, similarity_fn=sim))

    return step
