"""The process group behind the mesh: the port of
``protein_clip_tpu/parallel/distributed.py``, over ``torch.distributed``.

The TPU package runs one process a host, its chips joined by
``jax.distributed``; here every device is a rank of its own: NCCL between
CUDA devices, gloo between CPU ranks (a caller may name the backend, as
``chip_smoke.py``'s two ranks on one card do). Rendezvous is TCP: at a
``host:port`` the caller gives (``--coordinator``), at a free localhost port
for ranks a process starts itself (``spawn``), or ``env://`` under
``torchrun``.

The collectives of the sharded steps over an axis of the mesh (``group``: a
process subgroup, the mesh's data group in the steps; None: every rank),
each with its autograd transpose, as JAX differentiates a ``shard_map``
body under ``check_vma=False``:

- ``gather_rows``: every rank's rows, rank-major (``all_gather_into_tensor``);
  its backward sums each rank's cotangent for a rank's rows there
  (``reduce_scatter_tensor``);
- ``global_sum``: the sum over the ranks (``all_reduce``); its backward is
  the same sum of the cotangents;
- ``pmean_grads``: every trainable leaf's gradient averaged over the ranks,
  in buckets of at most ``BUCKET_BYTES`` (a larger gradient in place), so
  the step holds one bucket's copy beside its gradients, not a second copy
  of them all.

Every rank differentiates its own copy of the replicated loss, so the
transposes hand each rank ``world_size`` times its share of the gradient,
and the mean, not the sum, is the gradient of the one global loss (the TPU
package's ``pmean`` after the gather's transpose).

The model axis (tensor parallelism, ``ModelAxis``) has Megatron's two
operators over its group: ``copy_to_model`` (identity forward, the
cotangents summed backward) where a replicated activation enters the
column-parallel linears, and ``reduce_from_model`` (summed forward,
identity backward) after the row-parallel ones; and, for the int8 row
product, ``all_max`` (the per-token scale) and ``all_sum`` (the int32
partial products), which take no gradient. Only collectives that torch
2.11 and 2.13 both have are used, on gloo (CPU and CUDA tensors) and NCCL.
"""

from __future__ import annotations

import dataclasses
import socket
import warnings
from typing import Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# torch 2.13 names the tensor collectives ``*_single`` and warns on the old
# names; torch 2.11 has only the old ones
_DEPRECATED = r"`torch\.distributed\.(all_gather_into_tensor|reduce_scatter_tensor)` is deprecated"


def backend_for(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def free_port() -> int:
    """A TCP port free on localhost now, for a rendezvous this process hosts."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize(rank: int, world_size: int, init_method: str, backend: str,
               device: torch.device | None = None) -> None:
    """Join the process group as ``rank`` of ``world_size``: ``init_method``
    is ``tcp://host:port`` or ``env://``. ``device`` is the rank's CUDA
    device (made current first; ``cuda`` alone: the current one), which
    NCCL binds to."""
    kwargs = {}
    if device is not None and device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        if backend == "nccl":
            kwargs["device_id"] = device
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kwargs)


def shutdown() -> None:
    if is_initialized():
        dist.destroy_process_group()


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_primary() -> bool:
    """True on the rank that writes the run's files (rank 0, or no group)."""
    return rank() == 0


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank (a picklable value)."""
    if not is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _rank_main(local_rank: int, fn: Callable, fn_args: tuple, base_rank: int, world: int,
               init_method: str, backend: str, cards: list[int] | None, threads: int) -> None:
    torch.set_num_threads(threads)
    device = torch.device("cuda", cards[local_rank]) if cards is not None else None
    initialize(base_rank + local_rank, world, init_method, backend, device)
    try:
        fn(local_rank, *fn_args)
    finally:
        shutdown()


def spawn(fn: Callable, fn_args: tuple, nprocs: int, *, world: int, init_method: str,
          backend: str, device_type: str, base_rank: int = 0,
          cards: list[int] | None = None) -> None:
    """Start ``nprocs`` ranks (spawned processes), ranks ``base_rank`` ...
    ``base_rank + nprocs - 1`` of a world of ``world``, each calling
    ``fn(local_rank, *fn_args)`` inside the process group; wait for all.
    A rank's error is raised here after the others are stopped. CPU ranks
    split this process's threads between them; CUDA rank j takes card j, or
    ``cards[j]`` (ranks that share a card under gloo, as ``chip_smoke.py``
    runs two on its one card; the training CLIs never share one)."""
    threads = max(1, torch.get_num_threads() // nprocs) if device_type == "cpu" else 1
    if device_type == "cuda" and cards is None:
        cards = list(range(nprocs))
    mp.start_processes(_rank_main, args=(fn, fn_args, base_rank, world, init_method, backend,
                                         cards if device_type == "cuda" else None, threads),
                       nprocs=nprocs, start_method="spawn")


def group_size(group=None) -> int:
    """The ranks of ``group`` (None: every rank)."""
    return dist.get_world_size(group) if is_initialized() else 1


def _all_gather(out: torch.Tensor, x: torch.Tensor, group=None) -> None:
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=_DEPRECATED)
        dist.all_gather_into_tensor(out, x, group=group)


def _reduce_scatter(out: torch.Tensor, x: torch.Tensor, group=None) -> None:
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=_DEPRECATED)
        dist.reduce_scatter_tensor(out, x, group=group)


def _all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = x.new_empty((group_size(group) * x.shape[0], *x.shape[1:]))
        _all_gather(out, x, group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        out = grad.new_empty((grad.shape[0] // group_size(ctx.group), *grad.shape[1:]))
        _reduce_scatter(out, grad, ctx.group)
        return out, None


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """(ranks * b, ...) from every rank's (b, ...) of ``group``, its r-th
    rank's rows at r * b; the backward sums the ranks' cotangents of this
    rank's rows. Without a process group (a world of one) ``x`` itself."""
    return _GatherRows.apply(x, group) if is_initialized() else x


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


def global_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``; the backward sums the
    cotangents. Without a process group ``x`` itself."""
    return _GlobalSum.apply(x, group) if is_initialized() else x


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """A rank's place on the mesh's 'model' axis: ``size`` ranks hold one
    slice each of the sharded weights, this rank slice ``index``; ``group``
    is the process subgroup of the ranks that share its data index."""
    size: int
    index: int
    group: object = dataclasses.field(default=None, compare=False, repr=False)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.contiguous(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.contiguous(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """Megatron's entry to the column-parallel linears: ``x`` forward (it is
    replicated over the model group), the model ranks' cotangents summed
    backward (each rank's holds only its columns' share)."""
    return _CopyToModel.apply(x, axis.group)


def reduce_from_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """Megatron's exit of the row-parallel linears: the model ranks' partial
    products summed forward, the cotangent as it is backward (the sum is
    replicated)."""
    return _ReduceFromModel.apply(x, axis.group)


def all_max(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the model group (no gradient)."""
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=axis.group)
    return out


def all_sum(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """The sum of ``x`` over the model group, in its own dtype (int32 for
    the s8 partial products: exact), with no gradient."""
    return _all_reduce(x.detach(), axis.group)


BUCKET_BYTES = 32 * 2 ** 20


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _reduce_bucket(bucket: list[torch.Tensor], n: int, group=None) -> None:
    flat = torch.cat([g.reshape(-1) for g in bucket])
    dist.all_reduce(flat, group=group)
    flat /= n
    for g, part in zip(bucket, flat.split([g.numel() for g in bucket])):
        g.copy_(part.view_as(g))


def pmean_grads(leaves: list[torch.Tensor], group=None) -> None:
    """Average the leaves' ``.grad`` over the ranks of ``group`` in place: a contiguous
    gradient of at least ``BUCKET_BYTES`` with one ``all_reduce`` where it
    lies, the others of a dtype flattened together in buckets of at most
    ``BUCKET_BYTES``, one ``all_reduce`` a bucket. Every rank takes the same
    leaves (a leaf with no gradient has none on every rank: the ranks run
    the same code on batches of one shape), so the buckets agree. Without a
    process group nothing changes."""
    if not is_initialized():
        return
    n = group_size(group)
    pending: dict[torch.dtype, list[torch.Tensor]] = {}
    for g in (t.grad for t in leaves if t.grad is not None):
        if _nbytes(g) >= BUCKET_BYTES and g.is_contiguous():
            dist.all_reduce(g, group=group)
            g /= n
            continue
        bucket = pending.setdefault(g.dtype, [])
        if sum(map(_nbytes, bucket)) + _nbytes(g) > BUCKET_BYTES:
            _reduce_bucket(bucket, n, group)
            bucket.clear()
        bucket.append(g)
    for bucket in pending.values():
        if bucket:
            _reduce_bucket(bucket, n, group)


def psum_grads(leaves: list[torch.Tensor], group) -> None:
    """Sum the leaves' ``.grad`` over the ranks of ``group`` in place (one
    ``all_reduce`` a leaf): the model group's partial gradients of a
    replicated leaf used only inside the sharded region (LoRA adapters)."""
    if not is_initialized():
        return
    for t in leaves:
        if t.grad is not None:
            dist.all_reduce(t.grad, group=group)
