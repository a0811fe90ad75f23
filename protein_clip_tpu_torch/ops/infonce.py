"""Symmetric InfoNCE for dual-encoder contrastive training (kernels K2, K3).

The port of ``protein_clip_tpu/ops/infonce.py`` (the plain versions
``clip_infonce``, ``infonce_from_logits``, ``naive_infonce_from_logits``)
and of ``protein_clip_tpu/ops/infonce_pallas.py`` (the fused loss). With
(B, D) embeddings x, y already scaled by exp(t/2) each, ``logits = x y^T``
carries exp(t) and

    loss = 0.5 * (mean_i(lse_row_i - diag_i) + mean_j(lse_col_j - diag_j)).

``fused_infonce`` (K2, single-shot) and ``fused_infonce_tiled`` (K3, large
pools) are ``torch.autograd.Function`` wrappers of the hand-written CUDA
kernels in ``csrc/infonce.cu``, forward and backward; the kernel's note
gives their bound on an H100 and what the design does about it. On CPU
tensors each is the plain ``clip_infonce`` (autograd through plain torch
ops); on CUDA tensors it launches its kernels or raises. The temperature's
gradient flows outside the kernel, through the exp(t/2) scaling of the
embeddings, so the kernels return the gradients of x and y only.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..kernels import build

MAX_DIM = 256          # embedding dims the kernels take (multiples of 4)
MAX_POOL = 65536       # the forward's partials take pool^2 / 4 bytes of scratch
TILE = 64              # rows of a logit tile (csrc/infonce.cu)


def infonce_from_logits(logits: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    diag = torch.diagonal(logits)
    l_r = torch.mean(torch.logsumexp(logits, dim=1) - diag)
    l_p = torch.mean(torch.logsumexp(logits, dim=0) - diag)
    return 0.5 * (l_r + l_p)


def clip_infonce(pep: torch.Tensor, rec: torch.Tensor) -> torch.Tensor:
    """Plain version: symmetric InfoNCE over scaled embeddings, stable
    log-sum-exp form, logits in f32."""
    return infonce_from_logits(torch.matmul(pep.float(), rec.float().T))


def naive_infonce_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """The reference's exp-then-log recipe, as a parity oracle only: it
    overflows once the temperature grows."""
    logits = logits.float()
    exp_logits = torch.exp(logits)
    diag = torch.diagonal(logits)
    l_r = -torch.mean(torch.log(torch.exp(diag) / exp_logits.sum(1)))
    l_p = -torch.mean(torch.log(torch.exp(diag) / exp_logits.sum(0)))
    return 0.5 * (l_r + l_p)


def scratch_floats(b: int) -> int:
    """Floats of the forward's scratch (csrc/infonce.cu ``Scratch``): row
    and column (max, sum) partials of every tile, diag, and the per-block
    loss terms of K3's combine."""
    nb = -(-b // TILE)
    return 4 * nb * b + b + -(-b // 256)


def backward_splits(b: int, sm_count: int) -> tuple[int, int]:
    """(splits, tiles per split) of the backward's loop over the other
    side's 64-row tiles: about two blocks (row blocks x splits x 2 roles)
    per SM where the pool has that many tiles, rounded to whole tiles per
    split, and no split empty."""
    nb = -(-b // TILE)
    want = min(nb, -(-sm_count // nb))
    per = -(-nb // want)
    return -(-nb // per), per


@functools.cache
def _launchers():
    """The kernels' C entry points, built and loaded at first use."""
    lib = build.load("infonce")
    fns = {}
    for name, n_ptr, n_int in (("pct_infonce_fwd", 7, 2), ("pct_infonce_tiled_fwd", 7, 2),
                               ("pct_infonce_bwd", 8, 4)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _check(x: torch.Tensor, y: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape != y.shape:
        raise ValueError(f"x and y must both be (B, D), got {tuple(x.shape)} and "
                         f"{tuple(y.shape)}")
    B, D = x.shape
    for name, t in (("x", x), ("y", y)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on CUDA, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if D % 4 or not 0 < D <= MAX_DIM:
        raise ValueError(f"embedding dim D={D} must be a multiple of 4 in [4, {MAX_DIM}]")
    if not 0 < B <= MAX_POOL:
        raise ValueError(f"pool size B={B} must be in [1, {MAX_POOL}]")


def _launch(name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _launchers()[name](*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


class _InfoNCE(torch.autograd.Function):
    """Forward and backward through the kernels; ``tiled`` picks K3."""

    @staticmethod
    def forward(ctx, x, y, tiled: bool):
        _check(x, y)
        B, D = x.shape
        dev = x.device
        loss = torch.empty((), dtype=torch.float32, device=dev)
        lse_r = torch.empty(B, dtype=torch.float32, device=dev)
        lse_c = torch.empty(B, dtype=torch.float32, device=dev)
        scratch = torch.empty(scratch_floats(B), dtype=torch.float32, device=dev)
        ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        _launch("pct_infonce_tiled_fwd" if tiled else "pct_infonce_fwd", dev, x.data_ptr(),
                y.data_ptr(), scratch.data_ptr(), ticket.data_ptr(), loss.data_ptr(),
                lse_r.data_ptr(), lse_c.data_ptr(), B, D)
        (fused_infonce_tiled if tiled else fused_infonce).launches += 1
        ctx.save_for_backward(x, y, lse_r, lse_c)
        ctx.tiled = tiled
        return loss

    @staticmethod
    def backward(ctx, g):
        x, y, lse_r, lse_c = ctx.saved_tensors
        B, D = x.shape
        g = g.to(torch.float32).contiguous()
        dx, dy = torch.empty_like(x), torch.empty_like(y)
        splits, per = backward_splits(B, torch.cuda.get_device_properties(
            x.device).multi_processor_count)
        part = torch.empty(2 * splits * B * D if splits > 1 else 0, dtype=torch.float32,
                           device=x.device)
        _launch("pct_infonce_bwd", x.device, x.data_ptr(), y.data_ptr(), lse_r.data_ptr(),
                lse_c.data_ptr(), g.data_ptr(), dx.data_ptr(), dy.data_ptr(), part.data_ptr(),
                B, D, splits, per)
        (fused_infonce_tiled if ctx.tiled else fused_infonce).bwd_launches += 1
        return dx, dy, None


def _fused(x: torch.Tensor, y: torch.Tensor, tiled: bool) -> torch.Tensor:
    if x.device.type == "cpu":
        return clip_infonce(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"fused InfoNCE runs on cpu or cuda, not {x.device}")
    return _InfoNCE.apply(x, y, tiled)


def fused_infonce(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K2: (B, D) f32 x, y -> scalar loss, with its backward. On CPU tensors
    the plain ``clip_infonce``; on CUDA tensors the kernels or an error."""
    return _fused(x, y, False)


def fused_infonce_tiled(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K3: as ``fused_infonce``, for pools past ``fused_infonce_fits``."""
    return _fused(x, y, True)


# Forward and backward calls that launched the kernels since the counts were
# last set to 0 (chip_smoke.py reads them).
fused_infonce.launches = fused_infonce.bwd_launches = 0
fused_infonce_tiled.launches = fused_infonce_tiled.bwd_launches = 0
