"""Dense products on the tensor cores (kernel P1): s8 x s8 -> s32 for the w8a8
backbone's linear layers, and bf16 x bf16 -> f32.

``mm`` wraps the hand-written CUDA kernel ``csrc/dense_mm.cu``, which
replaces the TPU probe ``tools/probe_int8_pallas.py::_mm_kernel``; the
kernel's note gives its bound on an H100 and what its design does about it.
``models/esm2._dense`` calls it for every quantised layer (q, k, v, o, wi,
wo). On CPU tensors ``mm`` runs the plain ``mm_reference``; on CUDA tensors
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..kernels import build

# out dtype of each operand dtype, and the K multiple the kernel's k-steps
# need (32 bytes: m16n8k32 for s8, m16n8k16 for bf16)
OUT_DTYPE = {torch.int8: torch.int32, torch.bfloat16: torch.float32}
K_MULTIPLE = {torch.int8: 32, torch.bfloat16: 16}
M_MULTIPLE = 8          # columns per mma n-tile
MAX_ROWS = 65535 * 128  # grid.y blocks of 128 rows


def mm_reference(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of P1, exact for s8: int64 products on the CPU; on the
    card f64 products rounded back to int32, exact because every partial sum
    is an integer below 2^53 (|sum| <= K * 128^2, K < 2^38). bf16 -> f32 in
    f32 products (no TF32: the caller keeps ``allow_tf32`` off)."""
    _check_types(x, w, out_dtype)
    if x.dtype == torch.int8:
        if x.device.type == "cpu":
            return torch.matmul(x.long(), w.long()).to(torch.int32)
        return torch.matmul(x.double(), w.double()).round().to(torch.int32)
    return torch.matmul(x.float(), w.float())


def _check_types(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"x must be (N, K) and w (K, M), got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if x.dtype != w.dtype or OUT_DTYPE.get(x.dtype) != out_dtype:
        raise TypeError(f"mm takes int8 x int8 -> int32 or bfloat16 x bfloat16 -> float32, "
                        f"not {x.dtype} x {w.dtype} -> {out_dtype}")


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    N, K = x.shape
    M = w.shape[1]
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    for name, t in (("x", x), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if K % K_MULTIPLE[x.dtype] or K == 0:
        raise ValueError(f"K={K} must be a positive multiple of {K_MULTIPLE[x.dtype]} for "
                         f"{x.dtype}")
    if M % M_MULTIPLE or M == 0:
        raise ValueError(f"M={M} must be a positive multiple of {M_MULTIPLE}")
    if not 0 < N <= MAX_ROWS:
        raise ValueError(f"N={N} must be in [1, {MAX_ROWS}]")


def bind(lib: ctypes.CDLL) -> dict:
    """The C entry points of a loaded dense_mm library by operand dtype: x,
    w, out, N, K, M and the stream."""
    fns = {}
    for dtype, name in ((torch.int8, "pct_dense_mm_s8"), (torch.bfloat16, "pct_dense_mm_bf16")):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[dtype] = fn
    return fns


@functools.cache
def _launchers() -> dict:
    """The kernel's entry points, built and loaded at first use."""
    return bind(build.load("dense_mm"))


def mm(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """(N, K) x (K, M) -> (N, M): int8 -> int32 (exact) or bfloat16 ->
    float32. On CPU tensors ``mm_reference``; on CUDA tensors P1 or an
    error."""
    if x.device.type == "cpu":
        return mm_reference(x, w, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"mm runs on cpu or cuda, not {x.device}")
    _check_types(x, w, out_dtype)
    _check(x, w)
    N, K = x.shape
    M = w.shape[1]
    out = torch.empty(N, M, dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _launchers()[x.dtype](x.data_ptr(), w.data_ptr(), out.data_ptr(), N, K, M,
                                    torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dense_mm launch failed: cudaError_t {err}")
    mm.launches += 1
    return out


# Calls that launched the kernel since the count was last set to 0
# (chip_smoke.py reads it).
mm.launches = 0
