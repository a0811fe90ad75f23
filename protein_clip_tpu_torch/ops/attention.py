"""Segment-masked attention forward for ESM-2's head_dim=32 (kernel K1).

``fused_attention`` is the wrapper of the hand-written CUDA kernel
``csrc/attention_fwd.cu``, which replaces the TPU kernel
``protein_clip_tpu/ops/attention_pallas.py::_kernel``. The kernel's note
gives its bound on an H100 and what its design does about it.

``segments`` is (B, T) int32: 0 marks pads and gaps, and tokens attend iff
their nonzero ids match, so a plain 0/1 attention mask is the one-segment
case. A query row with no allowed key (a pad position) softmaxes to the
uniform average of v over all T keys, as the TPU kernel does; masked mean
pooling multiplies it by 0, so it must be finite.

The backward (TPU ``_bwd_kernel``) is not ported yet: inputs that require
grad are refused.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..kernels import build

HEAD_DIM = 32
_NEG = torch.finfo(torch.float32).min


def check_config(dtype: torch.dtype, head_dim: int) -> None:
    """Raise unless the kernel takes a backbone of this compute dtype and
    head_dim: bf16 at head_dim 32 (ESM-2 t30_150M)."""
    if dtype != torch.bfloat16 or head_dim != HEAD_DIM:
        raise NotImplementedError(
            f"the CUDA attention kernel takes bfloat16 at head_dim {HEAD_DIM}, not "
            f"{dtype} at head_dim {head_dim} (ROADMAP queue 2: K1 for other head "
            "dims and float32); attention_impl='eager' runs the plain form")


@functools.cache
def _launcher():
    """The kernel's C entry point, built and loaded at first use."""
    fn = build.load("attention_fwd").pct_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        segments: torch.Tensor) -> torch.Tensor:
    """Plain version (the TPU package's ``_eager_reference``): scores from
    q.k^T with operands in their own precision and f32 accumulation, the
    segment mask as f32-min, f32 softmax, P cast to q's dtype, P.V in f32,
    output in q's dtype. Materialises the (B, NH, T, T) f32 scores."""
    scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
    seg = segments.to(torch.int32)
    allowed = ((seg[:, None, :, None] == seg[:, None, None, :])
               & (seg[:, None, None, :] > 0))
    probs = torch.softmax(torch.where(allowed, scores, _NEG), dim=-1).to(q.dtype)
    return torch.einsum("bnqk,bknd->bqnd", probs.float(), v.float()).to(q.dtype)


def _check(q, k, v, segments) -> None:
    if q.dim() != 4 or q.shape[-1] != HEAD_DIM:
        raise ValueError(f"q must be (B, T, NH, {HEAD_DIM}), got {tuple(q.shape)}")
    B, T, NH, _ = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q shape {tuple(q.shape)}")
    if segments.shape != (B, T):
        raise ValueError(f"segments must be (B, T) = {(B, T)}, got {tuple(segments.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("segments", segments)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
        if t.requires_grad:
            raise NotImplementedError(
                "fused_attention has no backward on CUDA yet (kernel K5 is "
                "still to port); run it under torch.inference_mode()")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16 on CUDA, got {t.dtype}")
    if segments.dtype != torch.int32:
        raise TypeError(f"segments must be int32, got {segments.dtype}")
    if T < 1 or NH < 1 or NH > 65535 or B < 1 or B > 65535:
        raise ValueError(f"unsupported shape B={B}, T={T}, NH={NH}")


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    segments: torch.Tensor) -> torch.Tensor:
    """(B, T, NH, 32) q, k, v (q already scaled and rotated), (B, T) int32
    segments -> (B, T, NH, 32). On CPU tensors this is the plain version; on
    CUDA tensors it launches the kernel or raises."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, segments)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention runs on cpu or cuda, not {q.device}")
    _check(q, k, v, segments)
    B, T, NH, _ = q.shape
    launch = _launcher()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), segments.data_ptr(),
                     out.data_ptr(), B, T, NH, stream)
    if err != 0:
        raise RuntimeError(f"attention_fwd launch failed: cudaError_t {err}")
    fused_attention.launches += 1
    return out


# Kernel launches since the count was last set to 0 (chip_smoke.py reads it).
fused_attention.launches = 0
