"""Segment-masked attention for ESM-2's head_dim=32: forward (kernel K1) and
backward (kernel K5).

``fused_attention`` is a ``torch.autograd.Function`` over two hand-written
CUDA kernels: ``csrc/attention_fwd.cu`` (K1), which replaces the TPU kernel
``protein_clip_tpu/ops/attention_pallas.py::_kernel``, and
``csrc/attention_bwd.cu`` (K5), which replaces ``_bwd_kernel``; both share
``csrc/attention.cuh`` (wgmma on a cp.async tile ring, exact tile skipping
by segment ranges). Each kernel's note gives its bound on an H100 and what
its design does about it. When a gradient is wanted, K1 also returns the
base-2 log-sum-exp of each query's masked scores (``attention_reference_lse``
is its plain version), and the Function saves it beside q, k, v and the
segments: K5 takes P from it, where the TPU ``custom_vjp`` saves q, k, v
and the segments alone and recomputes the softmax statistics.

``segments`` is (B, T) int32: 0 marks pads and gaps, and tokens attend iff
their nonzero ids match, so a plain 0/1 attention mask is the one-segment
case. A query row with no allowed key (a pad position) softmaxes to the
uniform average of v over all T keys, as the TPU kernel does; masked mean
pooling multiplies it by 0, so it must be finite. In the backward that
uniform row still feeds dv, but the re-mask of dS gives it no dq or dk.

On CPU tensors both directions run the plain versions
(``attention_reference``, ``attention_reference_bwd``); on CUDA tensors
they launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..kernels import build

HEAD_DIM = 32
MAX_T = 65536               # the kernels keep one segment range per 64-token tile
_NEG = torch.finfo(torch.float32).min
_LOG2E = 1.4426950408889634


def check_config(dtype: torch.dtype, head_dim: int) -> None:
    """Raise unless the kernel takes a backbone of this compute dtype and
    head_dim: bf16 at head_dim 32 (ESM-2 t30_150M)."""
    if dtype != torch.bfloat16 or head_dim != HEAD_DIM:
        raise NotImplementedError(
            f"the CUDA attention kernel takes bfloat16 at head_dim {HEAD_DIM}, not "
            f"{dtype} at head_dim {head_dim} (ROADMAP queue 2: K1 for other head "
            "dims and float32); attention_impl='eager' runs the plain form")


_POINTERS = {"attention_fwd": 6, "attention_bwd": 10}


def bind(lib: ctypes.CDLL, name: str):
    """Kernel ``name``'s C entry point in ``lib``: its pointers (q, k, v,
    segments, then inputs, outputs and scratch), B, T, NH and the stream."""
    fn = getattr(lib, f"pct_{name}")
    fn.argtypes = [ctypes.c_void_p] * _POINTERS[name] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _launcher(name: str):
    """Kernel ``name``'s entry point, built and loaded at first use."""
    return bind(build.load(name), name)


def _allowed(segments: torch.Tensor) -> torch.Tensor:
    """(B, 1, Tq, Tk) bool: the key shares the query's segment and is no pad."""
    seg = segments.to(torch.int32)
    return (seg[:, None, :, None] == seg[:, None, None, :]) & (seg[:, None, None, :] > 0)


def _masked_scores(q, k, segments) -> tuple[torch.Tensor, torch.Tensor]:
    """(allowed, f32 scores q.k^T with f32-min where not allowed), both
    (B, NH, T, T)."""
    scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
    allowed = _allowed(segments)
    return allowed, torch.where(allowed, scores, _NEG)


def _probs(q, k, segments) -> tuple[torch.Tensor, torch.Tensor]:
    """(allowed, f32 softmax of the masked scores), both (B, NH, T, T)."""
    allowed, masked = _masked_scores(q, k, segments)
    return allowed, torch.softmax(masked, dim=-1)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        segments: torch.Tensor) -> torch.Tensor:
    """Plain version of K1 (the TPU package's ``_eager_reference``): scores
    from q.k^T with operands in their own precision and f32 accumulation,
    the segment mask as f32-min, f32 softmax, P cast to q's dtype, P.V in
    f32, output in q's dtype. Materialises the (B, NH, T, T) f32 scores."""
    probs = _probs(q, k, segments)[1].to(q.dtype)
    return torch.einsum("bnqk,bknd->bqnd", probs.float(), v.float()).to(q.dtype)


def attention_reference_lse(q: torch.Tensor, k: torch.Tensor,
                            segments: torch.Tensor) -> torch.Tensor:
    """Plain version of K1's second output: (B, NH, T) f32, the log-sum-exp
    of each query's masked scores (f32-min where not allowed) in base 2,
    log2(e) * logsumexp. A pad query's scores are all f32-min, so its
    log-sum-exp rounds to f32-min and times log2(e) to -inf."""
    return torch.logsumexp(_masked_scores(q, k, segments)[1], dim=-1) * _LOG2E


def attention_reference_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            segments: torch.Tensor, do: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K5, step by step as the TPU ``_bwd_row`` computes
    it: recompute P in f32 from q and k under the segment mask; dP = dO.V^T;
    delta = rowsum(P * dP); dS = P * (dP - delta) where allowed, else 0,
    cast to q's dtype; dq = dS.k, dk = dS^T.q, dv = bf16(P)^T.dO, each
    accumulated in f32 and returned in q's dtype. The re-mask matters at a
    fully padded query row: its P is uniform (every score f32-min), which
    feeds dv but gives no dq or dk."""
    do = do.to(q.dtype)
    allowed, p = _probs(q, k, segments)
    dp = torch.einsum("bqnd,bknd->bnqk", do.float(), v.float())
    delta = (p * dp).sum(-1, keepdim=True)
    ds = torch.where(allowed, p * (dp - delta), 0.0).to(q.dtype).float()
    p_c = p.to(v.dtype).float()
    dq = torch.einsum("bnqk,bknd->bqnd", ds, k.float())
    dk = torch.einsum("bnqk,bqnd->bknd", ds, q.float())
    dv = torch.einsum("bnqk,bqnd->bknd", p_c, do.float())
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _check(segments, *tensors) -> None:
    q = tensors[0]
    if q.dim() != 4 or q.shape[-1] != HEAD_DIM:
        raise ValueError(f"q must be (B, T, NH, {HEAD_DIM}), got {tuple(q.shape)}")
    B, T, NH, _ = q.shape
    names = ("q", "k", "v", "do")
    for name, t in zip(names[1:], tensors[1:]):
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q shape {tuple(q.shape)}")
    if segments.shape != (B, T):
        raise ValueError(f"segments must be (B, T) = {(B, T)}, got {tuple(segments.shape)}")
    for name, t in (*zip(names, tensors), ("segments", segments)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    for name, t in zip(names, tensors):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16 on CUDA, got {t.dtype}")
    if segments.dtype != torch.int32:
        raise TypeError(f"segments must be int32, got {segments.dtype}")
    if T < 1 or T > MAX_T or NH < 1 or NH > 65535 or B < 1 or B > 65535:
        raise ValueError(f"unsupported shape B={B}, T={T}, NH={NH}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _forward(q, k, v, segments, with_lse: bool = False):
    """K1's output, and with ``with_lse`` its (B, NH, T) f32 statistics too
    (``attention_reference_lse``); without, the kernel writes and allocates
    none."""
    if q.device.type == "cpu":
        out = attention_reference(q, k, v, segments)
        return (out, attention_reference_lse(q, k, segments)) if with_lse else out
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention runs on cpu or cuda, not {q.device}")
    _check(segments, q, k, v)
    B, T, NH, _ = q.shape
    launch = _launcher("attention_fwd")
    out = torch.empty_like(q)
    lse = torch.empty(B, NH, T, dtype=torch.float32, device=q.device) if with_lse else None
    with torch.cuda.device(q.device):
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), segments.data_ptr(),
                     out.data_ptr(), lse.data_ptr() if with_lse else None, B, T, NH,
                     _stream(q.device))
    if err != 0:
        raise RuntimeError(f"attention_fwd launch failed: cudaError_t {err}")
    fused_attention.launches += 1
    return (out, lse) if with_lse else out


def fused_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        segments: torch.Tensor, do: torch.Tensor,
                        lse: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``fused_attention`` for the cotangent ``do``, all
    (B, T, NH, 32), given the forward's statistics ``lse`` ((B, NH, T)
    f32, ``_forward(..., with_lse=True)``). On CPU tensors this is
    ``attention_reference_bwd``, which recomputes them (``lse`` may be
    None); on CUDA tensors it launches K5 (two launches: delta and dq, then
    dk and dv) or raises."""
    if q.device.type == "cpu":
        return attention_reference_bwd(q, k, v, segments, do)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention_bwd runs on cpu or cuda, not {q.device}")
    do = do.to(q.dtype).contiguous()
    _check(segments, q, k, v, do)
    B, T, NH, _ = q.shape
    if (lse is None or lse.shape != (B, NH, T) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        got = "None" if lse is None else f"{lse.dtype} {tuple(lse.shape)} on {lse.device}"
        raise ValueError(f"lse must be contiguous float32 (B, NH, T) = {(B, NH, T)} on "
                         f"{q.device}, got {got}")
    launch = _launcher("attention_bwd")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty(B, NH, T, dtype=torch.float32, device=q.device)  # rowsum(P * dP)
    with torch.cuda.device(q.device):
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), segments.data_ptr(),
                     do.data_ptr(), lse.data_ptr(), dq.data_ptr(),
                     dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), B, T, NH,
                     _stream(q.device))
    if err != 0:
        raise RuntimeError(f"attention_bwd launch failed: cudaError_t {err}")
    fused_attention_bwd.launches += 1
    return dq, dk, dv


class _FusedAttention(torch.autograd.Function):
    """K1 forward, K5 backward; the plain versions on CPU tensors. K1 writes
    its statistics only when the caller wants a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, segments, want_grad):
        if not want_grad:
            return _forward(q, k, v, segments)
        if q.device.type == "cpu":  # the plain backward recomputes the statistics
            out, lse = _forward(q, k, v, segments), None
        else:
            out, lse = _forward(q, k, v, segments, with_lse=True)
        ctx.save_for_backward(q, k, v, segments, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, segments, lse = ctx.saved_tensors
        return (*fused_attention_bwd(q, k, v, segments, do, lse), None, None)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    segments: torch.Tensor) -> torch.Tensor:
    """(B, T, NH, 32) q, k, v (q already scaled and rotated), (B, T) int32
    segments -> (B, T, NH, 32), differentiable in q, k and v. On CPU tensors
    the plain versions; on CUDA tensors K1 (and K5 in the backward) or an
    error."""
    want_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return _FusedAttention.apply(q, k, v, segments, want_grad)


# Kernel launches since the counts were last set to 0 (chip_smoke.py reads
# them): K1 calls of the forward, K5 calls of the backward.
fused_attention.launches = 0
fused_attention_bwd.launches = 0
