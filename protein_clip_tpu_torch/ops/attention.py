"""Segment-masked attention for ESM-2's head dims (16, 24, 32, 64, 128), in
bf16 or f32: forward (kernel K1) and backward (kernel K5).

``fused_attention`` is a ``torch.autograd.Function`` over hand-written CUDA
kernels that replace the TPU kernels
``protein_clip_tpu/ops/attention_pallas.py::_kernel`` (K1) and
``_bwd_kernel`` (K5), which take q's dtype, bf16 or f32:

- bf16: ``csrc/attention_fwd.cu`` (K1) and ``csrc/attention_bwd.cu`` (K5),
  sharing ``csrc/attention.cuh`` (wgmma on a cp.async tile ring, exact tile
  skipping by segment ranges), each instantiated at head dims 16, 24, 32,
  64 and 128 (24 in 32-wide tiles);
- f32 (``--esm-dtype float32``): ``csrc/attention_fwd_f32.cu`` (K1-f32) and
  ``csrc/attention_bwd_f32.cu`` (K5-f32), sharing ``csrc/attention_f32.cuh``
  (f32-accurate 3xTF32 products on wgmma: each operand split into tf32 hi
  and lo, the streamed tiles turned K-major and split by a producer
  warpgroup) and ``attention.cuh``'s segment logic, at the same head dims.

Each kernel's note gives its bound on an H100 and what its design does
about it. When a gradient is wanted, K1 also returns the base-2 log-sum-exp
of each query's masked scores (``attention_reference_lse`` is its plain
version), and the Function saves it beside q, k, v and the segments (and,
in f32, K1's output, from which K5-f32 forms rowsum(dO * O)): K5 takes P
from it, where the TPU ``custom_vjp`` saves q, k, v and the segments alone
and recomputes the softmax statistics.

``segments`` is (B, T) int32: 0 marks pads and gaps, and tokens attend iff
their nonzero ids match, so a plain 0/1 attention mask is the one-segment
case. A query row with no allowed key (a pad position) softmaxes to the
uniform average of v over all T keys, as the TPU kernel does; masked mean
pooling multiplies it by 0, so it must be finite. In the backward that
uniform row still feeds dv, but the re-mask of dS gives it no dq or dk.

On CPU tensors both directions run the plain versions
(``attention_reference``, ``attention_reference_bwd``); on CUDA tensors
they launch the kernels of the tensors' dtype or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..kernels import build

# ESM-2's head dims: t6_8M, t12_35M, t30_150M, t33_650M and t36_3B, t48_15B
HEAD_DIMS = (16, 24, 32, 64, 128)
DTYPES = (torch.bfloat16, torch.float32)
MAX_T = 65536               # the kernels keep one segment range per 64-token tile
_NEG = torch.finfo(torch.float32).min
_LOG2E = 1.4426950408889634


def _refusal(dtype, head_dim: int) -> NotImplementedError:
    return NotImplementedError(
        f"the CUDA attention kernels take bfloat16 or float32 at head_dim "
        f"{', '.join(map(str, HEAD_DIMS))}, not {dtype} at head_dim {head_dim}; "
        "attention_impl='eager' runs the plain form")


def check_config(dtype: torch.dtype, head_dim: int) -> None:
    """Raise unless the kernels take a backbone of this compute dtype and
    head_dim: bf16 or f32 at every ESM-2 head dim (HEAD_DIMS)."""
    if dtype not in DTYPES or head_dim not in HEAD_DIMS:
        raise _refusal(dtype, head_dim)


_POINTERS = {"attention_fwd": 6, "attention_bwd": 10,
             "attention_fwd_f32": 6, "attention_bwd_f32": 11}


def bind(lib: ctypes.CDLL, name: str):
    """Kernel ``name``'s C entry point in ``lib``: its pointers (q, k, v,
    segments, then inputs, outputs and scratch), B, T, NH, the head dim and
    the stream. ``name`` is one of ``_POINTERS``: K1 and K5 in bf16, and
    with ``_f32`` their f32 kernels."""
    fn = getattr(lib, f"pct_{name}")
    fn.argtypes = [ctypes.c_void_p] * _POINTERS[name] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
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
    """Raise unless the kernels take these CUDA-shaped operands: q, k, v
    (and dO) (B, T, NH, dh) at a head dim of HEAD_DIMS, all bf16 or all
    f32, contiguous, 16-byte aligned, on one device; segments (B, T)
    int32."""
    q = tensors[0]
    if q.dim() != 4:
        raise ValueError(f"q must be (B, T, NH, head_dim), got {tuple(q.shape)}")
    B, T, NH, dh = q.shape
    if dh not in HEAD_DIMS:
        raise _refusal(q.dtype, dh)
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
    if q.dtype not in DTYPES:
        raise TypeError(f"q must be bfloat16 or float32 on CUDA, got {q.dtype}")
    for name, t in zip(names[1:], tensors[1:]):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype} like q on CUDA, got {t.dtype}")
    if segments.dtype != torch.int32:
        raise TypeError(f"segments must be int32, got {segments.dtype}")
    if T < 1 or T > MAX_T or NH < 1 or NH > 65535 or B < 1 or B > 65535:
        raise ValueError(f"unsupported shape B={B}, T={T}, NH={NH}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _kernel(name: str, dtype: torch.dtype) -> str:
    """The kernel ``name`` (attention_fwd, attention_bwd) of ``dtype``."""
    return name if dtype == torch.bfloat16 else f"{name}_f32"


# Kernel launches since the counts were last set to 0 (chip_smoke.py reads
# them), by kernel: K1 calls of the forward and K5 calls of the backward, in
# bf16 (attention_fwd, attention_bwd) and in f32 (the same names with _f32).
launches = {_kernel(name, dtype): 0 for dtype in DTYPES
            for name in ("attention_fwd", "attention_bwd")}


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
    B, T, NH, dh = q.shape
    name = _kernel("attention_fwd", q.dtype)
    launch = _launcher(name)
    out = torch.empty_like(q)
    lse = torch.empty(B, NH, T, dtype=torch.float32, device=q.device) if with_lse else None
    with torch.cuda.device(q.device):
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), segments.data_ptr(),
                     out.data_ptr(), lse.data_ptr() if with_lse else None, B, T, NH, dh,
                     _stream(q.device))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    launches[name] += 1
    return (out, lse) if with_lse else out


def fused_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        segments: torch.Tensor, do: torch.Tensor,
                        lse: torch.Tensor | None, out: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``fused_attention`` for the cotangent ``do``, all
    (B, T, NH, dh), given the forward's statistics ``lse`` ((B, NH, T)
    f32, ``_forward(..., with_lse=True)``) and, for f32 operands, its output
    ``out``. On CPU tensors this is ``attention_reference_bwd``, which
    recomputes them (``lse`` and ``out`` may be None); on CUDA tensors it
    launches K5 in q's dtype (two launches: delta and dq, then dk and dv) or
    raises."""
    if q.device.type == "cpu":
        return attention_reference_bwd(q, k, v, segments, do)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention_bwd runs on cpu or cuda, not {q.device}")
    do = do.to(q.dtype).contiguous()
    _check(segments, q, k, v, do)
    B, T, NH, dh = q.shape
    if (lse is None or lse.shape != (B, NH, T) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        got = "None" if lse is None else f"{lse.dtype} {tuple(lse.shape)} on {lse.device}"
        raise ValueError(f"lse must be contiguous float32 (B, NH, T) = {(B, NH, T)} on "
                         f"{q.device}, got {got}")
    f32 = q.dtype == torch.float32
    if f32:  # K5-f32 forms delta = rowsum(dO * O) from K1-f32's output
        if (out is None or out.shape != q.shape or out.dtype != q.dtype
                or out.device != q.device or not out.is_contiguous() or out.data_ptr() % 16):
            got = "None" if out is None else f"{out.dtype} {tuple(out.shape)} on {out.device}"
            raise ValueError(f"out (the forward's output) must be contiguous, 16-byte aligned "
                             f"and like q for the float32 backward, got {got}")
    name = _kernel("attention_bwd", q.dtype)
    launch = _launcher(name)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty(B, NH, T, dtype=torch.float32, device=q.device)  # rowsum(P * dP)
    ins = (q, k, v, segments, *((out,) if f32 else ()), do, lse)
    with torch.cuda.device(q.device):
        err = launch(*(t.data_ptr() for t in (*ins, dq, dk, dv, delta)), B, T, NH, dh,
                     _stream(q.device))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    launches[name] += 1
    return dq, dk, dv


class _FusedAttention(torch.autograd.Function):
    """K1 forward, K5 backward; the plain versions on CPU tensors. K1 writes
    its statistics only when the caller wants a gradient; in f32 the
    Function also saves K1's output for K5-f32 (the o projection keeps it
    alive anyway)."""

    @staticmethod
    def forward(ctx, q, k, v, segments, want_grad):
        if not want_grad:
            return _forward(q, k, v, segments)
        if q.device.type == "cpu":  # the plain backward recomputes the statistics
            out, lse = _forward(q, k, v, segments), None
        else:
            out, lse = _forward(q, k, v, segments, with_lse=True)
        saved_out = out if q.dtype == torch.float32 and q.device.type == "cuda" else None
        ctx.save_for_backward(q, k, v, segments, lse, saved_out)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, segments, lse, out = ctx.saved_tensors
        return (*fused_attention_bwd(q, k, v, segments, do, lse, out), None, None)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    segments: torch.Tensor) -> torch.Tensor:
    """(B, T, NH, dh) q, k, v (q already scaled and rotated), (B, T) int32
    segments -> (B, T, NH, dh), differentiable in q, k and v. On CPU tensors
    the plain versions, at any dh and dtype; on CUDA tensors K1 (and K5 in
    the backward) in bf16 or f32 at a head dim of HEAD_DIMS, or an error."""
    want_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return _FusedAttention.apply(q, k, v, segments, want_grad)


