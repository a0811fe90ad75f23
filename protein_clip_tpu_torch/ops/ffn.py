"""The FFN input projection with its gelu fused in (kernel K6), under
``PCT_FFN_PALLAS=1``: gelu(x W + b), in bf16 or f32.

The port of ``protein_clip_tpu/ops/ffn_pallas.py``, whose kernel
``ffn_pallas._kernel`` runs in the compute dtype. ``dense_gelu`` is a
``torch.autograd.Function`` whose forward is a hand-written CUDA kernel on
CUDA tensors of the operands' dtype, x, W and b all bf16 or all f32:

- bf16: ``csrc/ffn_gelu.cu`` (K6; wgmma on ``csrc/mma_gemm.cuh``'s TMA
  ring, P1's loop);
- f32 (``--esm-dtype float32``): ``csrc/ffn_gelu_f32.cu`` (K6-f32;
  3xTF32 on wgmma on the same ring: each operand split into TF32 hi and
  lo, hi.hi + hi.lo + lo.hi summed in f32, f32-accurate as K4, K2 and K3
  are, not exact f32).

Both share ``csrc/gelu.cuh`` and ``csrc/mma_gemm.cuh``, and each kernel's
note gives its bound on an H100 and its design. On CPU tensors the forward is the plain
``dense_gelu_reference``. Its backward, as the TPU ``_bwd`` replays
``_eager``, is autograd through ``plain_composition`` recomputed from (x, W,
b): the gate-off path's arithmetic, so the kernel is a forward-path
optimisation and, on bf16 inputs, the backward's products are bf16 GEMMs
with f32 accumulation (as JAX's VJP of ``_eager``: ``dot_general`` of the
f32 cast of a bf16 cotangent with a bf16 operand,
``preferred_element_type=f32``, rounded to bf16); on f32 inputs they are
f32 GEMMs (cuBLAS with TF32 off, torch's default for matmul), as JAX's
``_bwd`` replays ``_eager`` in f32.

Shapes the kernels take (``fits``): any N up to 65535 * 256 rows, H a
multiple of 16, M a multiple of 8. Every ESM-2 family's wi fits at every N
(H = 320 ... 5120, M = 4H); a hidden size that is no multiple of 16 (none
of the families) takes the plain path on the CPU and raises on the card.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os

import torch
import torch.nn.functional as F

from ..kernels import build

MODES = {"erf": 0, "tanh": 1}
H_MULTIPLE, M_MULTIPLE = 16, 8   # a wgmma k-step (bf16) and 8 columns (16 bytes)
MAX_ROWS = 65535 * 256           # grid.y blocks of 256 rows (bf16; f32's run along grid.x)
# The kernel of each dtype the operands may have
KERNELS = {torch.bfloat16: "ffn_gelu", torch.float32: "ffn_gelu_f32"}
# Kernel launches since the counts were last set to 0 (chip_smoke.py reads
# them), by kernel: ffn_gelu (K6, bf16) and ffn_gelu_f32 (K6-f32)
launches = dict.fromkeys(KERNELS.values(), 0)


def enabled() -> bool:
    return os.environ.get("PCT_FFN_PALLAS") == "1"


def fits(n: int, h: int, m: int) -> bool:
    """Whether the CUDA kernel takes (N, H) x (H, M)."""
    return 0 < n <= MAX_ROWS and h > 0 and h % H_MULTIPLE == 0 and m > 0 and m % M_MULTIPLE == 0


def _gelu_f32(a: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "tanh":
        return F.gelu(a, approximate="tanh")
    return a * 0.5 * (1.0 + torch.erf(a / math.sqrt(2.0)))


def dense_gelu_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         mode: str) -> torch.Tensor:
    """Plain version of K6 (the TPU package's ``_eager``): the product in
    f32, cast to x's dtype, THEN the bias, gelu in f32, cast back."""
    z = torch.matmul(x.float(), w.float()).to(x.dtype) + b
    return _gelu_f32(z.float(), mode).to(x.dtype)


def plain_composition(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      mode: str) -> torch.Tensor:
    """The gate-off path's wi + gelu (``models/esm2._dense`` then ``_gelu``),
    which ``dense_gelu``'s backward differentiates: the product in the
    operands' dtype (bf16 tensor-core GEMMs with f32 accumulation on the
    card), the bias, gelu in f32, cast back. In f32 it is
    ``dense_gelu_reference``'s arithmetic."""
    z = torch.matmul(x, w) + b
    return _gelu_f32(z.float(), mode).to(x.dtype)


def bind(lib: ctypes.CDLL, name: str):
    """The C entry point of kernel ``name`` (ffn_gelu, ffn_gelu_f32) in a
    loaded library: x, w, b, out, N, H, M, mode and the stream."""
    fn = getattr(lib, f"pct_{name}")
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _launcher(name: str):
    """Kernel ``name``'s entry point, built and loaded at first use."""
    return bind(build.load(name), name)


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, mode: str) -> None:
    if x.dim() != 2 or w.dim() != 2 or b.dim() != 1 or x.shape[1] != w.shape[0] \
            or b.shape[0] != w.shape[1]:
        raise ValueError(f"x must be (N, H), w (H, M) and b (M,), got {tuple(x.shape)}, "
                         f"{tuple(w.shape)} and {tuple(b.shape)}")
    if mode not in MODES:
        raise ValueError(f"gelu mode {mode!r} is not one of {sorted(MODES)}")
    if x.dtype not in KERNELS:
        raise TypeError(f"x must be bfloat16 or float32 on CUDA, got {x.dtype}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name} must have x's dtype ({x.dtype}) on CUDA, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if not fits(x.shape[0], x.shape[1], w.shape[1]):
        raise ValueError(f"the kernel does not take (N, H, M) = "
                         f"{(x.shape[0], x.shape[1], w.shape[1])}: see fits()")


def _forward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    if x.device.type == "cpu":
        return dense_gelu_reference(x, w, b, mode)
    if x.device.type != "cuda":
        raise ValueError(f"dense_gelu runs on cpu or cuda, not {x.device}")
    _check(x, w, b, mode)
    N, H = x.shape
    M = w.shape[1]
    name = KERNELS[x.dtype]
    launch = _launcher(name)
    out = torch.empty(N, M, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = launch(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), N, H, M,
                     MODES[mode], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    launches[name] += 1
    return out


class _DenseGelu(torch.autograd.Function):
    """K6 forward (the plain version on CPU tensors); the backward through
    ``plain_composition``, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, w, b, mode):
        ctx.save_for_backward(x, w, b)
        ctx.mode = mode
        return _forward(x, w, b, mode)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
            out = plain_composition(*inputs, ctx.mode)
            grads = iter(torch.autograd.grad(out, [t for t in inputs if t.requires_grad], g))
        return (*(next(grads) if n else None for n in need), None)


def dense_gelu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """gelu(x @ w + b) with the wi epilogue fused: x (N, H), w (H, M), b
    (M,). Callers flatten (B, T, H) to (B*T, H) and check ``fits`` and
    ``enabled`` first."""
    return _DenseGelu.apply(x, w, b, mode)

