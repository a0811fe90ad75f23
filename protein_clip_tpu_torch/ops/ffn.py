"""The FFN input projection with its gelu fused in (kernel K6), under
``PCT_FFN_PALLAS=1``: gelu(x W + b).

The port of ``protein_clip_tpu/ops/ffn_pallas.py``. ``dense_gelu`` is a
``torch.autograd.Function``: its forward is the hand-written CUDA kernel
``csrc/ffn_gelu.cu`` (replacing the TPU kernel ``ffn_pallas._kernel``; its
note gives the bound on an H100 and the design) on CUDA tensors, and the
plain ``dense_gelu_reference`` on CPU tensors. Its backward, as the TPU
``_bwd`` replays ``_eager``, is autograd through ``plain_composition``
recomputed from (x, W, b): the gate-off path's arithmetic, so the kernel is
a forward-path optimisation and, on bf16 inputs, the backward's products are
bf16 GEMMs with f32 accumulation (as JAX's VJP of ``_eager``:
``dot_general`` of the f32 cast of a bf16 cotangent with a bf16 operand,
``preferred_element_type=f32``, rounded to bf16).

Shapes the kernel takes (``fits``): any N up to 65535 * 256 rows, H a
multiple of 16, M a multiple of 8. Every t30_150M serving and training shape
fits (H = 640, M = 2560, N = B * T of any bucket); a hidden size that is no
multiple of 16 (none of the ESM-2 families) takes the plain path.
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
MAX_ROWS = 65535 * 256           # grid.y blocks of 256 rows


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


def bind(lib: ctypes.CDLL):
    """The C entry point of a loaded ffn_gelu library: x, w, b, out, N, H,
    M, mode and the stream."""
    fn = lib.pct_ffn_gelu
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _launcher():
    """The kernel's entry point, built and loaded at first use."""
    return bind(build.load("ffn_gelu"))


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, mode: str) -> None:
    if x.dim() != 2 or w.dim() != 2 or b.dim() != 1 or x.shape[1] != w.shape[0] \
            or b.shape[0] != w.shape[1]:
        raise ValueError(f"x must be (N, H), w (H, M) and b (M,), got {tuple(x.shape)}, "
                         f"{tuple(w.shape)} and {tuple(b.shape)}")
    if mode not in MODES:
        raise ValueError(f"gelu mode {mode!r} is not one of {sorted(MODES)}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16 on CUDA, got {t.dtype}")
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
    out = torch.empty(N, M, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _launcher()(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), N, H, M,
                          MODES[mode], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ffn_gelu launch failed: cudaError_t {err}")
    dense_gelu.launches += 1
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


# Forward calls that launched the kernel since the count was last set to 0
# (chip_smoke.py reads it).
dense_gelu.launches = 0
