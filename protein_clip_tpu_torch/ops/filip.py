"""FILIP masked token max-sim (kernel K4).

``filip_similarity_fused`` is the wrapper of the hand-written CUDA kernel
``csrc/filip_maxsim.cu``, which replaces the TPU kernel
``protein_clip_tpu/ops/filip_pallas.py::_maxsim_kernel``. The kernel's note
gives its bound on an H100 and what its design does about it.

For every pair (i, j) of a rectangular (Ba, Bb) grid, at temperature 1:

    oa[i, j] = mean over valid a-tokens s of  max over valid b-tokens u of <ha[i, s], hb[j, u]>
    ob[i, j] = mean over valid b-tokens u of  max over valid a-tokens s of <ha[i, s], hb[j, u]>

A pair of tokens is valid where ``mask_a * mask_b > 0``; an invalid score
is f32-min, and a row or column max that stays at f32-min (no valid token
on the other side) becomes 0 before any sum, so a candidate whose mask is
empty scores 0, not -inf. The means divide by ``max(sum(mask), 1e-6)``.
The temperature is divided out afterwards, floored at ``_T_FLOOR``.

The backward (``_raw_maxsim_bwd``, plain jnp in the TPU package) belongs to
FILIP training and is not ported yet: inputs that require grad are refused.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..kernels import build

_NEG = torch.finfo(torch.float32).min
MAX_DIM = 256                  # token dims the kernel takes (multiples of 4)
MAX_SHARED_BYTES = 232448      # an H100 block's shared memory (227 KB)
# Folding the temperature out of the max is valid for t > 0 only; a t driven
# to or below 0 saturates at this floor instead of flipping the max.
_T_FLOOR = 1e-4


def clamped_temperature(temperature) -> float:
    """The scalar ``filip_similarity_fused`` divides by: callers that undo
    the division (``retrieve --raw-cosine``) multiply by this, not by the
    raw parameter."""
    return max(float(temperature), _T_FLOOR)


@functools.cache
def _launcher():
    """The kernel's C entry point, built and loaded at first use."""
    fn = build.load("filip_maxsim").pct_filip_maxsim
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def maxsim_reference(ha: torch.Tensor, hb: torch.Tensor, mask_a: torch.Tensor,
                     mask_b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version (the TPU package's ``_raw_maxsim`` at t = 1): raw
    (oa, ob), each (Ba, Bb) f32. Scores one a-row at a time, so its peak
    memory is one (Bb, TA, TB) f32 score block."""
    ma = mask_a.float()
    mb = mask_b.float()
    cnt_a = ma.sum(-1).clamp(min=1e-6)                      # (Ba,)
    cnt_b = mb.sum(-1).clamp(min=1e-6)                      # (Bb,)
    hb32 = hb.float()
    oa = torch.empty(ha.shape[0], hb.shape[0], dtype=torch.float32, device=ha.device)
    ob = torch.empty_like(oa)
    for i in range(ha.shape[0]):
        s = torch.einsum("td,jsd->jts", ha[i].float(), hb32)          # (Bb, TA, TB)
        valid = (ma[i][None, :, None] * mb[:, None, :]) > 0
        s = torch.where(valid, s, _NEG)
        # clamp the no-valid-token sentinel to 0 before it is summed
        row_max = s.amax(2)                                            # (Bb, TA)
        col_max = s.amax(1)                                            # (Bb, TB)
        row_max = torch.where(row_max <= _NEG, 0.0, row_max)
        col_max = torch.where(col_max <= _NEG, 0.0, col_max)
        oa[i] = (row_max * ma[i]).sum(-1) / cnt_a[i]
        ob[i] = (col_max * mb).sum(-1) / cnt_b
    return oa, ob


def _check(ha, hb, mask_a, mask_b) -> None:
    if ha.dim() != 3 or hb.dim() != 3 or ha.shape[2] != hb.shape[2]:
        raise ValueError(f"ha must be (Ba, TA, D) and hb (Bb, TB, D), got "
                         f"{tuple(ha.shape)} and {tuple(hb.shape)}")
    (Ba, TA, D), (Bb, TB, _) = ha.shape, hb.shape
    if mask_a.shape != (Ba, TA) or mask_b.shape != (Bb, TB):
        raise ValueError(f"masks must be (Ba, TA) = {(Ba, TA)} and (Bb, TB) = {(Bb, TB)}, "
                         f"got {tuple(mask_a.shape)} and {tuple(mask_b.shape)}")
    for name, t in (("ha", ha), ("hb", hb), ("mask_a", mask_a), ("mask_b", mask_b)):
        if t.device != ha.device:
            raise ValueError(f"{name} is on {t.device}, ha on {ha.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
        if t.requires_grad:
            raise NotImplementedError(
                "filip_similarity_fused has no backward on CUDA yet (FILIP training "
                "is still to port); run it under torch.inference_mode()")
    for name, t in (("ha", ha), ("hb", hb)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on CUDA, got {t.dtype}")
    for name, t in (("mask_a", mask_a), ("mask_b", mask_b)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if D % 4 or not 0 < D <= MAX_DIM:
        raise ValueError(f"token dim D={D} must be a multiple of 4 in [4, {MAX_DIM}]")
    if min(TA, TB) < 1 or Ba > 65535 or Bb > 2 ** 31 - 1 or TA > 2 ** 24:
        raise ValueError(f"unsupported shape Ba={Ba}, Bb={Bb}, TA={TA}, TB={TB}")
    if shared_bytes(D, TB) > MAX_SHARED_BYTES:
        raise ValueError(f"TB={TB} at D={D} needs {shared_bytes(D, TB)} bytes of shared "
                         f"memory, more than the {MAX_SHARED_BYTES} a block can have")


def shared_bytes(D: int, TB: int) -> int:
    """Dynamic shared memory of one block (csrc/filip_maxsim.cu's layout):
    an a-tile and a b-tile of 64 tokens at row stride D + 4, a 16 x 64
    partial column-max scratch, two 64-token mask tiles, the TB column
    maxes."""
    return 4 * (2 * 64 * (D + 4) + 16 * 64 + 2 * 64 + TB)


def filip_similarity_fused(ha: torch.Tensor, hb: torch.Tensor, mask_a: torch.Tensor,
                           mask_b: torch.Tensor, temperature
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(Ba, TA, D) and (Bb, TB, D) f32 tokens, (Ba, TA) and (Bb, TB) int32
    masks, a temperature (float or scalar tensor) -> (sim_a, sim_b), each
    (Ba, Bb) f32, divided by ``max(t, _T_FLOOR)``. On CPU tensors this is
    the plain version; on CUDA tensors it launches the kernel or raises."""
    if ha.device.type == "cpu":
        oa, ob = maxsim_reference(ha, hb, mask_a, mask_b)
    elif ha.device.type != "cuda":
        raise ValueError(f"filip_similarity_fused runs on cpu or cuda, not {ha.device}")
    else:
        _check(ha, hb, mask_a, mask_b)
        (Ba, TA, D), (Bb, TB, _) = ha.shape, hb.shape
        oa = torch.empty(Ba, Bb, dtype=torch.float32, device=ha.device)
        ob = torch.empty_like(oa)
        if Ba and Bb:
            launch = _launcher()
            with torch.cuda.device(ha.device):
                stream = torch.cuda.current_stream(ha.device).cuda_stream
                err = launch(ha.data_ptr(), hb.data_ptr(), mask_a.data_ptr(),
                             mask_b.data_ptr(), oa.data_ptr(), ob.data_ptr(),
                             Ba, Bb, TA, TB, D, stream)
            if err != 0:
                raise RuntimeError(f"filip_maxsim launch failed: cudaError_t {err}")
            filip_similarity_fused.launches += 1
    t = torch.as_tensor(temperature, dtype=torch.float32, device=oa.device).clamp(min=_T_FLOOR)
    return oa / t, ob / t


# Kernel launches since the count was last set to 0 (chip_smoke.py reads it).
filip_similarity_fused.launches = 0
