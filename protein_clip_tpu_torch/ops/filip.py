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

The raw scores go through ``_MaxSim``, an autograd Function whose forward
is the kernel (or, on CPU tensors, ``maxsim_reference``) and whose backward
is ``maxsim_backward``, the port of the TPU package's ``_raw_maxsim_bwd``
in plain PyTorch, as that is plain jnp (no ``pallas_call``), the same code
on both devices. It recomputes the scores in (ib, jb)
blocks of at most ``BWD_BUDGET_ELEMS`` f32 elements and splits the max's
gradient evenly across ties. The temperature stays outside the Function,
so autograd gives it its gradient through the division.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..kernels import build

_NEG = torch.finfo(torch.float32).min
MAX_DIM = 256                  # token dims the kernel takes (multiples of 4)
# Folding the temperature out of the max is valid for t > 0 only; a t driven
# to or below 0 saturates at this floor instead of flipping the max.
_T_FLOOR = 1e-4
# Score elements of one recomputed (ib, jb, TA, TB) f32 block of the
# backward (the TPU package's 2^26 on v5e: 256 MB, about 1 GB live with
# the tie shares and the score gradient).
BWD_BUDGET_ELEMS = 1 << 26


def clamped_temperature(temperature) -> float:
    """The scalar ``filip_similarity_fused`` divides by: callers that undo
    the division (``retrieve --raw-cosine``) multiply by this, not by the
    raw parameter."""
    return max(float(temperature), _T_FLOOR)


def bind(lib: ctypes.CDLL):
    """The kernel's C entry point in ``lib``: ha, hb, the masks, oa, ob,
    then Ba, Bb, TA, TB, D and the stream."""
    fn = lib.pct_filip_maxsim
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _launcher():
    """The kernel's C entry point, built and loaded at first use."""
    return bind(build.load("filip_maxsim"))


def maxsim_reference(ha: torch.Tensor, hb: torch.Tensor, mask_a: torch.Tensor,
                     mask_b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version (the TPU package's ``_raw_maxsim`` at t = 1): raw
    (oa, ob), each (Ba, Bb), in f32 (float64 for float64 tokens, which the
    card's check of the backward differentiates). Scores one a-row at a
    time, so its peak memory is one (Bb, TA, TB) score block."""
    dtype = torch.float64 if ha.dtype == torch.float64 else torch.float32
    ma = mask_a.to(dtype)
    mb = mask_b.to(dtype)
    cnt_a = ma.sum(-1).clamp(min=1e-6)                      # (Ba,)
    cnt_b = mb.sum(-1).clamp(min=1e-6)                      # (Bb,)
    hb32 = hb.to(dtype)
    oa = torch.empty(ha.shape[0], hb.shape[0], dtype=dtype, device=ha.device)
    ob = torch.empty_like(oa)
    for i in range(ha.shape[0]):
        s = torch.einsum("td,jsd->jts", ha[i].to(dtype), hb32)        # (Bb, TA, TB)
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
    for name, t in (("ha", ha), ("hb", hb)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on CUDA, got {t.dtype}")
    for name, t in (("mask_a", mask_a), ("mask_b", mask_b)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if D % 4 or not 0 < D <= MAX_DIM:
        raise ValueError(f"token dim D={D} must be a multiple of 4 in [4, {MAX_DIM}]")
    if min(TA, TB) < 1 or max(Ba, Bb) > 2 ** 31 - 1 or max(TA, TB) > 2 ** 24:
        raise ValueError(f"unsupported shape Ba={Ba}, Bb={Bb}, TA={TA}, TB={TB}")


def _block_div(n: int, cap: int) -> int:
    """Largest divisor of n that is <= cap (>= 1)."""
    c = max(1, min(cap, n))
    while n % c:
        c -= 1
    return c


def maxsim_backward(ha: torch.Tensor, hb: torch.Tensor, mask_a: torch.Tensor,
                    mask_b: torch.Tensor, ga: torch.Tensor, gb: torch.Tensor,
                    budget_elems: int = BWD_BUDGET_ELEMS) -> tuple[torch.Tensor, torch.Tensor]:
    """(dha, dhb) of the raw (oa, ob) for their cotangents ga, gb (Ba, Bb):
    the port of ``_raw_maxsim_bwd``. The scores are recomputed in f32 in
    (ib, jb) blocks, ib * jb * TA * TB <= budget_elems where one pair fits
    (jb at most 8); a max's gradient is split evenly over the valid pairs
    that reach it, scaled by ga / cnt_a on valid a-tokens and by gb / cnt_b
    on valid b-tokens. Returned in the inputs' dtypes."""
    (Ba, TA, D), (Bb, TB, _) = ha.shape, hb.shape
    ma, mb = mask_a.float(), mask_b.float()
    cnt_a = ma.sum(-1).clamp(min=1e-6)
    cnt_b = mb.sum(-1).clamp(min=1e-6)
    ga, gb = ga.float(), gb.float()
    ha32, hb32 = ha.float(), hb.float()
    cap = max(1, budget_elems // (TA * TB))
    jb = _block_div(Bb, min(8, cap))
    ib = _block_div(Ba, max(1, cap // jb))
    dha = torch.zeros(Ba, TA, D, dtype=torch.float32, device=ha.device)
    dhb = torch.zeros(Bb, TB, D, dtype=torch.float32, device=hb.device)
    for i0 in range(0, Ba, ib):
        ha_i, ma_i = ha32[i0:i0 + ib], ma[i0:i0 + ib]
        for j0 in range(0, Bb, jb):
            hb_j, mb_j = hb32[j0:j0 + jb], mb[j0:j0 + jb]
            s = torch.einsum("atd,jsd->ajts", ha_i, hb_j)               # (ib, jb, TA, TB)
            valid = (ma_i[:, None, :, None] * mb_j[None, :, None, :]) > 0
            sm = torch.where(valid, s, _NEG)
            pa = ((sm == sm.amax(3, keepdim=True)) & valid).float()
            pa = pa / pa.sum(3, keepdim=True).clamp(min=1.0)
            pb = ((sm == sm.amax(2, keepdim=True)) & valid).float()
            pb = pb / pb.sum(2, keepdim=True).clamp(min=1.0)
            coef_a = ((ga[i0:i0 + ib, j0:j0 + jb] / cnt_a[i0:i0 + ib, None])[:, :, None, None]
                      * ma_i[:, None, :, None])
            coef_b = ((gb[i0:i0 + ib, j0:j0 + jb] / cnt_b[None, j0:j0 + jb])[:, :, None, None]
                      * mb_j[None, :, None, :])
            ds = coef_a * pa + coef_b * pb
            dha[i0:i0 + ib] += torch.einsum("ajts,jsd->atd", ds, hb_j)
            dhb[j0:j0 + jb] += torch.einsum("ajts,atd->jsd", ds, ha_i)
    return dha.to(ha.dtype), dhb.to(hb.dtype)


def _raw_maxsim(ha, hb, mask_a, mask_b) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw (oa, ob): the plain version on CPU tensors, the kernel on CUDA
    tensors (or a raise)."""
    if ha.device.type == "cpu":
        return maxsim_reference(ha, hb, mask_a, mask_b)
    if ha.device.type != "cuda":
        raise ValueError(f"filip_similarity_fused runs on cpu or cuda, not {ha.device}")
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
    return oa, ob


class _MaxSim(torch.autograd.Function):
    """Raw (oa, ob) with ``maxsim_backward`` as its backward; the masks
    take no gradient."""

    @staticmethod
    def forward(ctx, ha, hb, mask_a, mask_b):
        ctx.save_for_backward(ha, hb, mask_a, mask_b)
        return _raw_maxsim(ha, hb, mask_a, mask_b)

    @staticmethod
    def backward(ctx, ga, gb):
        ha, hb, mask_a, mask_b = ctx.saved_tensors
        dha, dhb = maxsim_backward(ha, hb, mask_a, mask_b, ga, gb)
        return dha, dhb, None, None


def filip_similarity_fused(ha: torch.Tensor, hb: torch.Tensor, mask_a: torch.Tensor,
                           mask_b: torch.Tensor, temperature
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(Ba, TA, D) and (Bb, TB, D) f32 tokens, (Ba, TA) and (Bb, TB) int32
    masks, a temperature (float or scalar tensor) -> (sim_a, sim_b), each
    (Ba, Bb) f32, divided by ``max(t, _T_FLOOR)``. On CPU tensors the
    forward is the plain version; on CUDA tensors it launches the kernel or
    raises. Differentiable in ha, hb and a tensor temperature."""
    oa, ob = _MaxSim.apply(ha, hb, mask_a, mask_b)
    if isinstance(temperature, torch.Tensor):
        t = temperature.to(dtype=torch.float32, device=oa.device).clamp(min=_T_FLOOR)
    else:  # a number divides without a copy to the card (which would wait for it)
        t = clamped_temperature(temperature)
    return oa / t, ob / t


# Kernel launches since the count was last set to 0 (chip_smoke.py reads it).
filip_similarity_fused.launches = 0
