"""Rates of the dense product kernel P1 on the card, beside the library's.

    python -m protein_clip_tpu_torch.tools.probe_int8

The port of ``tools/probe_int8_pallas.py``. At the probe's (N, K, M) =
(8192, 2560, 2560) it prints one line each for P1 in bf16 -> f32, P1 in s8 ->
s32 (and whether it equals the exact plain version to the bit),
``torch._int_mm`` (cuBLASLt s8) with W k-major (the layout cuBLASLt takes
fast; made once outside the timing, as static weights would be) and with W
(K, M) row-major as P1 takes it, and ``torch.matmul`` in bf16: device time
per call by CUDA events, over four input sets so that successive calls miss
the 50 MB L2, and the rate. The library calls are yardsticks here only; the
port's paths never call them. Prints the card's name and power limit first,
and last the host cost of what P1 does on the host for every launch besides
the launch: encoding a TMA tensor map (one for s8, two for bf16) with the
driver's ``cuTensorMapEncodeTiled``, timed on the host clock over 10 000
calls at a one-sequence shape, beside the host time of a whole ``mm`` call
from Python there.
"""

from __future__ import annotations

import ctypes
import itertools
import subprocess
import time

import torch

from ..ops import dense_mm
from ..utils.device import resolve_device

N, K, M = 8192, 2560, 2560


def device_ms(fn, sets, iters: int = 50, warmup: int = 3) -> float:
    """Mean time of fn(*inputs) by CUDA events, cycling over the input sets."""
    cycle = itertools.cycle(sets)
    for _ in range(warmup):
        fn(*next(cycle))
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*next(cycle))
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def encode_us(x: torch.Tensor, calls: int = 10_000) -> float:
    """Host microseconds per cuTensorMapEncodeTiled call for x's TMA map as
    P1 encodes it: (rows, cols) u8, 128-byte x 64-row boxes, 128-byte
    swizzle."""
    encode = ctypes.CDLL("libcuda.so.1").cuTensorMapEncodeTiled
    encode.restype = ctypes.c_int
    raw = ctypes.create_string_buffer(256)
    tensor_map = ctypes.c_void_p((ctypes.addressof(raw) + 63) // 64 * 64)  # 64-byte aligned
    dims = (ctypes.c_uint64 * 2)(x.shape[1], x.shape[0])
    strides = (ctypes.c_uint64 * 1)(x.shape[1])
    box = (ctypes.c_uint32 * 2)(128, 64)
    unit = (ctypes.c_uint32 * 2)(1, 1)
    args = (tensor_map, ctypes.c_int(0), ctypes.c_uint32(2), ctypes.c_void_p(x.data_ptr()), dims,
            strides, box, unit, ctypes.c_int(0), ctypes.c_int(3), ctypes.c_int(3), ctypes.c_int(0))
    if encode(*args) != 0:
        raise RuntimeError("cuTensorMapEncodeTiled refused P1's map")
    t0 = time.perf_counter()
    for _ in range(calls):
        encode(*args)
    return (time.perf_counter() - t0) / calls * 1e6


def call_us(x: torch.Tensor, w: torch.Tensor, calls: int = 2_000) -> float:
    """Host microseconds per dense_mm.mm call from Python (allocation, checks,
    ctypes, tensor map and launch), the card kept ahead by the queue."""
    for _ in range(10):
        dense_mm.mm(x, w, torch.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        dense_mm.mm(x, w, torch.int32)
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / calls * 1e6


def main() -> int:
    device = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"card: {gpu}; torch {torch.__version__}; (N, K, M) = ({N}, {K}, {M})")
    gen = torch.Generator(device=device).manual_seed(0)
    ops = 2 * N * K * M
    bf = [(torch.randn(N, K, generator=gen, device=device).bfloat16(),
           (0.02 * torch.randn(K, M, generator=gen, device=device)).bfloat16())
          for _ in range(4)]
    s8 = [(torch.randint(-127, 128, (N, K), generator=gen, device=device, dtype=torch.int8),
           torch.randint(-127, 128, (K, M), generator=gen, device=device, dtype=torch.int8))
          for _ in range(4)]
    s8_kmajor = [(x, w.t().contiguous().t()) for x, w in s8]
    rows = (("P1 bf16 -> f32", lambda x, w: dense_mm.mm(x, w, torch.float32), bf, "TFLOP/s"),
            ("P1 s8 -> s32", lambda x, w: dense_mm.mm(x, w, torch.int32), s8, "TOP/s"),
            ("torch._int_mm (cuBLASLt s8), W k-major", torch._int_mm, s8_kmajor, "TOP/s"),
            ("torch._int_mm (cuBLASLt s8), W row-major", torch._int_mm, s8, "TOP/s"),
            ("torch.matmul bf16", torch.matmul, bf, "TFLOP/s"))
    for name, fn, sets, unit in rows:
        ms = device_ms(fn, sets)
        line = f"{name}: {ms:.6f} ms  {ops / ms / 1e9:.1f} {unit}"
        if name == "P1 s8 -> s32":
            x, w = s8[0]
            exact = torch.equal(dense_mm.mm(x, w, torch.int32),
                                dense_mm.mm_reference(x, w, torch.int32))
            line += f"  s8 exact: {exact}"
        print(line + f" | {gpu}", flush=True)
    x = torch.randint(-127, 128, (128, 640), generator=gen, device=device, dtype=torch.int8)
    w = torch.randint(-127, 128, (640, 2560), generator=gen, device=device, dtype=torch.int8)
    print(f"host cost at (128, 640, 2560): cuTensorMapEncodeTiled {encode_us(x):.3f} us a map "
          f"(P1 s8 encodes 1 per call, bf16 2); a whole mm call from Python "
          f"{call_us(x, w):.3f} us | {gpu}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
