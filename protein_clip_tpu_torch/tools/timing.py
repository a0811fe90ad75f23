"""One way to time a kernel's calls on the card, for ``chip_smoke.py`` and
the probes alike.

``kernel_times(fn, iters)`` calls ``fn`` ``warmup`` times, then ``iters``
times under ``torch.profiler`` and ``iters`` times between two CUDA events,
and reads the SM clock (``nvidia-smi clocks.sm``) after each loop.

The profiler can lose kernel records: in the long process of
``chip_smoke.py`` on an H100, its sessions kept 145 of K5's 200 (two
launches a call, 100 calls), where a fresh process kept all. So the
device time a call is taken as each kernel's mean record times its
launches a call (its records a call, rounded up), not as the sum of the
records kept; ``records``, the records kept a call, shows what was lost.
"""

from __future__ import annotations

import subprocess

import torch


def sm_clock_mhz() -> float:
    """The card's SM clock as nvidia-smi reads it now, in MHz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def kernel_times(fn, iters: int, warmup: int = 3) -> dict:
    """fn()'s time a call: ``device_ms``, the kernels' device time (each
    kernel's mean record times its launches a call; host gaps left out);
    ``kept_ms``, the kept records' sum a call; ``records``, the kernel
    records kept a call; ``events_ms``, CUDA events around the loop (host
    gaps included); ``clock_mhz``, the SM clock after the profiled loop and
    after the timed one."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # now and then a profiler session keeps no kernel record at all: such a
    # session is taken again, at most twice
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    else:
        raise RuntimeError("torch.profiler kept no kernel record in 3 sessions")
    clock = [sm_clock_mhz()]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    clock.append(sm_clock_mhz())
    launches = [-(-e.count // iters) for e in kernels]  # a call, rounded up
    return {"device_ms": sum(e.self_device_time_total / e.count * n
                             for e, n in zip(kernels, launches)) / 1e3,
            "kept_ms": sum(e.self_device_time_total for e in kernels) / 1e3 / iters,
            "records": sum(e.count for e in kernels) / iters,
            "events_ms": start.elapsed_time(end) / iters, "clock_mhz": clock}
