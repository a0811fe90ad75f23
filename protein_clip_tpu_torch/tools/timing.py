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

Now and then every session of a call keeps no kernel record at all (seen
for ``torch._int_mm`` late in ``chip_smoke.py`` on an H100). Then the
device time is taken by ``graph_ms`` instead: the calls captured in one
CUDA graph and replayed between two CUDA events, which leaves the host
out without the profiler. ``method`` says which way a reading was taken.
"""

from __future__ import annotations

import subprocess
import sys

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
    after the timed one; ``method``, "profiler", or "graph" where no session
    kept a record and ``device_ms`` is ``graph_ms``'s."""
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
    clock = [sm_clock_mhz()]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    clock.append(sm_clock_mhz())
    out = {"kept_ms": sum(e.self_device_time_total for e in kernels) / 1e3 / iters,
           "records": sum(e.count for e in kernels) / iters,
           "events_ms": start.elapsed_time(end) / iters, "clock_mhz": clock}
    if kernels:
        launches = [-(-e.count // iters) for e in kernels]  # a call, rounded up
        out["device_ms"] = sum(e.self_device_time_total / e.count * n
                               for e, n in zip(kernels, launches)) / 1e3
        out["method"] = "profiler"
    else:
        print("torch.profiler kept no kernel record in 3 sessions: device time by graph replay",
              file=sys.stderr, flush=True)
        out["device_ms"], out["method"] = graph_ms(fn, iters), "graph"
    return out


def graph_ms(fn, iters: int, replays: int = 3) -> float:
    """fn()'s device time a call without the profiler: ``iters`` calls
    captured in one CUDA graph (after a warm-up on the capturing stream),
    replayed ``replays`` times between two CUDA events. The host is left
    out; the gaps between the graph's kernels, about a microsecond each,
    are in."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * iters)
    del graph
    return ms
