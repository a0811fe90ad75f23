"""Design readings of the InfoNCE kernels K2 and K3 on the card.

    python -m protein_clip_tpu_torch.tools.probe_infonce [--out FILE]

Prints the card's name and power limit first, then, at pools 256 (K2),
1024 and 4096 (K3), D = 128, unit rows scaled by exp(1/2) (as
``chip_smoke.py`` draws them), the device time of one forward plus backward
(cotangent 1) by CUDA events, each variant called through its library's C
entry points with buffers allocated once:

- ``ffma``: K2 and K3 as they were before their Hopper redesign, f32 FFMA on
  the CUDA cores, the backward's blocks owning rows of dX or of dY
  (``probe_infonce_ffma.cu`` beside this file; its ticket zeroed by a fill
  kernel each call, as its wrapper did);
- ``shipped``: ``csrc/infonce.cu`` as the port ships it (3xTF32 ``wgmma``,
  clusters of 4 x 4 blocks, K2's backward fused into its forward);
- ``separate``: the shipped library with K2's forward asked for no
  gradients and K3's backward sweep run as one cluster for K2's pool;
- builds from patched copies of ``csrc/`` (under ``_build/probe/``), one
  choice at a time: ``cluster 8`` (clusters of 4 x 2 blocks: each K2 block
  takes two tiles at 256, and twice as many K3 clusters fit at once),
  ``kept`` (K3's tile launch writes its logits to device memory, B^2 floats,
  and the backward reads them instead of forming them again), ``fresh
  accumulator`` (each group of 4 k-steps sums into a fresh accumulator,
  added to the running sum in f32), ``uncentred`` (the backward's products
  take the embedding rows as they are, no tile mean taken off; less
  accurate), ``timed`` (the shipped kernel with the global timer read by
  thread 0 of every cluster block at the phases of each backward step);
- at pools above K2's, ``sweep resident``: the shipped library with K3's
  backward swept by no more clusters than the card holds at once (the
  fewest steps a cluster, then the fewest partial planes), where
  ``ops.infonce.sweep_clusters`` counts waves of them.

Each is timed twice, in the order listed and then reversed. Beside each:
its largest gap from a float64 InfoNCE over the loss and both gradients,
relative to the largest entry of each (``clip_infonce``, torch's f32, beside
them), and the clusters of 16 (or 8) blocks the card holds at once. Then
the ``timed`` build's phases of a backward step (cluster 0, rank 0; the
median over the steps after the first), and the time of a call with the
host (CUDA events over back-to-back calls of forward plus backward through
autograd, as ``chip_smoke.py``'s ``wall_ms``): the shipped kernel through
``ops.infonce``'s wrappers, and the FFMA design through a copy of the
wrapper it had (its allocations, ticket fill and device guard).

``--step-check`` also holds one frozen train step at global batch 256 and
1024 through the shipped, ``fresh accumulator`` and ``uncentred`` builds
against the plain loss (``chip_smoke.step_readings``, its limits 1e-5).
Run it from the repository's root.

``--out`` writes every reading as JSON too.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import math
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from ..kernels import build
from ..ops import infonce

D = 128
POOLS = (256, 1024, 4096)
ITERS = {256: 200, 1024: 100, 4096: 20}
TOOLS = Path(__file__).resolve().parent
PROBE_DIR = build.BUILD_ROOT / "probe_infonce"
CLUSTER_LINE = ("constexpr int kRc = 4, kCc = 4;            "
                "// a cluster's blocks: rows x columns of tiles")
LOGITS_LINE = "      logits_window(acc, xs(), sb + kYhi, sb + kYlo, len, w > 0);\n"
TILES_LINE = "  const int64_t ro = static_cast<int64_t>(cb) * B + rb * kTile;\n"
# The logits kept: the tile launch writes each warpgroup's half-tile of
# logits, the sweep reads them back in place of its products.
KEPT_STORE = """  if (probe_logits != nullptr) {
    const Lane ln;
    const int64_t ld = static_cast<int64_t>(nb) * kTile;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int i = rb * kTile + 16 * ln.w + ln.g + 8 * ((k >> 1) & 1);
      const int j = cb * kTile + ln.wg * kHalf + 8 * (k >> 2) + 2 * ln.t + (k & 1);
      probe_logits[i * ld + j] = acc[k];
    }
  }
"""
KEPT_LOAD = """      if (p.mode == kSweep && probe_logits != nullptr) {
        const Lane ln;
        const int64_t ld = static_cast<int64_t>(nb) * kTile;
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const int i = r * kTile + 16 * ln.w + ln.g + 8 * ((k >> 1) & 1);
          const int j = c * kTile + ln.wg * kHalf + 8 * (k >> 2) + 2 * ln.t + (k & 1);
          acc[k] = probe_logits[i * ld + j];
        }
      } else {
        logits_window(acc, xs(), sb + kYhi, sb + kYlo, len, w > 0);
      }
"""
SETTER = """
extern "C" int {fn}(void* buf) {{
  {ty}* p = static_cast<{ty}*>(buf);
  return static_cast<int>(cudaMemcpyToSymbol(pct_infonce::{sym}, &p, sizeof(p)));
}}
"""
# Each group of 4 k-steps summed into a fresh accumulator and added to the
# running sum in f32 (the design's earlier form), in place of the tensor
# core's accumulator over a product's whole K.
FRESH = [("  fence_operands(acc);\n  wgmma_fence();\n",
          "  float fresh[R];\n  fence_operands(fresh);\n  wgmma_fence();\n"),
         ("  wgmma_wait<0>();\n  fence_operands(acc);\n",
          "  wgmma_wait<0>();\n  fence_operands(fresh);\n#pragma unroll\n"
          "  for (int i = 0; i < R; ++i) acc[i] = accumulate ? acc[i] + fresh[i] : fresh[i];\n"
          "  fence_operands(acc);\n")]
for wgmma in ("wgmma_tf32", "wgmma_tf32_n32"):
    FRESH.append((f"      {wgmma}(acc, ah[ks], dh[ks], accumulate || ks > 0);\n"
                  f"      if (kProducts > 1) {{\n"
                  f"        {wgmma}(acc, ah[ks], dl[ks], 1);\n"
                  f"        {wgmma}(acc, al[ks], dh[ks], 1);\n",
                  f"      {wgmma}(fresh, ah[ks], dh[ks], ks > 0);\n"
                  f"      if (kProducts > 1) {{\n"
                  f"        {wgmma}(fresh, ah[ks], dl[ks], 1);\n"
                  f"        {wgmma}(fresh, al[ks], dh[ks], 1);\n"))
# name: [(csrc/infonce.cu's text, patched text)]
PARTS = {
    "cluster 8": [(CLUSTER_LINE, CLUSTER_LINE.replace("kCc = 4", "kCc = 2"))],
    "kept": [("namespace pct_infonce {\n\nusing namespace pct_hopper;\n",
              "namespace pct_infonce {\n\nusing namespace pct_hopper;\n\n"
              "__device__ float* probe_logits = nullptr;\n"),
             (LOGITS_LINE, KEPT_LOAD), (TILES_LINE, KEPT_STORE + TILES_LINE)],
    "fresh accumulator": FRESH,
    "uncentred": [("  __device__ void centres(int len) {\n",
                   "  __device__ void centres(int len) {\n"
                   "    if (len > 0) {  // no tile mean: cx = cy = 0\n"
                   "      if (threadIdx.x < 2 * kWindow) ctr()[threadIdx.x] = 0.f;\n"
                   "      __syncthreads();\n"
                   "      return;\n"
                   "    }\n")],
    "timed": [("namespace pct_infonce {\n\nusing namespace pct_hopper;\n",
               "namespace pct_infonce {\n\nusing namespace pct_hopper;\n\n"
               "__device__ unsigned long long* probe_marks = nullptr;\n"),
              ("  int nb, nwin;\n",
               "  int nb, nwin;\n  int probe_step = 0;\n"
               "  __device__ void mark(int k) const {\n"
               "    if (probe_marks == nullptr || threadIdx.x != 0 || probe_step >= kMarkSteps) "
               "return;\n"
               "    unsigned long long t, c;\n"
               "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
               "    asm volatile(\"mov.u64 %0, %%clock64;\" : \"=l\"(c));\n"
               "    unsigned long long* at = probe_marks + ((blockIdx.y * kCluster + rank) * "
               "kMarkSteps + probe_step) * 16;\n"
               "    at[k] = c;\n    at[8 + k] = t;\n  }\n"),
              ("      const int gk = (ln.tid < kTile ? r : c) * kTile",
               "      probe_step = s;\n      mark(0);\n"
               "      const int gk = (ln.tid < kTile ? r : c) * kTile"),
              ("      logits(acc, r, c, staged);\n", "      logits(acc, r, c, staged);\n"
               "      mark(1);\n"),
              ("    fence_proxy_async();  // the dL tiles' generic writes before wgmma reads them\n"
               "    __syncthreads();\n",
               "    fence_proxy_async();  // the dL tiles' generic writes before wgmma reads them\n"
               "    __syncthreads();\n    mark(2);\n"),
              ("      centres(len);\n", "      centres(len);\n      mark(3);\n"),
              ("      if (summed) {  // each thread its own elements",
               "      mark(4);\n      if (summed) {  // each thread its own elements"),
              ("      cluster_sync();  // every block's parts are in place\n",
               "      cluster_sync();  // every block's parts are in place\n      mark(5);\n"),
              ("      cluster_sync();  // the parts are read before anything overwrites them\n",
               "      cluster_sync();  // the parts are read before anything overwrites them\n"
               "      mark(6);\n"),
              ("    return prefetch;\n", "    mark(7);\n    return prefetch;\n")],
}
MARK_STEPS = 64
PHASES = ("logits", "dL and its sums", "tile means", "gradient products",
          "parts written, cluster barrier", "exchange sums", "cluster barrier, next Y split")
SETTERS = {"kept": ("pct_probe_set_logits", "probe_logits", "float"),
           "timed": ("pct_probe_set_marks", "probe_marks", "unsigned long long")}


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def events_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean time of fn() by CUDA events over iters calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def build_all(step_check: bool) -> dict:
    """Every library timed (the FFMA baseline, the shipped kernel and the
    PARTS builds, each a patched copy of csrc/), all compiled at once, with
    the package's attention_fwd when ``step_check``: {name: CDLL}."""
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR)]
    jobs = [("ffma", cmd, TOOLS / "probe_infonce_ffma.cu", PROBE_DIR / "libffma.so"),
            ("shipped", cmd, build.CSRC_DIR / "infonce.cu", PROBE_DIR / "libshipped.so")]
    for name, patches in PARTS.items():
        src = PROBE_DIR / name.replace(" ", "_") / "csrc"
        shutil.rmtree(src.parent, ignore_errors=True)
        shutil.copytree(build.CSRC_DIR, src)
        text = (src / "infonce.cu").read_text()
        for line, patched in patches:
            if text.count(line) != 1:
                raise RuntimeError(f"part {name}: its text is not in csrc/infonce.cu once")
            text = text.replace(line, patched)
        if name == "timed":
            text = text.replace("constexpr int kCluster = kRc * kCc;\n",
                                f"constexpr int kCluster = kRc * kCc;\n"
                                f"constexpr int kMarkSteps = {MARK_STEPS};\n")
        if name in SETTERS:
            fn, sym, ty = SETTERS[name]
            text += SETTER.format(fn=fn, sym=sym, ty=ty)
        (src / "infonce.cu").write_text(text)
        jobs.append((name, [build._nvcc(), *build.NVCC_FLAGS, "-I", str(src)], src / "infonce.cu",
                     src.parent / "libinfonce.so"))
    for *_, lib in jobs:
        lib.unlink(missing_ok=True)
    if step_check:  # the backbone's K1, for the train steps
        jobs.append(("attention_fwd", [build._nvcc(), *build.NVCC_FLAGS, "-I",
                                       str(build.CSRC_DIR)],
                     build.CSRC_DIR / "attention_fwd.cu", build.library_path("attention_fwd")))
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        reports = list(pool.map(lambda job: build.compile_library(*job[1:]), jobs))
    for (name, *_), report in zip(jobs, reports):
        regs = [ln.strip() for ln in report.splitlines() if "registers" in ln or "spill" in ln]
        print(f"[build] {name}: {' | '.join(regs)}", flush=True)
    return {name: ctypes.CDLL(str(lib)) for name, *_, lib in jobs if name != "attention_fwd"}


def ffma_runner(lib: ctypes.CDLL, x, y, B: int):
    """fwd + bwd through the FFMA design's entry points and its own split rule."""
    for name, n_ptr, n_int in (("pct_probe_ffma_fwd", 7, 2), ("pct_probe_ffma_tiled_fwd", 7, 2),
                               ("pct_probe_ffma_bwd", 8, 4)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    nb = -(-B // 64)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    want = min(nb, -(-sms // nb))
    per = -(-nb // want)
    splits = -(-nb // per)
    out = torch.empty(2 * B * D + 4 + 2 * B, device="cuda")
    scratch = torch.empty(4 * nb * B + B + -(-B // 256), device="cuda")
    part = torch.empty(2 * splits * B * D if splits > 1 else 0, device="cuda")
    g = torch.ones((), device="cuda")
    loss, lse_r, lse_c = out[2 * B * D], out[2 * B * D + 4:][:B], out[2 * B * D + 4 + B:]
    fwd = lib.pct_probe_ffma_fwd if B <= 256 else lib.pct_probe_ffma_tiled_fwd

    def run():
        ticket = torch.zeros(1, dtype=torch.int32, device="cuda")
        s = torch.cuda.current_stream().cuda_stream
        err = fwd(x.data_ptr(), y.data_ptr(), scratch.data_ptr(), ticket.data_ptr(),
                  loss.data_ptr(), lse_r.data_ptr(), lse_c.data_ptr(), B, D, s)
        err |= lib.pct_probe_ffma_bwd(x.data_ptr(), y.data_ptr(), lse_r.data_ptr(),
                                      lse_c.data_ptr(), g.data_ptr(), out.data_ptr(),
                                      out.data_ptr() + 4 * B * D, part.data_ptr(), B, D, splits,
                                      per, s)
        if err:
            raise RuntimeError(f"ffma launch failed: {err}")
    return run, (loss, out[:B * D].view(B, D), out[B * D:2 * B * D].view(B, D))


def runner(fns: dict, x, y, B: int, cluster: tuple[int, int], mode: str,
           uv: tuple[int, int] | None = None):
    """fwd + bwd through a build of csrc/infonce.cu. mode: "fused" (K2 with
    its gradients), "separate" (K2's loss, then the sweep in one cluster) or
    "tiled" (K3, its sweep U x V = ``uv``, else the package's rule)."""
    count = ctypes.c_int(0)
    if fns["pct_infonce_max_clusters"](ctypes.byref(count)) != 0:
        raise RuntimeError("pct_infonce_max_clusters failed")
    u, v = (1, 1) if mode == "separate" else (
        uv or infonce.sweep_clusters(B, count.value, cluster))
    out = torch.empty(2 * B * D + 4 + 2 * B, device="cuda")
    grads = torch.empty(2 * B * D, device="cuda")
    scratch = torch.empty(infonce.scratch_floats(B), device="cuda")
    part = torch.empty((u - 1 + v - 1) * B * D + B, device="cuda")
    dd = torch.empty(B, device="cuda")
    g = torch.ones((), device="cuda")
    n = 2 * B * D
    loss, lse_r, lse_c = out[n], out[n + 4:n + 4 + B], out[n + 4 + B:]
    ptr = [t.data_ptr() for t in (x, y, loss, lse_r, lse_c)]

    def run():
        s = torch.cuda.current_stream().cuda_stream
        if mode == "fused":
            err = fns["pct_infonce_fwd"](*ptr, out.data_ptr(), out.data_ptr() + 4 * B * D,
                                         dd.data_ptr(), B, D, 1, s)
            err |= fns["pct_infonce_scale"](out.data_ptr(), g.data_ptr(), grads.data_ptr(), n, s)
        else:
            if mode == "separate":
                err = fns["pct_infonce_fwd"](*ptr, 0, 0, 0, B, D, 0, s)
            else:
                err = fns["pct_infonce_tiled_fwd"](ptr[0], ptr[1], scratch.data_ptr(), *ptr[2:],
                                                   B, D, s)
            err |= fns["pct_infonce_bwd"](ptr[0], ptr[1], ptr[3], ptr[4], g.data_ptr(),
                                          grads.data_ptr(), grads.data_ptr() + 4 * B * D,
                                          part.data_ptr(), B, D, u, v, s)
        if err:
            raise RuntimeError(f"launch failed: {err}")
    return run, (loss, grads[:B * D].view(B, D), grads[B * D:].view(B, D)), count.value


def resident_sweep(b: int, most: int) -> tuple[int, int]:
    """(U, V) with U x V no more than the ``most`` clusters the card holds
    at once: the fewest steps a cluster, then the fewest partial planes."""
    n_rows, n_cols = infonce.super_blocks(b)
    best = None
    for u in range(1, min(n_rows, most) + 1):
        for v in range(1, min(n_cols, most // u) + 1):
            key = (-(-n_rows // u) * -(-n_cols // v), u + v, -v)
            if best is None or key < best[0]:
                best = (key, (u, v))
    return best[1]


def float64_infonce(x, y):
    """The loss and its gradients in float64: the reference of gap()."""
    xr, yr = x.double().requires_grad_(True), y.double().requires_grad_(True)
    logits = xr @ yr.T
    diag = torch.diagonal(logits)
    loss = 0.5 * ((torch.logsumexp(logits, 1) - diag).mean()
                  + (torch.logsumexp(logits, 0) - diag).mean())
    loss.backward()
    return loss.detach(), xr.grad, yr.grad


def gap(got, ref) -> float:
    """The largest of |loss - ref| / max(1, |ref|) and max|g - ref| / max|ref|."""
    out = abs(float(got[0]) - float(ref[0])) / max(1.0, abs(float(ref[0])))
    for a, b in zip(got[1:], ref[1:]):
        out = max(out, float((a.double() - b).abs().max()) / float(b.abs().max()))
    return out


class FfmaWrapper(torch.autograd.Function):
    """The FFMA design's autograd wrapper, as it was beside its kernels: its
    checks, five allocations and a ticket fill a forward, three allocations
    a backward, the device guard entered at each launch, and its split rule
    from the card's SM count. The host time of a call before the redesign."""

    lib = None

    @staticmethod
    def forward(ctx, x, y, tiled: bool):
        infonce._check(x, y)
        B, _ = x.shape
        dev = x.device
        loss = torch.empty((), dtype=torch.float32, device=dev)
        lse_r = torch.empty(B, dtype=torch.float32, device=dev)
        lse_c = torch.empty(B, dtype=torch.float32, device=dev)
        nb = -(-B // 64)
        scratch = torch.empty(4 * nb * B + B + -(-B // 256), dtype=torch.float32, device=dev)
        ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        fn = FfmaWrapper.lib.pct_probe_ffma_tiled_fwd if tiled else FfmaWrapper.lib.pct_probe_ffma_fwd
        with torch.cuda.device(dev):
            err = fn(x.data_ptr(), y.data_ptr(), scratch.data_ptr(), ticket.data_ptr(),
                     loss.data_ptr(), lse_r.data_ptr(), lse_c.data_ptr(), B, D,
                     torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"ffma forward failed: {err}")
        ctx.save_for_backward(x, y, lse_r, lse_c)
        return loss

    @staticmethod
    def backward(ctx, g):
        x, y, lse_r, lse_c = ctx.saved_tensors
        B, _ = x.shape
        g = g.to(torch.float32).contiguous()
        dx, dy = torch.empty_like(x), torch.empty_like(y)
        nb = -(-B // 64)
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        per = -(-nb // min(nb, -(-sms // nb)))
        splits = -(-nb // per)
        part = torch.empty(2 * splits * B * D if splits > 1 else 0, dtype=torch.float32,
                           device=x.device)
        with torch.cuda.device(x.device):
            err = FfmaWrapper.lib.pct_probe_ffma_bwd(
                x.data_ptr(), y.data_ptr(), lse_r.data_ptr(), lse_c.data_ptr(), g.data_ptr(),
                dx.data_ptr(), dy.data_ptr(), part.data_ptr(), B, D, splits, per,
                torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"ffma backward failed: {err}")
        return dx, dy, None


def wall_ms(libs: dict, shipped: dict, x, y, B: int) -> dict:
    """CUDA-event time of a forward plus backward through autograd, calls
    back to back (the host's time where it exceeds the card's): the FFMA
    design through its old wrapper, the shipped kernel through ops.infonce's
    (the probe's build in the package's place)."""
    tiled = B > infonce.K2_MAX_POOL
    FfmaWrapper.lib = libs["ffma"]
    xg, yg = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
    fn = infonce.fused_infonce_tiled if tiled else infonce.fused_infonce
    saved = infonce._launchers
    infonce._launchers = lambda: shipped
    try:
        runs = {"ffma": lambda: torch.autograd.grad(FfmaWrapper.apply(xg, yg, tiled), (xg, yg)),
                "shipped": lambda: torch.autograd.grad(fn(xg, yg), (xg, yg))}
        out = {name: [] for name in runs}
        for order in (list(runs), list(runs)[::-1]):
            for name in order:
                out[name].append(events_ms(runs[name], ITERS[B], warmup=10))
    finally:
        infonce._launchers = saved
    return out


def step_phases(marks: torch.Tensor, steps: int) -> dict:
    """The timed build's phases of cluster 0's rank-0 block, in µs: the
    median over its backward steps after the first of each mark's distance
    from the one before (PHASES), in SM cycles turned into µs at the clock
    the global timer shows over the marked span, and of a whole step. A
    phase whose marks K2 does not set (its logits) is left out."""
    m = marks.view(-1, MARK_STEPS, 16)[0, :steps].double()
    cyc, ns = m[:, :8], m[:, 8:]
    seen = ns > 0
    span_ns = float(ns[seen].max() - ns[seen].min())
    span_cyc = float(cyc[seen].max() - cyc[seen].min())
    per_us = span_cyc / span_ns * 1e3 if span_ns > 0 else float("nan")  # cycles a µs
    rows = range(1, steps) if steps > 1 else range(steps)
    out = {"clock_mhz": per_us}
    for k, name in enumerate(PHASES):
        ds = [float(cyc[s, k + 1] - cyc[s, k]) / per_us for s in rows
              if seen[s, k] and seen[s, k + 1]]
        if ds:
            out[name] = statistics.median(ds)
    if steps > 1:
        out["step"] = statistics.median(float(cyc[s, 0] - cyc[s - 1, 0]) / per_us
                                        for s in range(1, steps))
    return out


def step_checks(libs: dict) -> dict:
    """One frozen train step at global batch 256 (K2) and 1024 (K3) through
    the shipped, fresh-accumulator and uncentred builds, each against the
    plain loss (chip_smoke.step_readings): {build: {pool: readings}}."""
    sys.path.insert(0, str(build.PKG_DIR.parent))
    import chip_smoke  # the repository's root script: its train-step check

    out = {}
    try:
        for name in ("shipped", "fresh accumulator", "uncentred"):
            saved = infonce._launchers
            fns = infonce.bind(libs[name])
            infonce._launchers = lambda: fns
            try:
                out[name] = {pool: chip_smoke.step_readings(pool) for pool in (256, 1024)}
            finally:
                infonce._launchers = saved
            for pool, r in out[name].items():
                print(f"[probe] step check {name} at {pool}: loss {r['loss_rel_err']:.3g}, "
                      f"gradients {r['grad_rel_err']:.3g} (limits 1e-5), {r['over_bound']} "
                      f"params past Adam's bound: {'ok' if r['ok'] else 'FAIL'}", flush=True)
    finally:
        shutil.rmtree(chip_smoke.WORK, ignore_errors=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--step-check", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_infonce needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = gpu_line()
    print(gpu, flush=True)
    libs = build_all(args.step_check)
    bound = {name: infonce.bind(lib) for name, lib in libs.items() if name != "ffma"}
    gen = torch.Generator(device="cuda").manual_seed(0)
    readings = {"gpu": gpu, "pools": {}}
    for name, (fn, _, ty) in SETTERS.items():
        getattr(libs[name], fn).argtypes = [ctypes.c_void_p]
    for B in POOLS:
        x, y = (torch.nn.functional.normalize(torch.randn(B, D, device="cuda", generator=gen),
                                              dim=-1) * math.exp(0.5) for _ in range(2))
        tiled = B > infonce.K2_MAX_POOL
        mode = "tiled" if tiled else "fused"
        ref = float64_infonce(x, y)
        xr, yr = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
        loss = infonce.clip_infonce(xr, yr)
        loss.backward()
        plain_gap = gap((loss.detach(), xr.grad, yr.grad), ref)
        print(f"[probe] B={B} D={D} clip_infonce (torch f32): largest relative gap from "
              f"float64 {plain_gap:.3g} | {gpu}", flush=True)
        variants = {"ffma": ffma_runner(libs["ffma"], x, y, B) + (None,)}
        variants["shipped"] = runner(bound["shipped"], x, y, B, (4, 4), mode)
        if not tiled:
            variants["separate"] = runner(bound["shipped"], x, y, B, (4, 4), "separate")
        for name in ("cluster 8", "fresh accumulator", "uncentred", "timed"):
            variants[name] = runner(bound[name], x, y, B, (4, 2) if name == "cluster 8" else (4, 4),
                                    mode)
        n_rows = -(-B // 256)
        if tiled:
            variants["sweep resident"] = runner(bound["shipped"], x, y, B, (4, 4), "tiled",
                                                resident_sweep(B, variants["shipped"][2]))
            buf = torch.empty(-(-B // 64) * 64, -(-B // 64) * 64, device="cuda")
            if libs["kept"].pct_probe_set_logits(buf.data_ptr()) != 0:
                raise RuntimeError("pct_probe_set_logits failed")
            variants["kept"] = runner(bound["kept"], x, y, B, (4, 4), "tiled")
        u, v = (1, 1) if not tiled else infonce.sweep_clusters(B, variants["shipped"][2])
        marks = torch.zeros(u * v * 16 * MARK_STEPS * 16, dtype=torch.int64, device="cuda")
        if libs["timed"].pct_probe_set_marks(marks.data_ptr()) != 0:
            raise RuntimeError("pct_probe_set_marks failed")
        times = {name: [] for name in variants}
        for order in (list(variants), list(variants)[::-1]):
            for name in order:
                times[name].append(events_ms(variants[name][0], ITERS[B]))
        row = {}
        for name, (run, outs, clusters) in variants.items():
            run()
            torch.cuda.synchronize()
            row[name] = {"ms": times[name], "rel_gap": gap(outs, ref), "clusters": clusters}
            print(f"[probe] B={B} D={D} {name:15s}: forward+backward "
                  f"{', '.join(f'{t:.6f}' for t in times[name])} ms (two passes), largest "
                  f"relative gap from float64 {row[name]['rel_gap']:.3g}"
                  + (f", {clusters} clusters at once" if clusters else "") + f" | {gpu}",
                  flush=True)
        row["clip_infonce_rel_gap"] = plain_gap
        steps = (-(-n_rows // u)) * (-(-n_rows // v))
        row["step_phases_us"] = step_phases(marks.cpu(), steps)
        print(f"[probe] B={B} D={D} timed: a backward step's phases (cluster 0, rank 0, median "
              f"over {max(1, steps - 1)} steps), µs: "
              + ", ".join(f"{k} {t:.3f}" for k, t in row["step_phases_us"].items())
              + f" | {gpu}", flush=True)
        row["wall_ms"] = wall_ms(libs, bound["shipped"], x, y, B)
        print(f"[probe] B={B} D={D} with the host (CUDA events over back-to-back calls "
              f"through autograd): "
              + "; ".join(f"{k} {', '.join(f'{t:.6f}' for t in v)} ms"
                          for k, v in row["wall_ms"].items()) + f" (two passes) | {gpu}",
              flush=True)
        readings["pools"][B] = row
    if args.step_check:
        readings["step_check"] = step_checks(libs)
    if args.out:
        args.out.write_text(json.dumps(readings, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
