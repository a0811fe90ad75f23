"""Symmetric InfoNCE for dual-encoder contrastive training (kernels K2, K3).

The port of ``protein_clip_tpu/ops/infonce.py`` (the plain versions
``clip_infonce``, ``infonce_from_logits``, ``naive_infonce_from_logits``,
and FILIP's ``filip_direction_loss`` and ``filip_loss``) and of ``protein_clip_tpu/ops/infonce_pallas.py`` (the fused loss). With
(B, D) embeddings x, y already scaled by exp(t/2) each, ``logits = x y^T``
carries exp(t) and

    loss = 0.5 * (mean_i(lse_row_i - diag_i) + mean_j(lse_col_j - diag_j)).

``fused_infonce`` (K2: one thread-block cluster, pools up to
``K2_MAX_POOL``) and ``fused_infonce_tiled`` (K3, large pools) are
``torch.autograd.Function`` wrappers of the hand-written CUDA kernels in
``csrc/infonce.cu``, forward and backward; the kernel's note gives their
bound on an H100 and what the design does about it. K2's forward also
forms the gradients for a cotangent of 1 when a gradient is wanted, and
its backward only scales them; K3's backward sweeps the logit tiles with
``sweep_clusters`` clusters. Each call allocates one output buffer and at
most one scratch buffer. On CPU tensors each is the plain ``clip_infonce``
(autograd through plain torch ops); on CUDA tensors it launches its
kernels or raises. The temperature's gradient flows outside the kernel,
through the exp(t/2) scaling of the embeddings, so the kernels return the
gradients of x and y only.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..kernels import build

MAX_DIM = 256          # embedding dims the kernels take (multiples of 4)
MAX_POOL = 65536       # K3's forward partials take pool^2 / 4 bytes of scratch
K2_MAX_POOL = 512      # K2 runs as one thread-block cluster (csrc/infonce.cu kK2MaxPool)
TILE = 64              # rows of a logit tile (csrc/infonce.cu)
CLUSTER = (4, 4)       # a cluster's blocks: rows x columns of tiles (kRc, kCc)
MAX_PLANES = 6         # K3's backward writes at most this many B x D partial planes


def infonce_from_logits(logits: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    diag = torch.diagonal(logits)
    l_r = torch.mean(torch.logsumexp(logits, dim=1) - diag)
    l_p = torch.mean(torch.logsumexp(logits, dim=0) - diag)
    return 0.5 * (l_r + l_p)


def clip_infonce(pep: torch.Tensor, rec: torch.Tensor) -> torch.Tensor:
    """Plain version: symmetric InfoNCE over scaled embeddings, stable
    log-sum-exp form, logits in f32."""
    return infonce_from_logits(torch.matmul(pep.float(), rec.float().T))


def naive_infonce_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """The reference's exp-then-log recipe, as a parity oracle only: it
    overflows once the temperature grows."""
    logits = logits.float()
    exp_logits = torch.exp(logits)
    diag = torch.diagonal(logits)
    l_r = -torch.mean(torch.log(torch.exp(diag) / exp_logits.sum(1)))
    l_p = -torch.mean(torch.log(torch.exp(diag) / exp_logits.sum(0)))
    return 0.5 * (l_r + l_p)


def filip_direction_loss(logits: torch.Tensor, use_dcl: bool = False) -> torch.Tensor:
    """FILIP's cross-entropy of one direction, mean over rows of
    logsumexp(row) - diag, in f32. With ``use_dcl`` the diagonal leaves
    the denominator (decoupled contrastive learning)."""
    logits = logits.float()
    diag = torch.diagonal(logits)
    denom = logits
    if use_dcl:
        eye = torch.eye(logits.shape[0], dtype=torch.bool, device=logits.device)
        denom = logits.masked_fill(eye, float("-inf"))
    return torch.mean(torch.logsumexp(denom, dim=1) - diag)


def filip_loss(sim_a: torch.Tensor, sim_b: torch.Tensor, use_dcl: bool = False) -> torch.Tensor:
    """The mean of the two directions' losses over FILIP's (B, B) scores."""
    return 0.5 * (filip_direction_loss(sim_a, use_dcl) + filip_direction_loss(sim_b, use_dcl))


def _tiles(b: int) -> int:
    return -(-b // TILE)


def super_blocks(b: int, cluster: tuple[int, int] = CLUSTER) -> tuple[int, int]:
    """Row and column super-blocks of a pool of b: the cluster's steps over
    the tile grid (``cluster`` tiles each)."""
    nb = _tiles(b)
    return -(-nb // cluster[0]), -(-nb // cluster[1])


def scratch_floats(b: int) -> int:
    """Floats of K3's forward scratch (csrc/infonce.cu ``Scratch``): the row
    and column (max, sum) partials of every tile, and diag."""
    return (4 * _tiles(b) + 1) * b


@functools.cache
def sweep_clusters(b: int, max_clusters: int,
                   cluster: tuple[int, int] = CLUSTER) -> tuple[int, int]:
    """(U, V): K3's backward runs U x V clusters, U ranges of row
    super-blocks by V of column ones, in waves of the ``max_clusters`` the
    card holds at once. The fewest waves times steps a cluster, then the
    fewest partial planes (U - 1 + V - 1, at most MAX_PLANES); no range
    empty. More clusters than fit at once can win: at (1024, 128) 16
    clusters of one step in three waves beat 4 of four steps in one
    (tools/probe_infonce.py, PERF.md)."""
    n_rows, n_cols = super_blocks(b, cluster)
    most = max(1, max_clusters)
    best = None
    for u in range(1, min(n_rows, MAX_PLANES + 1) + 1):
        for v in range(1, min(n_cols, MAX_PLANES + 2 - u) + 1):
            steps = -(-n_rows // u) * -(-n_cols // v)
            key = (-(-u * v // most) * steps, u + v, -v)
            if best is None or key < best[0]:
                best = (key, (u, v))
    return best[1]


def partial_floats(b: int, d: int, max_clusters: int) -> int:
    """Floats of K3's backward partial planes: the dX parts of column ranges
    1 .. V - 1 and the dY parts of row ranges 1 .. U - 1 (range 0 sums into
    dX and dY themselves); K2 sums in its cluster and has none."""
    u, v = sweep_clusters(b, max_clusters)
    return (u - 1 + v - 1) * b * d


def kernels_per_call(b: int, tiled: bool, max_clusters: int) -> int:
    """Device kernels of one forward plus backward: K2 its cluster launch
    and the cotangent's scale; K3 its tile and combine launches, the
    backward's clusters and, with partial planes, the reduce."""
    if not tiled:
        if b > K2_MAX_POOL:
            raise ValueError(f"K2 takes pools up to {K2_MAX_POOL}, got {b}")
        return 2
    u, v = sweep_clusters(b, max_clusters)
    return 3 + (u * v > 1)


def bind(lib: ctypes.CDLL) -> dict:
    """The C entry points of a build of ``csrc/infonce.cu``, typed."""
    fns = {}
    for name, args in (
            ("pct_infonce_fwd", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3),
            ("pct_infonce_scale", [ctypes.c_void_p] * 3 + [ctypes.c_longlong]),
            ("pct_infonce_tiled_fwd", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2),
            ("pct_infonce_bwd", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4),
            ("pct_infonce_max_clusters", [])):
        fn = getattr(lib, name)
        fn.argtypes = args + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    fns["pct_infonce_max_clusters"].argtypes = [ctypes.POINTER(ctypes.c_int)]
    return fns


@functools.cache
def _launchers() -> dict:
    """The kernels' C entry points, built and loaded at first use."""
    return bind(build.load("infonce"))


@functools.cache
def max_clusters(index: int) -> int:
    """Clusters of K3's backward that device ``index`` holds at once."""
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _launchers()["pct_infonce_max_clusters"](ctypes.byref(out))
    if err != 0 or out.value < 1:
        raise RuntimeError(f"pct_infonce_max_clusters failed: cudaError_t {err}, {out.value}")
    return out.value


def _check(x: torch.Tensor, y: torch.Tensor, tiled: bool = True) -> None:
    if x.dim() != 2 or x.shape != y.shape:
        raise ValueError(f"x and y must both be (B, D), got {tuple(x.shape)} and "
                         f"{tuple(y.shape)}")
    B, D = x.shape
    for name, t in (("x", x), ("y", y)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on CUDA, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if D % 4 or not 0 < D <= MAX_DIM:
        raise ValueError(f"embedding dim D={D} must be a multiple of 4 in [4, {MAX_DIM}]")
    top = MAX_POOL if tiled else K2_MAX_POOL
    if not 0 < B <= top:
        raise ValueError(f"pool size B={B} must be in [1, {top}]"
                         + ("" if tiled else " for K2 (fused_infonce_tiled takes more)"))


def _launch(name: str, device: torch.device, *args) -> None:
    if device.index == torch.cuda.current_device():
        err = _launchers()[name](*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            err = _launchers()[name](*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


class _InfoNCE(torch.autograd.Function):
    """Forward and backward through the kernels; ``tiled`` picks K3. K2's
    forward also writes the gradients for a cotangent of 1 when ``grads``,
    and its backward scales them."""

    @staticmethod
    def forward(ctx, x, y, tiled: bool, grads: bool):
        B, D = x.shape
        dev = x.device
        ctx.tiled = tiled
        if tiled:
            out = torch.empty(4 + 2 * B, dtype=torch.float32, device=dev)
            loss, lse_r, lse_c = out[0], out[4:4 + B], out[4 + B:]
            scratch = torch.empty(scratch_floats(B), dtype=torch.float32, device=dev)
            _launch("pct_infonce_tiled_fwd", dev, x.data_ptr(), y.data_ptr(), scratch.data_ptr(),
                    loss.data_ptr(), lse_r.data_ptr(), lse_c.data_ptr(), B, D)
            fused_infonce_tiled.launches += 1
            ctx.save_for_backward(x, y, lse_r, lse_c)
            return loss
        # the loss and the lse; when grads, the scratch holds [dX | dY] for
        # g = 1 and dL's diagonal (kept apart, so that the loss a caller
        # keeps holds B floats, not the gradients)
        out = torch.empty(4 + 2 * B, dtype=torch.float32, device=dev)
        loss, lse_r, lse_c = out[0], out[4:4 + B], out[4 + B:]
        n = 2 * B * D if grads else 0
        unit = torch.empty(n + B if grads else 0, dtype=torch.float32, device=dev)
        base = unit.data_ptr()
        _launch("pct_infonce_fwd", dev, x.data_ptr(), y.data_ptr(), loss.data_ptr(),
                lse_r.data_ptr(), lse_c.data_ptr(), base, base + 4 * B * D, base + 4 * n, B, D,
                int(grads))
        fused_infonce.launches += 1
        ctx.unit_grads, ctx.shape = unit[:n], (B, D)
        return loss

    @staticmethod
    def backward(ctx, g):
        g = g.to(torch.float32).contiguous()
        if not ctx.tiled:
            unit = ctx.unit_grads
            if unit.numel() == 0:
                raise RuntimeError("fused_infonce's forward ran without a gradient wanted")
            grads = torch.empty_like(unit)
            _launch("pct_infonce_scale", unit.device, unit.data_ptr(), g.data_ptr(),
                    grads.data_ptr(), unit.numel())
            fused_infonce.bwd_launches += 1
            dx, dy = grads.view(2, *ctx.shape)
            return dx, dy, None, None
        x, y, lse_r, lse_c = ctx.saved_tensors
        B, D = x.shape
        u, v = sweep_clusters(B, max_clusters(x.device.index))
        grads = torch.empty(2, B, D, dtype=torch.float32, device=x.device)
        # the partial planes, then dL's diagonal
        part = torch.empty(partial_floats(B, D, max_clusters(x.device.index)) + B,
                           dtype=torch.float32, device=x.device)
        _launch("pct_infonce_bwd", x.device, x.data_ptr(), y.data_ptr(), lse_r.data_ptr(),
                lse_c.data_ptr(), g.data_ptr(), grads[0].data_ptr(), grads[1].data_ptr(),
                part.data_ptr(), B, D, u, v)
        fused_infonce_tiled.bwd_launches += 1
        return grads[0], grads[1], None, None


def _fused(x: torch.Tensor, y: torch.Tensor, tiled: bool) -> torch.Tensor:
    if x.device.type == "cpu":
        return clip_infonce(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"fused InfoNCE runs on cpu or cuda, not {x.device}")
    _check(x, y, tiled)
    grads = torch.is_grad_enabled() and (x.requires_grad or y.requires_grad)
    return _InfoNCE.apply(x, y, tiled, grads and not tiled)


def fused_infonce(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K2: (B, D) f32 x, y -> scalar loss, with its backward, for pools up to
    ``K2_MAX_POOL``. On CPU tensors the plain ``clip_infonce``; on CUDA
    tensors the kernels or an error. When a gradient is wanted (grad mode
    on and x or y requiring it) the forward's one launch also forms the
    gradients for a cotangent of 1, and the backward scales them."""
    return _fused(x, y, False)


def fused_infonce_tiled(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K3: as ``fused_infonce``, for pools past ``fused_infonce_fits``."""
    return _fused(x, y, True)


# Forward and backward calls that launched the kernels since the counts were
# last set to 0 (chip_smoke.py reads them).
fused_infonce.launches = fused_infonce.bwd_launches = 0
fused_infonce_tiled.launches = fused_infonce_tiled.bwd_launches = 0
