"""The port's InfoNCE (ops/infonce.py) against the JAX package's, on the CPU.

The same (B, D) embeddings, made with numpy, go through the JAX
``clip_infonce`` (and ``jax.grad``) and the Pallas ``fused_infonce`` /
``fused_infonce_tiled`` in interpret mode, as tests/test_pallas_infonce.py
runs them, and through the port's ``clip_infonce`` and its K2 / K3
wrappers, which on CPU tensors are the plain version with autograd.
Tolerances: loss rtol 1e-6 and gradients atol 1e-6 (float32; the two
frameworks sum in other orders). The kernels themselves run on the card:
tests/test_torch_cuda.py.
"""

import jax
import numpy as np
import pytest
import torch

from protein_clip_tpu.ops import infonce as jinfonce
from protein_clip_tpu.ops import infonce_pallas as jpallas
from protein_clip_tpu_torch.ops import infonce
from protein_clip_tpu_torch.train import clip_engine

RTOL, ATOL = 1e-6, 1e-6


def _embeddings(B, D, t=1.0, seed=0):
    """Unit rows scaled by exp(t/2), as the heads give them."""
    rng = np.random.default_rng(seed + B + D)
    x, y = (rng.normal(size=(B, D)).astype(np.float32) for _ in range(2))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    y /= np.linalg.norm(y, axis=1, keepdims=True)
    s = np.float32(np.exp(t / 2))
    return x * s, y * s


def _port_value_and_grad(fn, x, y):
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = torch.from_numpy(y).requires_grad_(True)
    loss = fn(xt, yt)
    loss.backward()
    return float(loss.detach()), xt.grad.numpy(), yt.grad.numpy()


def _jax_value_and_grad(fn, x, y):
    loss, (gx, gy) = jax.value_and_grad(fn, argnums=(0, 1))(x, y)
    return float(loss), np.asarray(gx), np.asarray(gy)


def _assert_same(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL)
    np.testing.assert_allclose(got[1], want[1], atol=ATOL)
    np.testing.assert_allclose(got[2], want[2], atol=ATOL)


@pytest.mark.parametrize("B,D", [(8, 16), (8, 128), (256, 16), (256, 128)])
@pytest.mark.parametrize("t", [1.0, 4.0])
def test_clip_infonce_matches_jax(B, D, t):
    x, y = _embeddings(B, D, t)
    _assert_same(_port_value_and_grad(infonce.clip_infonce, x, y),
                 _jax_value_and_grad(jinfonce.clip_infonce, x, y))


@pytest.mark.parametrize("B,D", [(8, 16), (8, 128), (256, 128)])
def test_fused_infonce_matches_pallas(B, D):
    x, y = _embeddings(B, D)
    _assert_same(_port_value_and_grad(infonce.fused_infonce, x, y),
                 _jax_value_and_grad(lambda a, b: jpallas.fused_infonce(a, b), x, y))


@pytest.mark.parametrize("B,rb", [(384, None), (512, 128)])
@pytest.mark.parametrize("D", [16, 128])
def test_fused_infonce_tiled_matches_pallas(B, rb, D):
    x, y = _embeddings(B, D)
    _assert_same(_port_value_and_grad(infonce.fused_infonce_tiled, x, y),
                 _jax_value_and_grad(lambda a, b: jpallas.fused_infonce_tiled(a, b, rb), x, y))


def test_large_logits_stay_finite():
    """tests/test_pallas_infonce.py::test_forward_large_logits_stable's
    inputs: N(0, 12^2) entries, logits up to about 2000. The loss holds to
    rtol 1e-6. f32 rounds a logit l by up to |l| 2^-23 (about 2.5e-4 here),
    and exp(l - lse) carries that into each probability, so the gradients
    are held to 2^-23 max|l| max|grad| instead of 1e-6."""
    rng = np.random.default_rng(42)
    x, y = (rng.normal(size=(32, 16)).astype(np.float32) * 12.0 for _ in range(2))
    got = _port_value_and_grad(infonce.fused_infonce, x, y)
    want = _jax_value_and_grad(lambda a, b: jpallas.fused_infonce(a, b), x, y)
    assert np.isfinite(got[0]) and np.isfinite(got[1]).all() and np.isfinite(got[2]).all()
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=2 ** -23 * np.abs(x @ y.T).max() * np.abs(w).max())


@pytest.mark.parametrize("t", [0.0, 2.0])
def test_logit_forms_match_jax(t):
    x, y = _embeddings(16, 32, t)
    logits = x @ y.T
    for port_fn, jax_fn in ((infonce.infonce_from_logits, jinfonce.infonce_from_logits),
                            (infonce.naive_infonce_from_logits,
                             jinfonce.naive_infonce_from_logits)):
        np.testing.assert_allclose(float(port_fn(torch.from_numpy(logits))),
                                   float(jax_fn(logits)), rtol=RTOL)


def test_naive_form_overflows_where_the_stable_one_does_not():
    logits = np.full((4, 4), 100.0, np.float32)
    assert not np.isfinite(float(infonce.naive_infonce_from_logits(torch.from_numpy(logits))))
    assert np.isfinite(float(infonce.infonce_from_logits(torch.from_numpy(logits))))


@pytest.mark.parametrize("b,fits", [(1, True), (16, True), (64, True), (256, True),
                                    (257, False), (1024, False), (4096, False)])
def test_dispatch_rule(b, fits):
    """K2 up to a pool of 256, K3 above (K2 is slower from 384 on an H100)."""
    assert clip_engine.fused_infonce_fits(b) is fits


@pytest.mark.parametrize("B", [16, 600])
def test_cpu_route_is_the_plain_one(B):
    """On CPU tensors the default loss and both wrappers return exactly the
    plain clip_infonce, and no kernel count moves."""
    x, y = (torch.from_numpy(a) for a in _embeddings(B, 32))
    counts = (infonce.fused_infonce.launches, infonce.fused_infonce.bwd_launches,
              infonce.fused_infonce_tiled.launches, infonce.fused_infonce_tiled.bwd_launches)
    want = infonce.clip_infonce(x, y)
    for fn in (clip_engine.default_loss_fn(), infonce.fused_infonce,
               infonce.fused_infonce_tiled):
        assert torch.equal(fn(x, y), want)
    assert counts == (infonce.fused_infonce.launches, infonce.fused_infonce.bwd_launches,
                      infonce.fused_infonce_tiled.launches,
                      infonce.fused_infonce_tiled.bwd_launches)


def test_other_devices_are_refused():
    x = torch.zeros(4, 8, device="meta")
    for fn in (infonce.fused_infonce, infonce.fused_infonce_tiled):
        with pytest.raises(ValueError, match="cpu or cuda"):
            fn(x, x)


@pytest.mark.parametrize("case,err,match", [
    ("dim", ValueError, "multiple of 4"),
    ("wide", ValueError, "multiple of 4"),
    ("dtype", TypeError, "float32"),
    ("layout", ValueError, "contiguous"),
    ("shape", ValueError, r"\(B, D\)"),
    ("empty", ValueError, "pool size"),
    ("k2_pool", ValueError, "for K2"),
])
def test_wrapper_checks(case, err, match):
    """The checks the CUDA path runs before a launch (device-independent)."""
    x = torch.zeros(8, 16)
    args = {"dim": (torch.zeros(8, 6), torch.zeros(8, 6)),
            "wide": (torch.zeros(8, 260), torch.zeros(8, 260)),
            "dtype": (x.bfloat16(), x.bfloat16()),
            "layout": (torch.zeros(16, 8).T, torch.zeros(16, 8).T),
            "shape": (x, torch.zeros(9, 16)),
            "empty": (torch.zeros(0, 16), torch.zeros(0, 16)),
            "k2_pool": (torch.zeros(513, 16), torch.zeros(513, 16), False)}[case]
    with pytest.raises(err, match=match):
        infonce._check(*args)


POOLS = [1, 64, 65, 256, 257, 1000, 1024, 4096, 65536]
# clusters of 16 blocks an H100 holds at once (pct_infonce_max_clusters)
H100_CLUSTERS = 7


@pytest.mark.parametrize("b", POOLS)
def test_sweep_clusters_cover_every_tile_once(b):
    """K3's backward: the U x V clusters' ranges of super-blocks (CLUSTER
    tiles a side each) cover every super-block of the tile grid once, no
    range is empty, and no more than MAX_PLANES partial planes are
    written."""
    u, v = infonce.sweep_clusters(b, H100_CLUSTERS)
    n_rows, n_cols = infonce.super_blocks(b)
    nb = -(-b // 64)
    assert (n_rows, n_cols) == (-(-nb // infonce.CLUSTER[0]), -(-nb // infonce.CLUSTER[1]))
    assert 1 <= u <= n_rows and 1 <= v <= n_cols and u - 1 + v - 1 <= infonce.MAX_PLANES
    covered = np.zeros((n_rows, n_cols), np.int64)
    for cu in range(u):
        rows = slice(cu * n_rows // u, (cu + 1) * n_rows // u)
        for cv in range(v):
            cols = slice(cv * n_cols // v, (cv + 1) * n_cols // v)
            assert rows.stop > rows.start and cols.stop > cols.start
            covered[rows, cols] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("b", POOLS)
def test_sweep_takes_the_fewest_waves_of_steps(b):
    """The sweep's clusters run in waves of what the card holds at once: no
    U x V within the plane limit takes fewer waves times steps a cluster,
    nor as few with fewer planes."""
    u, v = infonce.sweep_clusters(b, H100_CLUSTERS)
    n_rows, n_cols = infonce.super_blocks(b)

    def cost(a, c):
        return -(-a * c // H100_CLUSTERS) * -(-n_rows // a) * -(-n_cols // c)

    for a in range(1, n_rows + 1):
        for c in range(1, n_cols + 1):
            if a + c - 2 <= infonce.MAX_PLANES:
                assert (cost(u, v), u + v) <= (cost(a, c), a + c)


@pytest.mark.parametrize("b,uv", [(256, (1, 1)), (512, (2, 2)), (1024, (4, 4)),
                                  (4096, (2, 3))])
def test_sweep_at_the_measured_pools(b, uv):
    """At 1024 sixteen clusters of one step (three waves) and at 4096 six of
    48 steps (one wave): the shapes the card's readings chose."""
    assert infonce.sweep_clusters(b, H100_CLUSTERS) == uv


# the split design's backward (tools/probe_infonce_ffma.cu) on 132 SMs:
# splits of the other side's tiles, each a (B, D) partial per role
SPLITS_BEFORE = {256: 4, 1024: 8, 4096: 3}


@pytest.mark.parametrize("b", POOLS)
def test_partial_planes_are_fewer_than_the_split_design(b):
    """K3's backward writes U - 1 + V - 1 partial planes of B x D (range 0
    sums into dX and dY themselves), fewer floats than the split design's
    2 x splits x B x D where it was measured; one cluster has none."""
    u, v = infonce.sweep_clusters(b, H100_CLUSTERS)
    got = infonce.partial_floats(b, 128, H100_CLUSTERS)
    assert got == (u - 1 + v - 1) * b * 128
    if u * v == 1:
        assert got == 0
    if b in SPLITS_BEFORE:
        assert got < 2 * SPLITS_BEFORE[b] * b * 128


@pytest.mark.parametrize("b,k2,k3", [(1, 2, 3), (64, 2, 3), (65, 2, 3), (256, 2, 3), (257, 2, 4),
                                     (1000, None, 4), (1024, None, 4), (4096, None, 4),
                                     (65536, None, 4)])
def test_kernels_per_call(b, k2, k3):
    """Device kernels of a forward plus backward: K2 two (its cluster
    launch and the cotangent's scale) up to K2_MAX_POOL, and refuses more;
    K3 three (tiles, combine, one sweeping cluster) or four (with the
    reduce of partial planes). No fill kernel in either."""
    assert infonce.kernels_per_call(b, True, H100_CLUSTERS) == k3
    if k2 is None:
        assert b > infonce.K2_MAX_POOL
        with pytest.raises(ValueError, match="K2 takes pools up to"):
            infonce.kernels_per_call(b, False, H100_CLUSTERS)
    else:
        assert infonce.kernels_per_call(b, False, H100_CLUSTERS) == k2


def test_scratch_covers_every_partial():
    """K3's forward: 4 partial planes of ceil(B/64) x B floats, and diag."""
    assert infonce.scratch_floats(1) == 4 + 1
    assert infonce.scratch_floats(256) == 4 * 4 * 256 + 256
    assert infonce.scratch_floats(1000) == 4 * 16 * 1000 + 1000
