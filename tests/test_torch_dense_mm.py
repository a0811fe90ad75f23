"""P1's plain version (``ops/dense_mm.mm_reference``) against the TPU probe's
own oracle, and the wrapper on the CPU.

``tools/probe_int8_pallas.mm`` has no interpret mode and runs only on a
TPU, so the port is held against the oracle that probe checks itself with
(``probe_int8_pallas.py:71-73``: an ``np.int32`` matmul of the s8 operands):
the s8 -> s32 form must equal it to the bit. The bf16 -> f32 form must lie
within 1e-6 of |x| @ |w| of a float64 product (the scale of an f32 sum's
rounding error). Inputs come from a numpy seed.
"""

import numpy as np
import pytest
import torch

from protein_clip_tpu_torch.ops import dense_mm


def _oracle(xi: np.ndarray, wi: np.ndarray) -> np.ndarray:
    # tools/probe_int8_pallas.py:71: the probe's exactness reference
    return np.asarray(xi, np.int32) @ np.asarray(wi, np.int32)


@pytest.mark.parametrize("M", [64, 640])
@pytest.mark.parametrize("K", [32, 640])
@pytest.mark.parametrize("N", [1, 37, 256])
def test_s8_reference_equals_the_probe_oracle(N, K, M):
    rng = np.random.default_rng(N * 7 + K + M)
    xi = rng.integers(-127, 128, (N, K)).astype(np.int8)
    wi = rng.integers(-127, 128, (K, M)).astype(np.int8)
    got = dense_mm.mm_reference(torch.from_numpy(xi), torch.from_numpy(wi), torch.int32)
    assert got.dtype == torch.int32 and got.shape == (N, M)
    np.testing.assert_array_equal(got.numpy(), _oracle(xi, wi))


@pytest.mark.parametrize("value", [127, -127, -128])
def test_s8_reference_at_the_extremes(value):
    """Every operand at an extreme: the largest sums the layers can make
    (K = 2560, wo's fan-in), and signs mixed row by row."""
    K, M = 2560, 64
    xi = np.full((3, K), value, np.int8)
    xi[1] = -127
    xi[2, ::2] = -128
    wi = np.full((K, M), value, np.int8)
    wi[:, 1::2] = 127
    got = dense_mm.mm_reference(torch.from_numpy(xi), torch.from_numpy(wi), torch.int32)
    want = _oracle(xi, wi)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(want).max() >= K * 127 * 127


@pytest.mark.parametrize("N,K,M", [(1, 32, 64), (37, 640, 640), (256, 640, 2560)])
def test_bf16_reference_within_f32_rounding_of_float64(N, K, M):
    rng = np.random.default_rng(N + K)
    x = torch.from_numpy(rng.normal(size=(N, K)).astype(np.float32)).bfloat16()
    w = torch.from_numpy((rng.normal(size=(K, M)) * 0.05).astype(np.float32)).bfloat16()
    got = dense_mm.mm_reference(x, w, torch.float32)
    assert got.dtype == torch.float32
    want = torch.matmul(x.double(), w.double())
    scale = torch.matmul(x.double().abs(), w.double().abs())
    assert bool(((got.double() - want).abs() <= 1e-6 * scale).all())


def test_wrapper_runs_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(1)
    xi = torch.from_numpy(rng.integers(-128, 128, (5, 64)).astype(np.int8))
    wi = torch.from_numpy(rng.integers(-128, 128, (64, 16)).astype(np.int8))
    before = dense_mm.mm.launches
    got = dense_mm.mm(xi, wi, torch.int32)
    assert dense_mm.mm.launches == before
    np.testing.assert_array_equal(got.numpy(), _oracle(xi.numpy(), wi.numpy()))


@pytest.mark.parametrize("x_dtype,w_dtype,out_dtype", [
    (torch.int8, torch.int8, torch.float32),
    (torch.int8, torch.bfloat16, torch.int32),
    (torch.float32, torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16),
])
def test_wrapper_refuses_other_types(x_dtype, w_dtype, out_dtype):
    x = torch.zeros(4, 32, dtype=x_dtype)
    w = torch.zeros(32, 8, dtype=w_dtype)
    with pytest.raises(TypeError, match="int8 x int8 -> int32"):
        dense_mm.mm(x, w, out_dtype)


def test_wrapper_refuses_mismatched_shapes():
    with pytest.raises(ValueError, match=r"\(N, K\)"):
        dense_mm.mm(torch.zeros(4, 32, dtype=torch.int8), torch.zeros(64, 8, dtype=torch.int8),
                    torch.int32)
