"""The port's retrieval scoring and ranking against the JAX package's
``eval/retrieval.py``, on the CPU in float32 with inputs made from a numpy
seed. Score matrices: the JAX scorer runs the Pallas max-sim kernel in
interpret mode and the port's the plain version; f32 means of unit-vector
dot products in another summation order, atol 2e-6. Blocks smaller than Q
and N put block edges inside the matrix."""

import jax.numpy as jnp
import numpy as np
import pytest

from protein_clip_tpu.eval import retrieval as jret
from protein_clip_tpu_torch.eval import retrieval

ATOL = 2e-6
DEVICE = "cpu"


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _queries(rng, q=5, ta=16, d=8):
    ha = _unit(rng.normal(size=(q, ta, d)))
    ma = (rng.random((q, ta)) < 0.8).astype(np.int32)
    ma[:, 0] = 1
    return ha, ma


def _index(rng, n=13, d=8):
    """A ragged index and its dense form (rows padded to the longest)."""
    lengths = rng.integers(3, 70, size=n).astype(np.int32)
    rows = [_unit(rng.normal(size=(int(L), d))) for L in lengths]
    tb = int(lengths.max()) if n else 1
    hb = np.zeros((n, tb, d), np.float32)
    mb = np.zeros((n, tb), np.int32)
    for i, row in enumerate(rows):
        hb[i, :len(row)] = row
        mb[i, :len(row)] = 1
    flat = np.concatenate(rows, axis=0) if n else np.zeros((0, d), np.float32)
    return flat, lengths, hb, mb


@pytest.mark.parametrize("t", [1.0, 0.7])
@pytest.mark.parametrize("row_block,col_block", [(64, 4096), (2, 4), (3, 5)])
def test_dense_score_matrix_matches(t, row_block, col_block):
    rng = np.random.default_rng(row_block * 10 + col_block)
    ha, ma = _queries(rng)
    _, _, hb, mb = _index(rng)
    got = retrieval.filip_score_matrix(ha, ma, hb, mb, t, row_block=row_block,
                                       col_block=col_block, device=DEVICE)
    want = jret.filip_score_matrix(ha, ma, hb, mb, jnp.asarray(t, jnp.float32),
                                   row_block=row_block, col_block=col_block)
    assert got.shape == (5, 13) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("t", [1.0, 0.7])
@pytest.mark.parametrize("row_block,col_block", [(64, 1024), (3, 4), (2, 6)])
def test_ragged_score_matrix_matches(t, row_block, col_block):
    rng = np.random.default_rng(row_block * 10 + col_block + 1)
    ha, ma = _queries(rng)
    flat, lengths, hb, mb = _index(rng)
    got = retrieval.filip_score_matrix_ragged(ha, ma, flat, lengths, t, row_block=row_block,
                                              col_block=col_block, device=DEVICE)
    want = jret.filip_score_matrix_ragged(ha, ma, flat, lengths, jnp.asarray(t, jnp.float32),
                                          row_block=row_block, col_block=col_block)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # the same scores as the dense index
    dense = retrieval.filip_score_matrix(ha, ma, hb, mb, t, device=DEVICE)
    np.testing.assert_allclose(got, dense, atol=ATOL, rtol=0)


@pytest.mark.parametrize("ragged", [False, True])
def test_empty_index(ragged):
    rng = np.random.default_rng(0)
    ha, ma = _queries(rng)
    flat, lengths, hb, mb = _index(rng, n=0)
    if ragged:
        got = retrieval.filip_score_matrix_ragged(ha, ma, flat, lengths, 1.0, device=DEVICE)
        want = jret.filip_score_matrix_ragged(ha, ma, flat, lengths, jnp.asarray(1.0))
    else:
        got = retrieval.filip_score_matrix(ha, ma, hb, mb, 1.0, device=DEVICE)
        want = jret.filip_score_matrix(ha, ma, hb, mb, jnp.asarray(1.0))
    assert got.shape == want.shape == (5, 0)


def test_filip_ranks_match():
    rng = np.random.default_rng(4)
    n, ta, tb, d = 6, 16, 24, 8
    ha = _unit(rng.normal(size=(n, ta, d)))
    hb = _unit(rng.normal(size=(n, tb, d)))
    ma = (rng.random((n, ta)) < 0.8).astype(np.int32)
    mb = (rng.random((n, tb)) < 0.8).astype(np.int32)
    ma[:, 0] = 1
    mb[:, 0] = 1
    got = retrieval.filip_ranks_from_tokens(ha, ma, hb, mb, 0.7, row_block=4, device=DEVICE)
    want = jret.filip_ranks_from_tokens(ha, ma, hb, mb, jnp.asarray(0.7, jnp.float32),
                                        row_block=4)
    np.testing.assert_array_equal(got, want)


def test_ranks_from_embeddings_match():
    rng = np.random.default_rng(5)
    pep = rng.normal(size=(20, 16)).astype(np.float32)
    rec = pep + 0.8 * rng.normal(size=(20, 16)).astype(np.float32)
    got = retrieval.ranks_from_embeddings(pep, rec)
    np.testing.assert_array_equal(got, jret.ranks_from_embeddings(jnp.asarray(pep),
                                                                  jnp.asarray(rec)))
    assert got.min() >= 1 and got.max() <= 20


@pytest.mark.parametrize("n", [1, 7, 16])
def test_topk_curve_and_random_baseline_match(n):
    ranks = np.random.default_rng(n).integers(1, n + 3, size=n)
    np.testing.assert_array_equal(retrieval.topk_curve(ranks, n), jret.topk_curve(ranks, n))
    np.testing.assert_array_equal(retrieval.random_baseline_curve(n, seed=3),
                                  jret.random_baseline_curve(n, seed=3))
