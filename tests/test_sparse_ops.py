"""Block-ELL SpMV: packing and the SpMV against scipy in float64."""

import numpy as np
import pytest
from scipy import sparse

import jax.numpy as jnp

from scs_tpu.ops.sparse import bell_spmv_ref, pack_bell


def _rand_csc(m, n, density, seed):
    rng = np.random.RandomState(seed)
    A = sparse.random(m, n, density=density, random_state=rng, format="csc")
    A.sort_indices()
    return A


@pytest.mark.parametrize("m,n,bs", [(100, 70, 8), (300, 200, 16), (64, 64, 32)])
def test_pack_bell_mv_rmv(m, n, bs):
    A = _rand_csc(m, n, 0.05, m + n)
    bm = pack_bell(A, block_size=bs, dtype=jnp.float32)
    x = np.random.RandomState(1).randn(n).astype(np.float32)
    y = np.random.RandomState(2).randn(m).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(bm.mv(jnp.asarray(x))),
        A @ x, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(bm.rmv(jnp.asarray(y))),
        A.T @ y, rtol=1e-4, atol=1e-5)
    # Jacobi data
    np.testing.assert_allclose(
        np.asarray(bm.col_sq),
        np.asarray(A.multiply(A).sum(axis=0)).ravel(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize(
    "m,n,bs", [(96, 80, 16), (101, 37, 16), (33, 130, 32), (7, 5, 8)]
)
def test_bell_spmv_matches_scipy_f64(m, n, bs, dtype):
    """The one SpMV (A @ x and A^T @ y through the packed tiles) against
    scipy's CSC product in float64, on ragged m and n (partial edge
    tiles). Tolerance: the product's own rounding in `dtype`, relative to
    |A| |x| (a few ulps of the accumulation over <= n terms)."""
    A = _rand_csc(m, n, 0.1, m * 7 + n)
    dt = np.dtype(dtype)
    bm = pack_bell(A, block_size=bs, dtype=jnp.dtype(dt))
    rng = np.random.RandomState(3)
    x = rng.randn(n).astype(dt)
    y = rng.randn(m).astype(dt)
    x_pad = jnp.zeros(bm.n_pad, dt).at[:n].set(jnp.asarray(x))
    y_pad = jnp.zeros(bm.m_pad, dt).at[:m].set(jnp.asarray(y))
    out_x = np.asarray(bell_spmv_ref(bm.A_blocks, bm.A_cols, x_pad))
    out_y = np.asarray(bell_spmv_ref(bm.At_blocks, bm.At_cols, y_pad))
    assert out_x.dtype == dt and out_x.shape == (bm.m_pad,)
    assert out_y.dtype == dt and out_y.shape == (bm.n_pad,)
    tol = 50 * np.finfo(dt).eps
    A64 = A.astype(np.float64)
    for got, ref, scale in (
        (out_x[:m], A64 @ x.astype(np.float64), abs(A64) @ np.abs(x)),
        (out_y[:n], A64.T @ y.astype(np.float64), abs(A64).T @ np.abs(y)),
    ):
        assert np.all(np.abs(got - ref) <= tol * (scale + 1e-30))
    # padding rows/columns of the output are exactly zero
    assert not out_x[m:].any() and not out_y[n:].any()


def test_numpy_packer_agrees_with_native():
    from scs_tpu import native
    from scs_tpu.ops.sparse import _pack_bell_numpy

    if not native.available:
        pytest.skip("native library unavailable")
    A = _rand_csc(50, 40, 0.12, 11)
    bn, cn = native.pack_block_ell(A, 8)
    bp, cp = _pack_bell_numpy(A, 8)
    # widths may differ only if counts differ (they must not)
    assert bn.shape == bp.shape
    # same block-sparsity => same dense reconstruction
    def densify(blocks, cols, m, n, bs):
        nbr, width = cols.shape
        out = np.zeros((nbr * bs, -(-n // bs) * bs))
        for bi in range(nbr):
            for w in range(width):
                bj = int(cols[bi, w])
                out[bi*bs:(bi+1)*bs, bj*bs:(bj+1)*bs] += blocks[bi, w]
        return out[:m, :n]
    np.testing.assert_allclose(densify(bn, cn, 50, 40, 8),
                               densify(bp, cp, 50, 40, 8))
    np.testing.assert_allclose(densify(bn, cn, 50, 40, 8), A.toarray())
