"""f32 spectral-cone kernels (round 5): the same dtype-robustness class
as the exp/pow fixes in test_mixed_cone_f32.py — every log/division
guard used to be a literal 1e-300, which is 0.0 in float32. These
sweeps pin NaN-freedom and
near-optimality vs the oracle for the four spectral cones (logdet,
nuclear, ell1, sum-of-k-largest) in BOTH dtypes; before r5 they were
exercised in f64 only (test_rand_full / test_coverage epigraph tests).
"""

import numpy as np
import pytest

import jax.numpy as jnp

import oracle
from scs_tpu.cones import sd_cone_size
from scs_tpu.ops import projections as pj


def _dist2(p, v):
    return np.sum((p - v) ** 2, axis=1)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("scale", [1.0, 20.0])
def test_ell1_f32(dtype, scale):
    rng = np.random.RandomState(3)
    nn = 7
    z = rng.randn(64, nn + 1) * scale
    out = np.asarray(pj._proj_ell1_batch(jnp.asarray(z, dtype)), np.float64)
    assert np.isfinite(out).all()
    ref = np.stack([oracle.proj_ell1(zi) for zi in z])
    excess = _dist2(out, z) - _dist2(ref, z)
    tol = (1e-9 if dtype == jnp.float64 else 2e-4) * (1 + scale**2)
    assert excess.max() < tol
    # epigraph validity: t >= ||x||_1 (within dtype noise)
    vtol = (1e-9 if dtype == jnp.float64 else 1e-4) * (1 + scale)
    assert (
        out[:, 0] >= np.abs(out[:, 1:]).sum(axis=1) - vtol
    ).all()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_nuclear_f32(dtype):
    rng = np.random.RandomState(5)
    mm, nn = 4, 3
    for scale in (1.0, 20.0):
        z = rng.randn(32, mm * nn + 1) * scale
        out = np.asarray(
            pj._proj_nuc_batch(jnp.asarray(z, dtype), (mm, nn)), np.float64
        )
        assert np.isfinite(out).all()
        ref = np.stack([oracle.proj_nuclear(zi, mm, nn) for zi in z])
        excess = _dist2(out, z) - _dist2(ref, z)
        tol = (1e-8 if dtype == jnp.float64 else 3e-4) * (1 + scale**2)
        assert excess.max() < tol
        # epigraph validity: t >= sum of singular values
        vtol = (1e-8 if dtype == jnp.float64 else 2e-4) * (1 + scale)
        for row in out:
            sv = np.linalg.svd(
                row[1:].reshape(mm, nn, order="F"), compute_uv=False
            )
            assert row[0] >= sv.sum() - vtol


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_sum_largest_f32(dtype):
    rng = np.random.RandomState(7)
    nn, kk = 5, 2
    sz = sd_cone_size(nn) + 1
    for scale in (1.0, 20.0):
        z = rng.randn(32, sz) * scale
        out = np.asarray(
            pj._proj_sl_batch(jnp.asarray(z, dtype), (nn, kk)), np.float64
        )
        assert np.isfinite(out).all()
        ref = np.stack([oracle.proj_sumlargest(zi, nn, kk) for zi in z])
        excess = _dist2(out, z) - _dist2(ref, z)
        tol = (2e-6 if dtype == jnp.float64 else 5e-4) * (1 + scale**2)
        assert excess.max() < tol


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_logdet_f32(dtype):
    rng = np.random.RandomState(9)
    nn = 4
    sz = sd_cone_size(nn) + 2
    for scale in (1.0, 10.0):
        z = rng.randn(24, sz) * scale
        out = np.asarray(
            pj._proj_logdet_batch(jnp.asarray(z, dtype), nn), np.float64
        )
        assert np.isfinite(out).all()
        ref = np.stack([oracle.proj_logdet(zi, nn) for zi in z])
        excess = _dist2(out, z) - _dist2(ref, z)
        # the logdet projection is itself an iterative dual solve in both
        # implementations; compare optimality, not elementwise equality
        tol = (5e-5 if dtype == jnp.float64 else 2e-3) * (1 + scale**2)
        assert excess.max() < tol


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_psd_and_csd_f32(dtype):
    """Batched eigh-based projections stay finite and idempotent in f32
    (the bench's dtype for the PSD path, also run on the GPU via the
    bench's mixed_cone block; pinned here for CPU CI)."""
    rng = np.random.RandomState(11)
    nn = 6
    sz = sd_cone_size(nn)
    z = rng.randn(32, sz) * 10.0
    out = np.asarray(pj._proj_psd_batch(jnp.asarray(z, dtype), nn))
    assert np.isfinite(out).all()
    # idempotence: projecting a projected point is (nearly) identity
    out2 = np.asarray(pj._proj_psd_batch(jnp.asarray(out, dtype), nn))
    atol = 1e-10 if dtype == jnp.float64 else 1e-4
    np.testing.assert_allclose(out2, out, atol=atol * 10)
    ref = np.stack([oracle.proj_sdp(zi, nn) for zi in z])
    np.testing.assert_allclose(
        out, ref, atol=1e-8 if dtype == jnp.float64 else 1e-4
    )
    zc = rng.randn(16, nn * nn) * 10.0
    outc = np.asarray(pj._proj_csd_batch(jnp.asarray(zc, dtype), nn))
    assert np.isfinite(outc).all()
    refc = np.stack([oracle.proj_csd(zi, nn) for zi in zc])
    np.testing.assert_allclose(
        outc, refc, atol=1e-8 if dtype == jnp.float64 else 1e-4
    )
