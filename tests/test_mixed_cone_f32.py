"""f32 mixed-cone regressions (round 5).

Until round 5, every f32 solve touching the exp cone FAILED with NaN: the
projection kernels guarded logs with a literal 1e-300, which underflows to
0.0 in float32 (log(0) = -inf), and the inner Newton parked overshooting
iterates on that denormal instead of halving (oracle inner_z semantics).
so the whole cone zoo beyond zero/nonneg was dead in f32. These tests pin the fixes at
the kernel level (NaN-freedom + near-optimality vs the oracle across input
scales in BOTH dtypes) and end-to-end (batched mixed-cone solve in f32).
"""

import numpy as np
import pytest

import jax.numpy as jnp

import oracle
from scs_tpu.ops import projections as pj

RNG = np.random.RandomState(0)


def _dist2(p, v):
    return np.sum((p - v) ** 2, axis=1)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("scale", [0.1, 1.0, 10.0, 100.0])
def test_exp_proj_f32_finite_and_near_optimal(dtype, scale):
    rng = np.random.RandomState(17)
    v = rng.randn(256, 3) * scale
    out = np.asarray(pj._proj_exp_batch(jnp.asarray(v, dtype)), np.float64)
    assert np.isfinite(out).all()
    ref = np.stack([oracle.proj_exp(vi) for vi in v])
    # optimality: our point must be (nearly) as close to v as the oracle's
    # — NOT elementwise-equal: near degenerate rays (optimal rho -> 0) the
    # oracle itself drifts ~1e-2 from the true projection (SLSQP
    # cross-checked in round 5) and we are the more accurate one.
    excess = _dist2(out, v) - _dist2(ref, v)
    tol = (1e-9 if dtype == jnp.float64 else 3e-4) * (1 + scale**2)
    assert excess.max() < tol
    # membership as DISTANCE to the cone (the exact in_exp test is
    # ill-conditioned near the apex: a point 1e-6 from the cone can have
    # s*exp(r/s) - t ~ 1e2 when s -> 0, so re-projection distance is the
    # meaningful metric)
    reproj = np.stack([oracle.proj_exp(p.copy()) for p in out])
    dist_to_cone = np.sqrt(_dist2(reproj, out))
    # the f64 floor is the ORACLE's own bisection resolution (~1e-6
    # relative: re-projecting its own boundary points moves them that
    # much), not our kernel's accuracy — the excess-distance assertion
    # above is the rigorous optimality check
    dtol = (3e-6 if dtype == jnp.float64 else 1e-4) * (1 + scale)
    assert dist_to_cone.max() < dtol


def test_exp_proj_degenerate_ray_beats_oracle():
    """v with s0 > 0, t0 < 0 and r0/s0 << 0: optimal rho -> 0 and the true
    projection is (r0, s0, ~0); the oracle's s drifts by ~1.6e-2 here
    while the collapsed-branch limit is exact (SLSQP ground truth
    dist^2 = 30.5359... vs oracle 30.5360...)."""
    v = np.array([[-15.92210628, 0.34189767, -7.81484659]])
    out = np.asarray(pj._proj_exp_batch(jnp.asarray(v, jnp.float64)))
    ref = oracle.proj_exp(v[0].copy())
    assert _dist2(out, v)[0] <= _dist2(ref[None], v)[0] + 1e-10
    np.testing.assert_allclose(out[0][0], v[0][0], rtol=1e-12)
    np.testing.assert_allclose(out[0][1], v[0][1], rtol=1e-6)
    assert 0.0 <= out[0][2] < 1e-12


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("a", [0.25, 0.65])
def test_pow_proj_f32_finite_and_near_optimal(dtype, a):
    rng = np.random.RandomState(21)
    for scale in (1.0, 30.0):
        v = rng.randn(256, 3) * scale
        out = np.asarray(
            pj._proj_pow_batch(jnp.asarray(v, dtype), jnp.full((256,), a, dtype)),
            np.float64,
        )
        assert np.isfinite(out).all()
        ref = np.stack([oracle.proj_pow(x, a) for x in v])
        excess = _dist2(out, v) - _dist2(ref, v)
        tol = (1e-9 if dtype == jnp.float64 else 5e-4) * (1 + scale**2)
        assert excess.max() < tol


def test_batched_mixed_cone_f32_solves():
    """End-to-end: the reference mixed-cone K (SOC+PSD+exp+pow) as an f32
    batch — the bench's configuration. Requires the cone-aware refinement
    default (simple-cone batches keep 0 passes; curved cones get the f32
    pass without which this batch runs to max_iters)."""
    from scs_tpu.batch import solve_batch

    K = {
        "z": 5,
        "l": 8,
        "q": [5, 3],
        "s": [3, 4],
        "ep": 3,
        "ed": 2,
        "p": [-0.25, 0.6],
    }
    m = oracle.cone_dims(K)
    n = m // 3
    rng = np.random.RandomState(3000)
    As, bs, cs, stars = [], [], [], []
    B = 4
    for _ in range(B):
        data, p_star, _sol = oracle.gen_feasible(K, n=n, density=0.2, rng=rng)
        k = np.linalg.norm(data["c"])
        As.append(np.asarray(data["A"].todense()))
        bs.append(data["b"])
        cs.append(data["c"] / k)
        stars.append(p_star / k)
    res = solve_batch(
        {"A": np.stack(As), "b": np.stack(bs), "c": np.stack(cs)},
        K,
        dtype="float32",
        eps_abs=1e-4,
        eps_rel=1e-4,
        scale=1.0,
        max_iters=20000,
        verbose=False,
    )
    for r, p_star in zip(res, stars):
        assert r["info"]["status"] == "solved"
        assert abs(r["info"]["pobj"] - p_star) < 2e-3


def test_refine_default_cone_aware():
    """BatchedSCS: simple-cone batches default to 0 refinement passes
    (flagship throughput), curved-cone batches to the auto policy."""
    from scs_tpu.batch import BatchedSCS

    rng = np.random.RandomState(0)
    B, m, n = 2, 12, 6
    A = rng.randn(B, m, n)
    b = rng.randn(B, m)
    c = rng.randn(B, n)
    s_simple = BatchedSCS(
        {"A": A, "b": b, "c": c}, {"l": m}, dtype="float32", verbose=False
    )
    assert s_simple.core.refine_steps == 0
    s_mixed = BatchedSCS(
        {"A": A, "b": b, "c": c},
        {"l": m - 5, "q": [5]},
        dtype="float32",
        verbose=False,
    )
    assert s_mixed.core.refine_steps == 2
