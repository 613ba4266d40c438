"""High-accuracy (eps<=1e-6) float32 solves via compensated residuals
(VERDICT r4 item 5): in f32, tight tolerances rely on double-f32
residual evaluation + compensated-refinement linear solves
(scs_tpu/ops/df32.py, Core.hi_acc). These tests run the same machinery
on CPU-f32 and check against CPU-f64 ground truth."""

import numpy as np
from numpy.testing import assert_almost_equal
from scipy import sparse as sp

import scs_tpu as scs


def _qp(m, n, seed=0):
    """Feasible-by-construction QP with known optimal objective (oracle
    recipe, f64): x0 optimal with duals (y, s) by KKT construction."""
    rng = np.random.RandomState(seed)
    A = rng.randn(m, n) / np.sqrt(m)
    G = rng.randn(n, max(1, n // 8))
    P = 0.1 / G.shape[1] * (G @ G.T) + 1e-4 * np.eye(n)
    z = rng.randn(m)
    y = np.maximum(z, 0)
    s = y - z
    x = rng.randn(n)
    c = -A.T @ y - P @ x
    b = A @ x + s
    p_star = float(0.5 * x @ (P @ x) + c @ x)
    data = {
        "A": sp.csc_matrix(A),
        "b": b,
        "c": c,
        "P": sp.csc_matrix(np.triu(P)),
    }
    return data, p_star


def test_df32_matvec_accuracy():
    """Compensated matvec is ~1-ulp f32 regardless of n."""
    from scs_tpu.ops import df32
    import jax.numpy as jnp

    rng = np.random.RandomState(1)
    M = rng.randn(300, 400).astype(np.float32)
    v = rng.randn(400).astype(np.float32)
    ref = M.astype(np.float64) @ v.astype(np.float64)
    out = np.asarray(df32.mv(jnp.asarray(M), jnp.asarray(v)), np.float64)
    rel = np.linalg.norm(out - ref) / np.linalg.norm(ref)
    assert rel < 5e-7, rel
    out_t = np.asarray(
        df32.tv(jnp.asarray(M.T.copy()), jnp.asarray(v)), np.float64
    )
    # tv reduces over rows: M.T (400,300)... build the matching ref
    ref_t = M.astype(np.float64) @ v.astype(np.float64)
    rel = np.linalg.norm(out_t - ref_t) / np.linalg.norm(ref_t)
    assert rel < 5e-7, rel


def test_hi_acc_flag_resolution():
    data, _ = _qp(30, 20, seed=3)
    s_lo = scs.SCS(data, {"l": 30}, verbose=False, dtype="float32")
    assert not s_lo.core.hi_acc
    s_hi = scs.SCS(
        data, {"l": 30}, verbose=False, dtype="float32",
        eps_abs=1e-6, eps_rel=1e-6,
    )
    assert s_hi.core.hi_acc
    assert s_hi.core.refine_steps == 2


def test_qp_eps6_f32_matches_f64():
    """Flagship-family QP at eps=1e-6 in FLOAT32: status solved and
    objective matching the known f64 optimum to 5 decimals (the VERDICT
    item-5 acceptance check, runnable on-chip where f64 cannot)."""
    data, p_star = _qp(150, 100, seed=7)
    sol = scs.solve(
        dict(data), {"l": 150}, dtype="float32",
        eps_abs=1e-6, eps_rel=1e-6, verbose=False, max_iters=50000,
    )
    assert sol["info"]["status"] == "solved"
    assert_almost_equal(sol["info"]["pobj"], p_star, decimal=5)
    # independent f64 KKT check on the raw data
    A = np.asarray(data["A"].todense(), np.float64)
    Pu = np.asarray(data["P"].todense(), np.float64)
    P = Pu + Pu.T - np.diag(np.diag(Pu))
    x, y, s = (
        np.asarray(sol["x"], np.float64),
        np.asarray(sol["y"], np.float64),
        np.asarray(sol["s"], np.float64),
    )
    rp = np.linalg.norm(A @ x + s - data["b"])
    rd = np.linalg.norm(P @ x + A.T @ y + data["c"])
    scale_p = 1 + max(np.linalg.norm(A @ x), np.linalg.norm(data["b"]))
    scale_d = 1 + max(np.linalg.norm(P @ x), np.linalg.norm(data["c"]))
    assert rp < 2e-6 * scale_p, rp
    assert rd < 2e-6 * scale_d, rd


def test_qp_eps6_f32_batched():
    """Batched path at eps=1e-6 f32: every problem certifies solved with
    objectives matching the per-problem f64 optima."""
    B = 4
    probs = [_qp(60, 40, seed=10 + i) for i in range(B)]
    A = np.stack([np.asarray(d["A"].todense()) for d, _ in probs])
    Pfull = []
    for d, _ in probs:
        U = np.asarray(d["P"].todense())
        Pfull.append(U + U.T - np.diag(np.diag(U)))
    res = scs.solve_batch(
        {
            "A": A,
            "P": np.stack(Pfull),
            "b": np.stack([d["b"] for d, _ in probs]),
            "c": np.stack([d["c"] for d, _ in probs]),
        },
        {"l": 60},
        dtype="float32",
        eps_abs=1e-6,
        eps_rel=1e-6,
        max_iters=50000,
        verbose=False,
    )
    for (d, p_star), r in zip(probs, res):
        assert r["info"]["status"] == "solved"
        assert_almost_equal(r["info"]["pobj"], p_star, decimal=5)
