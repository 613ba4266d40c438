"""End-to-end solve through the block-ELL matrix-free strategy
("bell"): same problems as the direct path, answers must agree.

The SpMV is the one plain-jnp block-ELL product (ops.sparse.bell_spmv_ref,
tested against scipy in test_sparse_ops); chip_smoke.py runs the same
paths on the GPU."""

import numpy as np
import pytest
from scipy import sparse

import scs_tpu


def _sparse_lp(m, n, seed=0):
    rng = np.random.RandomState(seed)
    A = sparse.random(m, n, density=0.1, random_state=rng, format="csc")
    A = A + sparse.diags(np.ones(min(m, n)), shape=(m, n), format="csc")
    A.sort_indices()
    z = rng.randn(m)
    y = np.maximum(z, 0)
    s = y - z
    x = rng.randn(n)
    b = A @ x + s
    c = np.asarray(-(A.T @ y)).ravel()
    return {"A": A, "b": b, "c": c}, {"l": m}, float(c @ x)


@pytest.mark.parametrize("seed", [0, 1])
def test_bell_matches_direct_lp(seed):
    data, cone, pstar = _sparse_lp(60, 45, seed)
    kw = dict(eps_abs=1e-7, eps_rel=1e-7, verbose=False, max_iters=20000)
    sol_d = scs_tpu.solve(data, cone, solver_strategy="direct", **kw)
    sol_b = scs_tpu.solve(
        data, cone, solver_strategy="bell", bell_block_size=16, **kw
    )
    assert sol_d["info"]["status"] == "solved"
    assert sol_b["info"]["status"] == "solved"
    np.testing.assert_allclose(
        sol_b["info"]["pobj"], pstar, rtol=1e-4, atol=1e-5
    )
    # the LP optimum need not be unique — check the bell solution's KKT
    # conditions directly instead of comparing x across strategies
    A, b, c = data["A"], data["b"], data["c"]
    x, y, s = sol_b["x"], sol_b["y"], sol_b["s"]
    assert np.linalg.norm(A @ x + s - b) < 1e-4
    assert np.linalg.norm(A.T @ y + c) < 1e-4
    assert abs(s @ y) < 1e-4
    assert s.min() > -1e-6 and y.min() > -1e-6


def test_bell_qp_kkt():
    rng = np.random.RandomState(3)
    m, n = 50, 35
    A = sparse.random(m, n, density=0.15, random_state=rng, format="csc")
    A = A + sparse.diags(np.ones(min(m, n)), shape=(m, n), format="csc")
    A.sort_indices()
    x0 = rng.randn(n)
    b = np.asarray(A @ x0).ravel() + np.abs(rng.randn(m))
    c = rng.randn(n)
    G = rng.randn(n, 6)
    # full-rank P keeps the optimum O(1) so absolute KKT thresholds apply
    P = sparse.csc_matrix(np.triu(G @ G.T * 0.1 + 1.0 * np.eye(n)))
    sol = scs_tpu.solve(
        {"A": A, "b": b, "c": c, "P": P},
        {"l": m},
        solver_strategy="bell",
        bell_block_size=16,
        eps_abs=1e-7,
        eps_rel=1e-7,
        verbose=False,
        max_iters=20000,
    )
    assert sol["info"]["status"] == "solved"
    x, y, s = sol["x"], sol["y"], sol["s"]
    Pfull = np.asarray(P.todense())
    Pfull = Pfull + Pfull.T - np.diag(np.diag(Pfull))
    assert np.linalg.norm(A @ x + s - b) < 1e-4
    assert np.linalg.norm(Pfull @ x + A.T @ y + c) < 1e-4
    assert abs(s @ y) < 1e-4


def test_auto_strategy_uses_block_density():
    from scs_tpu.api import _resolve_strategy, LinearSolver

    rng = np.random.RandomState(0)
    m, n = 8448, 8448  # > 4096 so AUTO considers the matrix-free paths
    assert _resolve_strategy(LinearSolver.AUTO, 100, 100) == "direct"

    # block-diagonal structure: few nonzero 128x128 tiles -> bell
    blocks = [sparse.random(128, 128, 0.3, random_state=rng) for _ in range(66)]
    A_block = sparse.block_diag(blocks, format="csc")
    assert _resolve_strategy(LinearSolver.AUTO, m, n, A_block) == "bell"

    # same SCALAR density scattered uniformly: every tile is touched, the
    # pack would exceed dense storage -> indirect (the round-1 advisor
    # finding: density 0.0044 here, under the old 0.05 bell threshold)
    A_scatter = sparse.random(m, n, A_block.nnz / (m * n), random_state=rng,
                              format="csc")
    assert _resolve_strategy(LinearSolver.AUTO, m, n, A_scatter) == "indirect"

    # no sparse structure supplied -> indirect
    assert _resolve_strategy(LinearSolver.AUTO, 10000, 8192) == "indirect"


def test_bell_never_densifies_A(monkeypatch):
    """The bell path must not materialize dense A on host (round-1 advisor
    finding #2): a todense() call on the input matrix is a bug."""
    data, cone, _ = _sparse_lp(70, 50, seed=2)

    class NoDense(sparse.csc_matrix):
        def todense(self, *a, **k):  # pragma: no cover - failure path
            raise AssertionError("bell path densified A")

        def toarray(self, *a, **k):  # pragma: no cover - failure path
            raise AssertionError("bell path densified A")

    data["A"] = NoDense(data["A"])
    from scs_tpu import native

    monkeypatch.setattr(native, "available", False)
    sol = scs_tpu.solve(
        data, cone, solver_strategy="bell", bell_block_size=16,
        eps_abs=1e-6, eps_rel=1e-6, verbose=False,
    )
    assert sol["info"]["status"] == "solved"
