"""End-to-end solver tests: tiny closed-form problems across strategies.

Mirrors the reference's test_scs_basic.py LP, test_scs_quad.py QP, and a
selection of the closed-form problems from test_scs_coverage.py.
"""

import numpy as np
import pytest
import scipy.sparse as sp
from numpy.testing import assert_almost_equal

import scs_tpu as scs

STRATEGIES = ["direct", "indirect"]


def _solve(data, cone, **kw):
    kw.setdefault("verbose", False)
    return scs.solve(data, cone, **kw)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_tiny_lp(strategy):
    # max x s.t. x <= 1, -x <= 0  ->  x* = 1, p* = -1
    c = np.array([-1.0])
    b = np.array([1.0, 0.0])
    A = sp.csc_matrix([1.0, -1.0]).T.tocsc()
    data = {"A": A, "b": b, "c": c}
    sol = _solve(data, {"l": 2}, solver_strategy=strategy,
                 eps_abs=1e-6, eps_rel=1e-6)
    assert sol["info"]["status"] == "solved"
    assert_almost_equal(sol["x"][0], 1.0, decimal=4)
    assert_almost_equal(sol["info"]["pobj"], -1.0, decimal=4)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_tiny_qp(strategy):
    # min .5*1.2345*x^2 - x  s.t. x <= 1, -x <= 0  -> x* = 1/1.2345
    c = np.array([-1.0])
    b = np.array([1.0, -0.0])
    A = sp.csc_matrix([1.0, -1.0]).T.tocsc()
    P = sp.csc_matrix([[1.2345]]).tocsc()
    data = {"A": A, "P": P, "b": b, "c": c}
    sol = _solve(data, {"q": [], "l": 2}, solver_strategy=strategy,
                 eps_abs=1e-7, eps_rel=1e-7)
    assert sol["info"]["status"] == "solved"
    assert_almost_equal(sol["x"][0], 1.0 / 1.2345, decimal=5)


def test_readme_example():
    # reference README.md:71-91
    rng = np.random.RandomState(0)
    m, n = 4, 2
    A = sp.random(m, n, density=0.9, format="csc", random_state=rng)
    b = rng.randn(m)
    c = rng.randn(n)
    P = sp.eye(n, format="csc")
    sol = _solve({"P": P, "A": A, "b": b, "c": c}, {"l": m})
    assert sol["info"]["status"] in ("solved", "solved_inaccurate")
    assert "aa_stats" in sol["info"]


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_zero_cone(strategy):
    # equality constraints only: x = [1, 2]
    A = sp.csc_matrix(np.eye(2))
    b = np.array([1.0, 2.0])
    c = np.array([1.0, 1.0])
    sol = _solve({"A": A, "b": b, "c": c}, {"z": 2}, solver_strategy=strategy)
    assert sol["info"]["status"] == "solved"
    assert_almost_equal(sol["x"], [1.0, 2.0], decimal=4)


def test_soc_closed_form():
    # min -x1 - x2 s.t. ||(x1,x2)|| <= sqrt(2)/...  classic: x* on the cone
    # encode: s = (t; x) in SOC, t = 1 fixed via zero row
    # max x1 + x2 s.t. ||(x1, x2)||_2 <= 1  ->  x* = (1/sqrt2, 1/sqrt2)
    A = sp.csc_matrix(np.array([[0.0, 0.0], [-1.0, 0.0], [0.0, -1.0]]))
    b = np.array([1.0, 0.0, 0.0])
    c = np.array([-1.0, -1.0])
    sol = _solve({"A": A, "b": b, "c": c}, {"q": [3]}, eps_abs=1e-8, eps_rel=1e-8)
    assert sol["info"]["status"] == "solved"
    assert_almost_equal(sol["x"], [np.sqrt(0.5)] * 2, decimal=5)


def test_box_cone_basic():
    # max x s.t. 0 <= x <= 1 via box cone (test_scs_coverage.py:563-583)
    A = sp.csc_matrix(np.array([[0.0], [1.0]]))
    b = np.array([1.0, 0.5])
    c = np.array([-1.0])
    sol = _solve({"A": A, "b": b, "c": c}, {"bu": [0.5], "bl": [-0.5]})
    assert sol["info"]["status"] in ("solved", "solved_inaccurate")
    assert_almost_equal(sol["x"][0], 1.0, decimal=2)


def test_exp_cone_closed_form():
    # min t s.t. (1, 1, t) in Kexp -> t* = e (test_scs_coverage.py:910-948)
    A = sp.csc_matrix(np.array([
        [0.0, 1.0, 0.0],
        [0.0, 0.0, 1.0],
        [0.0, -1.0, 0.0],
        [0.0, 0.0, -1.0],
        [-1.0, 0.0, 0.0],
    ]))
    b = np.array([1.0, 1.0, 0.0, 0.0, 0.0])
    c = np.array([1.0, 0.0, 0.0])
    sol = _solve({"A": A, "b": b, "c": c}, {"z": 2, "ep": 1},
                 eps_abs=1e-7, eps_rel=1e-7)
    assert sol["info"]["status"] in ("solved", "solved_inaccurate")
    assert_almost_equal(sol["x"][0], np.e, decimal=4)


def test_infeasible_lp():
    # x <= -1, x >= 1 infeasible
    A = sp.csc_matrix(np.array([[1.0], [-1.0]]))
    b = np.array([-1.0, -1.0])
    c = np.array([1.0])
    sol = _solve({"A": A, "b": b, "c": c}, {"l": 2})
    assert sol["info"]["status"] == "infeasible"
    y = sol["y"]
    assert b @ y < -0.1
    assert np.linalg.norm(A.T @ y) < 1e-3
    assert np.all(np.isnan(sol["x"]))


def test_unbounded_lp():
    # min -x s.t. -x <= 0 (x >= 0 unbounded above)
    A = sp.csc_matrix(np.array([[-1.0]]))
    b = np.array([0.0])
    c = np.array([-1.0])
    sol = _solve({"A": A, "b": b, "c": c}, {"l": 1})
    assert sol["info"]["status"] == "unbounded"
    x = sol["x"]
    assert c @ x < -0.1


def test_warm_start_reduces_iters():
    rng = np.random.RandomState(7)
    m, n = 60, 30
    A = sp.csc_matrix(rng.randn(m, n))
    x0 = rng.randn(n)
    s0 = np.abs(rng.randn(m))
    b = A @ x0 + s0
    c = rng.randn(n)
    # bounded feasible LP
    data = {"A": A, "b": b, "c": c}
    # add box of sorts: ensure bounded by adding -c'x <= M? keep simple:
    # use P = I to guarantee bounded QP
    data["P"] = sp.eye(n, format="csc")
    solver = scs.SCS(data, {"l": m}, verbose=False, eps_abs=1e-6, eps_rel=1e-6)
    sol1 = solver.solve()
    assert sol1["info"]["status"] == "solved"
    it1 = sol1["info"]["iter"]
    sol2 = solver.solve(warm_start=True)
    it2 = sol2["info"]["iter"]
    assert sol2["info"]["status"] == "solved"
    assert it2 <= it1
    # explicit warm-start overrides
    sol3 = solver.solve(warm_start=True, x=sol1["x"], y=sol1["y"], s=sol1["s"])
    assert sol3["info"]["status"] == "solved"
    assert sol3["info"]["iter"] <= it1


def test_update_b_c():
    rng = np.random.RandomState(9)
    m, n = 40, 20
    A = sp.csc_matrix(rng.randn(m, n))
    x0 = rng.randn(n)
    b = A @ x0 + np.abs(rng.randn(m))
    c = rng.randn(n)
    data = {"A": A, "b": b, "c": c, "P": sp.eye(n, format="csc")}
    solver = scs.SCS(data, {"l": m}, verbose=False, eps_abs=1e-6, eps_rel=1e-6)
    sol1 = solver.solve()
    assert sol1["info"]["status"] == "solved"
    # perturb b: re-solve without refactorize
    b2 = b + 0.1 * np.abs(rng.randn(m))
    solver.update(b=b2)
    sol2 = solver.solve()
    assert sol2["info"]["status"] == "solved"
    # verify against fresh solve
    fresh = scs.SCS({"A": A, "b": b2, "c": c, "P": sp.eye(n, format="csc")},
                    {"l": m}, verbose=False, eps_abs=1e-6, eps_rel=1e-6).solve()
    assert_almost_equal(sol2["info"]["pobj"], fresh["info"]["pobj"], decimal=4)


def test_info_schema():
    from scs_tpu.info import INFO_KEYS, AA_STATS_KEYS

    A = sp.csc_matrix(np.array([[1.0], [-1.0]]))
    sol = _solve({"A": A, "b": np.array([1.0, 0.0]), "c": np.array([-1.0])},
                 {"l": 2})
    info = sol["info"]
    for k in INFO_KEYS:
        assert k in info, f"missing info key {k}"
    for k in AA_STATS_KEYS:
        assert k in info["aa_stats"], f"missing aa_stats key {k}"
    assert info["setup_time"] >= 0
    assert info["solve_time"] >= 0


def test_validation_errors():
    A = sp.csc_matrix(np.array([[1.0], [-1.0]]))
    b = np.array([1.0, 0.0])
    c = np.array([-1.0])
    with pytest.raises(ValueError):
        scs.SCS({}, {"l": 2})
    with pytest.raises(ValueError):
        scs.SCS({"A": A, "b": b}, {"l": 2})
    with pytest.raises(ValueError):
        scs.SCS({"A": A, "b": b, "c": c}, {"l": 3})  # cone dim mismatch
    with pytest.raises(ValueError):
        scs.SCS({"A": A, "b": b, "c": c}, {"l": 2}, alpha=2.5)
    with pytest.raises(ValueError):
        scs.SCS({"A": A, "b": b, "c": c}, {"l": 2}, eps_abs=float("nan"))
    with pytest.raises(TypeError):
        scs.SCS({"A": A, "b": b, "c": c}, {"l": 2}, bogus_setting=1)


def test_dense_A_rejected_by_default():
    # reference parity: a dense ndarray A raises TypeError unless the
    # package extension allow_dense_input=True is requested
    # (reference scs/py/__init__.py:117-118)
    Ad = np.array([[1.0], [-1.0]])
    b = np.array([1.0, 0.0])
    c = np.array([-1.0])
    with pytest.raises(TypeError):
        scs.SCS({"A": Ad, "b": b, "c": c}, {"l": 2})
    sol = scs.SCS(
        {"A": Ad, "b": b, "c": c}, {"l": 2},
        allow_dense_input=True, verbose=False,
    ).solve()
    assert sol["info"]["status"] == "solved"


def test_power_cone_param_validation():
    # degenerate power parameters p in {0, +-1} (and |p|>1, non-finite)
    # are rejected up front — the Newton projector is undefined there
    A = sp.csc_matrix(np.eye(3))
    b = np.zeros(3)
    c = np.ones(3)
    for bad in (0.0, 1.0, -1.0, 1.5, -2.0, float("nan"), float("inf")):
        with pytest.raises(ValueError):
            scs.SCS({"A": A, "b": b, "c": c}, {"p": [bad]}, verbose=False)


def test_aa_off_stats():
    # AA disabled: all-zero counters + NaN last_aa_norm
    # (reference: test_scs_coverage.py:1320-1330)
    A = sp.csc_matrix(np.array([[1.0], [-1.0]]))
    sol = _solve({"A": A, "b": np.array([1.0, 0.0]), "c": np.array([-1.0])},
                 {"l": 2}, acceleration_lookback=0)
    stats = sol["info"]["aa_stats"]
    assert stats["n_accept"] == 0
    assert np.isnan(stats["last_aa_norm"])


def test_determinism():
    # two fresh instances produce bit-identical output
    # (reference: test_scs_coverage.py:2283-2301)
    rng = np.random.RandomState(11)
    m, n = 30, 15
    A = sp.csc_matrix(rng.randn(m, n))
    b = A @ rng.randn(n) + np.abs(rng.randn(m))
    c = rng.randn(n)
    data = {"A": A, "b": b, "c": c, "P": sp.eye(n, format="csc")}
    s1 = scs.SCS(data, {"l": m}, verbose=False).solve()
    s2 = scs.SCS(data, {"l": m}, verbose=False).solve()
    np.testing.assert_array_equal(s1["x"], s2["x"])
    np.testing.assert_array_equal(s1["y"], s2["y"])
    np.testing.assert_array_equal(s1["s"], s2["s"])
