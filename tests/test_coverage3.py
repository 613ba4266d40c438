"""Coverage tranche 3: closed-form box/SOC/zero-cone problems, failure
status codes, duality/residual invariants, and edge-case matrices from
the reference's test_scs_coverage.py sections (box :563-632, SOC :1055,
zero :805, status codes :862-904, strong duality :1293, zero-A :2980) —
written against this package's API, cited per test."""

import numpy as np
import pytest
from numpy.testing import assert_almost_equal
from scipy import sparse as sp

import scs_tpu as scs

_KW = dict(verbose=False, max_iters=20000)


# ---------------------------------------------------------------------------
# box cone closed forms (reference :563-632; homogeneous (t, s) block)
# ---------------------------------------------------------------------------


def test_box_cone_basic_max():
    """max x s.t. 0 <= x <= 1 via box cone: x* = 1."""
    A = sp.csc_matrix(np.array([[0.0], [1.0]]))
    b = np.array([1.0, 0.5])
    c = np.array([-1.0])
    sol = scs.solve({"A": A, "b": b, "c": c},
                    {"bu": [0.5], "bl": [-0.5]}, **_KW)
    assert sol["info"]["status"] in ("solved", "solved_inaccurate")
    assert_almost_equal(sol["x"][0], 1.0, decimal=2)


def test_box_cone_minimise():
    """min x s.t. 0.3 <= x <= 1: x* = 0.3."""
    A = sp.csc_matrix(np.array([[0.0], [1.0]]))
    b = np.array([1.0, 0.65])
    c = np.array([1.0])
    sol = scs.solve({"A": A, "b": b, "c": c},
                    {"bu": [0.35], "bl": [-0.35]}, **_KW)
    assert sol["info"]["status"] in ("solved", "solved_inaccurate")
    assert_almost_equal(sol["x"][0], 0.3, decimal=2)


def test_box_cone_two_variables():
    """max x1+x2, 0 <= x1 <= 1, -1 <= x2 <= 1: both at upper bounds."""
    A = sp.csc_matrix(
        np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    )
    b = np.array([1.0, 0.5, 0.0])
    c = np.array([-1.0, -1.0])
    sol = scs.solve({"A": A, "b": b, "c": c},
                    {"bu": [0.5, 1.0], "bl": [-0.5, -1.0]}, **_KW)
    assert sol["info"]["status"] in ("solved", "solved_inaccurate")
    assert_almost_equal(sol["x"][0], 1.0, decimal=2)
    assert_almost_equal(sol["x"][1], 1.0, decimal=2)


def test_box_cone_infinite_bounds():
    """+inf upper bounds degrade the box to one-sided constraints."""
    # slack row: s = x (A=-1, b=0) with 0 <= s <= inf  ->  x >= 0
    A = sp.csc_matrix(np.array([[0.0], [-1.0]]))
    b = np.array([1.0, 0.0])
    c = np.array([1.0])  # min x s.t. x >= 0 -> x* = 0
    sol = scs.solve({"A": A, "b": b, "c": c},
                    {"bu": [np.inf], "bl": [0.0]}, **_KW)
    assert sol["info"]["status"] in ("solved", "solved_inaccurate")
    assert abs(sol["x"][0]) < 1e-2


# ---------------------------------------------------------------------------
# SOC / zero-cone closed forms (reference :1055-1084, :805-820)
# ---------------------------------------------------------------------------


def test_soc_known_solution():
    """max x1 s.t. (1, x1, 0.5) in SOC(3): x1* = sqrt(3)/2."""
    A = sp.csc_matrix(
        np.array([[0.0, 1.0], [0.0, -1.0], [-1.0, 0.0], [0.0, 0.0]])
    )
    b = np.array([1.0, 0.0, 0.0, 0.5])
    c = np.array([-1.0, 0.0])
    sol = scs.solve({"A": A, "b": b, "c": c}, {"l": 1, "q": [3]}, **_KW)
    assert sol["info"]["status"] in ("solved", "solved_inaccurate")
    assert_almost_equal(sol["x"][0], np.sqrt(3) / 2, decimal=3)


def test_zero_cone_single_equality():
    """min -x s.t. x = 0.7 (zero cone): x* = 0.7."""
    sol = scs.solve(
        {"A": sp.csc_matrix(np.array([[1.0]])), "b": np.array([0.7]),
         "c": np.array([-1.0])},
        {"z": 1}, **_KW,
    )
    assert sol["info"]["status"] in ("solved", "solved_inaccurate")
    assert_almost_equal(sol["x"][0], 0.7, decimal=2)


# ---------------------------------------------------------------------------
# failure status codes (reference :862-904)
# ---------------------------------------------------------------------------


def test_infeasible_status_code():
    """x >= 1 AND x <= 0: infeasible, with a Farkas certificate in y."""
    A = sp.csc_matrix(np.array([[-1.0], [1.0]]))
    sol = scs.solve(
        {"A": A, "b": np.array([-1.0, 0.0]), "c": np.array([1.0])},
        {"l": 2}, verbose=False, eps_infeas=1e-7, max_iters=10000,
    )
    assert sol["info"]["status"] == "infeasible"
    assert sol["info"]["status_val"] == scs.INFEASIBLE
    # certificate: y normalized to b'y = -1, A'y ~ 0, x/s = NaN
    assert np.all(np.isnan(sol["x"]))
    y = sol["y"]
    assert abs(np.array([-1.0, 0.0]) @ y + 1) < 1e-3
    assert abs(float((A.T @ y)[0])) < 1e-3


def test_unbounded_status_code():
    """max x s.t. x >= 0: unbounded, with a primal ray in x."""
    sol = scs.solve(
        {"A": sp.csc_matrix(np.array([[-1.0]])), "b": np.array([0.0]),
         "c": np.array([-1.0])},
        {"l": 1}, verbose=False, max_iters=10000,
    )
    assert sol["info"]["status"] == "unbounded"
    assert sol["info"]["status_val"] == scs.UNBOUNDED
    # certificate: c'x = -1 along the ray, y = NaN
    assert abs(-1.0 * sol["x"][0] + 1) < 1e-2
    assert np.all(np.isnan(sol["y"]))


# ---------------------------------------------------------------------------
# invariants on solved problems (reference :1293-1310)
# ---------------------------------------------------------------------------


def _lp(seed=0, m=8, n=5):
    rng = np.random.RandomState(seed)
    A = rng.randn(m, n) / np.sqrt(m)
    x0 = rng.randn(n)
    b = A @ x0 + np.abs(rng.randn(m))
    c = -(A.T @ np.abs(rng.randn(m)))
    return {"A": sp.csc_matrix(A), "b": b, "c": c}, {"l": m}


def test_strong_duality_lp():
    data, cone = _lp(seed=1)
    sol = scs.solve(data, cone, eps_abs=1e-8, eps_rel=1e-8,
                    verbose=False, max_iters=50000)
    assert sol["info"]["status"] in ("solved", "solved_inaccurate")
    assert abs(sol["info"]["pobj"] - sol["info"]["dobj"]) < 1e-4


def test_residuals_small_for_solved():
    data, cone = _lp(seed=2)
    sol = scs.solve(data, cone, eps_abs=1e-7, eps_rel=1e-7,
                    verbose=False, max_iters=50000)
    assert sol["info"]["status"] in ("solved", "solved_inaccurate")
    assert sol["info"]["res_pri"] < 1e-4
    assert sol["info"]["res_dual"] < 1e-4


def test_accel_steps_nonnegative():
    data, cone = _lp(seed=3)
    sol = scs.solve(data, cone, acceleration_lookback=5, **_KW)
    assert sol["info"]["accepted_accel_steps"] >= 0
    assert sol["info"]["rejected_accel_steps"] >= 0


def test_comp_slack_small_for_solved_lp():
    data, cone = _lp(seed=4)
    sol = scs.solve(data, cone, **_KW)
    assert sol["info"]["status"] == "solved"
    assert abs(sol["info"]["comp_slack"]) < 1e-3


def test_info_scale_sanity():
    data, cone = _lp(seed=5)
    sol = scs.solve(data, cone, **_KW)
    assert 1e-6 <= sol["info"]["scale"] <= 1e6
    assert sol["info"]["scale_updates"] >= 0


# ---------------------------------------------------------------------------
# edge-case matrices (reference :2980-2991, :1935)
# ---------------------------------------------------------------------------


def test_zero_A_matrix():
    """All-zero A: x free, c != 0 -> unbounded (or solved if c'x bounded)."""
    A = sp.csc_matrix((2, 1))
    sol = scs.solve(
        {"A": A, "b": np.array([1.0, 1.0]), "c": np.array([1.0])},
        {"l": 2}, **_KW,
    )
    assert sol["info"]["status_val"] in (
        scs.UNBOUNDED, scs.UNBOUNDED_INACCURATE, scs.SOLVED,
        scs.SOLVED_INACCURATE,
    )


def test_single_row_single_col():
    """1x1 problem end to end: max x s.t. x <= 1 -> x* = 1."""
    sol = scs.solve(
        {"A": sp.csc_matrix(np.array([[1.0]])), "b": np.array([1.0]),
         "c": np.array([-1.0])},
        {"l": 1}, **_KW,
    )
    assert sol["info"]["status"] in ("solved", "solved_inaccurate")
    assert_almost_equal(sol["x"][0], 1.0, decimal=2)


def test_large_random_lp():
    """A larger random LP solves at default settings (reference :1935)."""
    data, cone = _lp(seed=6, m=120, n=80)
    sol = scs.solve(data, cone, **_KW)
    assert sol["info"]["status"] == "solved"


def test_two_independent_instances():
    """Two live instances do not interfere (reference :2996-3010)."""
    d1, c1 = _lp(seed=7)
    d2, c2 = _lp(seed=8)
    s1 = scs.SCS(d1, c1, **_KW)
    s2 = scs.SCS(d2, c2, **_KW)
    r1 = s1.solve()
    r2 = s2.solve()
    r1b = s1.solve(warm_start=False)
    assert r1["info"]["status"] == "solved"
    assert r2["info"]["status"] == "solved"
    assert_almost_equal(r1["info"]["pobj"], r1b["info"]["pobj"], decimal=6)
    assert abs(r1["info"]["pobj"] - r2["info"]["pobj"]) > 1e-12


def test_time_limit_reports_partial():
    """time_limit_secs terminates early with an inaccurate status."""
    rng = np.random.RandomState(9)
    m, n = 60, 40
    A = rng.randn(m, n)
    data = {"A": sp.csc_matrix(A), "b": rng.randn(m),
            "c": -(A.T @ np.abs(rng.randn(m)))}
    sol = scs.solve(
        data, {"l": m}, verbose=False, max_iters=10**6,
        eps_abs=1e-12, eps_rel=1e-12, time_limit_secs=0.5,
    )
    assert sol["info"]["status"] in (
        "solved_inaccurate", "infeasible_inaccurate",
        "unbounded_inaccurate", "indeterminate", "solved", "unbounded",
        "infeasible",
    )


# ---------------------------------------------------------------------------
# input canonicalization details (reference: P unsorted/CSR variants,
# float32 inputs :various, warm-start arg validation)
# ---------------------------------------------------------------------------


def test_csr_P_warns_and_solves():
    data, cone = _lp(seed=10)
    rng = np.random.RandomState(10)
    G = rng.randn(5, 2)
    P = np.triu(G @ G.T * 0.1 + 1e-3 * np.eye(5))
    data["P"] = sp.csr_matrix(P)
    with pytest.warns(UserWarning, match="CSC"):
        sol = scs.solve(data, cone, **_KW)
    assert sol["info"]["status"] == "solved"


def test_P_unsorted_indices_sorted_and_solved():
    data, cone = _lp(seed=11)
    rng = np.random.RandomState(11)
    G = rng.randn(5, 3)
    P = sp.csc_matrix(np.triu(G @ G.T * 0.1 + 1e-3 * np.eye(5)))
    # force unsorted indices in some column with >= 2 entries
    col = int(np.argmax(np.diff(P.indptr) >= 2))
    s0, s1 = P.indptr[col], P.indptr[col] + 2
    P.indices[s0:s1] = P.indices[s0:s1][::-1]
    P.data[s0:s1] = P.data[s0:s1][::-1]
    P.has_sorted_indices = False
    data["P"] = P
    sol = scs.solve(data, cone, **_KW)
    assert sol["info"]["status"] == "solved"


def test_float32_inputs_accepted():
    data, cone = _lp(seed=12)
    data["A"] = sp.csc_matrix(data["A"], dtype=np.float32)
    data["b"] = data["b"].astype(np.float32)
    data["c"] = data["c"].astype(np.float32)
    sol = scs.solve(data, cone, **_KW)
    assert sol["info"]["status"] == "solved"


def test_warm_start_wrong_dims_raise():
    data, cone = _lp(seed=13)
    solver = scs.SCS(data, cone, **_KW)
    for kw in ({"x": np.zeros(99)}, {"y": np.zeros(99)},
               {"s": np.zeros(99)}):
        with pytest.raises((ValueError, TypeError)):
            solver.solve(warm_start=True, **kw)


def test_write_data_and_log_csv_simultaneously(tmp_path):
    """Both observability outputs in one solve (reference :1728-1751)."""
    data, cone = _lp(seed=14)
    fdata = str(tmp_path / "prob.npz")
    fcsv = str(tmp_path / "log.csv")
    sol = scs.solve(data, cone, write_data_filename=fdata,
                    log_csv_filename=fcsv, **_KW)
    assert sol["info"]["status"] == "solved"
    import os
    assert os.path.exists(fdata) and os.path.getsize(fdata) > 0
    lines = open(fcsv).read().strip().splitlines()
    assert len(lines) >= 2  # header + at least one row
    from scs_tpu.io import CSV_COLUMNS
    assert lines[0].rstrip(",").split(",") == CSV_COLUMNS
