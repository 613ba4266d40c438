"""Coverage tranche 2 (VERDICT r3 item 6): the next slice of the
reference's test_scs_coverage.py surface, adapted to this package's API.

Sections covered here (reference file = /root/reference/test/
test_scs_coverage.py): input validation & canonicalization, cone-field
int/list/array parity (:2493-2568), warm-start semantics, update(b, c)
argument validation, info/solution schema (:2909-2917 copy semantics,
info key checks), AUTO-dispatch behavior (:3237-3321 — the module-import
mocks become _resolve_strategy unit tests, since the seven native
backends collapse onto the direct/indirect/bell strategies), legacy
solve(), cone mixtures (:1561-1609), and misc solve behaviors.

Tests reuse a handful of problem shapes so compiled cores are shared
(each distinct (shape, settings) pair is its own XLA program).
"""

import warnings

import numpy as np
import pytest
from numpy.testing import assert_almost_equal
from scipy import sparse as sp

import scs_tpu as scs


# ---------------------------------------------------------------------------
# shared fixtures (one shape -> one compiled core for most tests)
# ---------------------------------------------------------------------------

_M, _N = 6, 4


def _lp_data(seed=0):
    rng = np.random.RandomState(seed)
    A = rng.randn(_M, _N) / np.sqrt(_M)
    x0 = rng.randn(_N)
    s = np.abs(rng.randn(_M))
    b = A @ x0 + s
    y = np.abs(rng.randn(_M))
    c = -(A.T @ y)
    return {"A": sp.csc_matrix(A), "b": b, "c": c}


_CONE = {"l": _M}
_KW = dict(verbose=False, max_iters=5000)


def _solve(data=None, cone=None, **kw):
    kw = {**_KW, **kw}
    return scs.solve(data or _lp_data(), cone or _CONE, **kw)


# ---------------------------------------------------------------------------
# input validation & canonicalization
# ---------------------------------------------------------------------------


def test_A_shape_mismatch_raises():
    d = _lp_data()
    d["b"] = np.zeros(_M + 1)
    with pytest.raises(ValueError):
        scs.SCS(d, {"l": _M + 1}, **_KW)


def test_P_shape_mismatch_raises():
    d = _lp_data()
    d["P"] = sp.csc_matrix(np.eye(_N + 1))
    with pytest.raises(ValueError):
        scs.SCS(d, _CONE, **_KW)


def test_empty_data_raises():
    with pytest.raises(ValueError):
        scs.SCS({}, _CONE, **_KW)


def test_empty_cone_raises():
    with pytest.raises(ValueError):
        scs.SCS(_lp_data(), {}, **_KW)


def test_missing_b_raises():
    d = _lp_data()
    del d["b"]
    with pytest.raises(ValueError):
        scs.SCS(d, _CONE, **_KW)


def test_dense_A_raises():
    """Reference parity: dense ndarray A raises TypeError
    (scs/py/__init__.py:117-118)."""
    d = _lp_data()
    d["A"] = np.asarray(d["A"].todense())
    with pytest.raises(TypeError):
        scs.SCS(d, _CONE, **_KW)


def test_dense_P_raises():
    d = _lp_data()
    d["P"] = np.eye(_N)
    with pytest.raises(TypeError):
        scs.SCS(d, _CONE, **_KW)


def test_coo_A_warns_and_solves():
    d = _lp_data()
    d["A"] = d["A"].tocoo()
    with pytest.warns(UserWarning, match="CSC"):
        sol = _solve(d)
    assert sol["info"]["status"] == "solved"


def test_csr_A_warns_and_solves():
    d = _lp_data()
    d["A"] = d["A"].tocsr()
    with pytest.warns(UserWarning, match="CSC"):
        sol = _solve(d)
    assert sol["info"]["status"] == "solved"


def test_unsorted_A_indices_are_not_mutated():
    """Canonicalization must not mutate the caller's matrix
    (reference sorted_indices() non-mutating idiom,
    scs/py/__init__.py:137-142)."""
    d = _lp_data()
    A = d["A"].copy()
    # force unsorted indices within a column
    A.indices[:2] = A.indices[:2][::-1]
    A.data[:2] = A.data[:2][::-1]
    A.has_sorted_indices = False
    ind_before = A.indices.copy()
    d["A"] = A
    sol = _solve(d)
    assert sol["info"]["status"] == "solved"
    assert np.array_equal(A.indices, ind_before)


def test_P_lower_triangular_stripped():
    """A full symmetric P gives the same solve as its upper triangle
    (reference _has_lower_tri + sparse.triu, scs/py/__init__.py:146-166)."""
    rng = np.random.RandomState(3)
    G = rng.randn(_N, 2)
    P_full = G @ G.T * 0.1 + 1e-3 * np.eye(_N)
    d1 = _lp_data()
    d1["P"] = sp.csc_matrix(P_full)  # full symmetric: lower tri stripped
    d2 = _lp_data()
    d2["P"] = sp.csc_matrix(np.triu(P_full))
    s1 = _solve(d1)
    s2 = _solve(d2)
    assert s1["info"]["status"] == "solved"
    assert_almost_equal(s1["info"]["pobj"], s2["info"]["pobj"], decimal=6)


def test_sparse_b_and_c_solve():
    d = _lp_data()
    d["b"] = sp.csc_matrix(d["b"].reshape(-1, 1))
    d["c"] = sp.csc_matrix(d["c"].reshape(-1, 1))
    sol = _solve(d)
    assert sol["info"]["status"] == "solved"


def test_cone_dim_mismatch_raises():
    with pytest.raises(ValueError):
        scs.SCS(_lp_data(), {"l": _M - 1}, **_KW)


# ---------------------------------------------------------------------------
# cone-field int / list / numpy-array parity (reference :2493-2568)
# ---------------------------------------------------------------------------


def _soc_data():
    A = sp.csc_matrix(np.eye(3))
    b = np.array([0.0, 1.0, 1.0])
    c = np.array([-1.0, 0.0, 0.0])
    return {"A": A, "b": b, "c": c}


def test_cone_q_as_numpy_array():
    sol = scs.solve(_soc_data(), {"q": np.array([3], dtype=np.int64)}, **_KW)
    assert sol["info"]["status"] in ("solved", "solved_inaccurate")


def test_cone_q_as_single_int():
    sol = scs.solve(_soc_data(), {"q": 3}, **_KW)
    assert sol["info"]["status"] in ("solved", "solved_inaccurate")


def test_cone_s_as_numpy_array():
    A = sp.csc_matrix(np.eye(3))
    b = np.array([1.0, 0.0, 1.0])
    c = np.array([-1.0, 0.0, -1.0])
    sol = scs.solve(
        {"A": A, "b": b, "c": c}, {"s": np.array([2], dtype=np.int64)}, **_KW
    )
    assert sol["info"]["status"] in ("solved", "solved_inaccurate")


@pytest.mark.parametrize(
    "bad_q",
    [[-1], -1, np.array([-1], dtype=np.int64), np.array([2, -3])],
    ids=["list", "scalar", "np_single_neg", "np_mixed_neg"],
)
def test_cone_q_negative_rejected(bad_q):
    with pytest.raises(ValueError):
        scs.SCS(_soc_data(), {"q": bad_q}, **_KW)


@pytest.mark.parametrize(
    "bad_s", [[-1], -1, np.array([-1])], ids=["list", "scalar", "np"]
)
def test_cone_s_negative_rejected(bad_s):
    with pytest.raises(ValueError):
        scs.SCS(_soc_data(), {"s": bad_s}, **_KW)


def test_cone_q_non_integral_rejected():
    with pytest.raises((TypeError, ValueError)):
        scs.SCS(_soc_data(), {"q": [2.5]}, **_KW)


def test_empty_q_s_p_fields():
    """Empty lists for array cone fields are accepted as absent."""
    sol = _solve(cone={"l": _M, "q": [], "s": [], "p": []})
    assert sol["info"]["status"] == "solved"


def test_deprecated_f_cone_field():
    """'f' folds into 'z' with a DeprecationWarning
    (reference scsobject.h:692-704)."""
    d = _lp_data()
    # all-equality version: z rows = m with slack 0 is infeasible for our
    # data; instead split l rows: f + z + l must total m
    with pytest.warns(DeprecationWarning, match="deprecated"):
        spec = scs.ConeSpec.from_dict({"f": 2, "z": 1, "l": 3})
    assert spec.z == 3
    assert spec.l == 3


def test_f_cone_deprecation_can_be_promoted_to_error():
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        with pytest.raises(DeprecationWarning):
            scs.ConeSpec.from_dict({"f": 1, "l": 2})


def test_box_cone_bu_bl_mismatch_raises():
    with pytest.raises(ValueError):
        scs.ConeSpec.from_dict({"bu": [1.0, 2.0], "bl": [0.0]})


def test_box_cone_numpy_bounds():
    """Box cone with numpy bounds arrays solves (reference
    test_box_cone_numpy_bounds)."""
    # min -x s.t. x <= 1 (box), x free otherwise: box block (t; s) with
    # t fixed by the homogeneous row. Use the simple pattern: rows =
    # bsize = len(bu)+1; A maps x into the box slot.
    A = sp.csc_matrix(np.array([[1.0], [-1.0]]))  # rows: t-row, x-row
    b = np.array([1.0, 0.0])
    c = np.array([-1.0])
    cone = {"bu": np.array([1.0]), "bl": np.array([-1.0])}
    sol = scs.solve({"A": A, "b": b, "c": c}, cone, **_KW)
    assert sol["info"]["status"] in ("solved", "solved_inaccurate")
    assert sol["x"][0] <= 1.0 + 1e-3


# ---------------------------------------------------------------------------
# warm-start semantics
# ---------------------------------------------------------------------------


def test_warm_start_reduces_iterations():
    solver = scs.SCS(_lp_data(), _CONE, **_KW)
    cold = solver.solve(warm_start=False)
    warm = solver.solve(warm_start=True)
    assert warm["info"]["status"] == "solved"
    assert warm["info"]["iter"] <= cold["info"]["iter"]


def test_warm_start_false_gives_correct_solution():
    solver = scs.SCS(_lp_data(), _CONE, **_KW)
    s1 = solver.solve(warm_start=False)
    s2 = solver.solve(warm_start=False)
    assert_almost_equal(s1["info"]["pobj"], s2["info"]["pobj"], decimal=7)


def test_warm_start_xys_override_on_first_solve():
    d = _lp_data()
    ref = _solve(d)
    solver = scs.SCS(d, _CONE, **_KW)
    sol = solver.solve(warm_start=True, x=ref["x"], y=ref["y"], s=ref["s"])
    assert sol["info"]["status"] == "solved"
    assert sol["info"]["iter"] <= ref["info"]["iter"]


def test_warm_start_partial_override_y_only():
    d = _lp_data()
    ref = _solve(d)
    solver = scs.SCS(d, _CONE, **_KW)
    sol = solver.solve(warm_start=True, y=ref["y"])
    assert sol["info"]["status"] == "solved"


def test_warm_start_partial_override_s_only():
    d = _lp_data()
    ref = _solve(d)
    solver = scs.SCS(d, _CONE, **_KW)
    sol = solver.solve(warm_start=True, s=ref["s"])
    assert sol["info"]["status"] == "solved"


def test_cold_start_after_warm():
    solver = scs.SCS(_lp_data(), _CONE, **_KW)
    solver.solve()
    cold = solver.solve(warm_start=False)
    assert cold["info"]["status"] == "solved"


# ---------------------------------------------------------------------------
# update(b, c) argument validation
# ---------------------------------------------------------------------------


def test_update_b_wrong_size_raises():
    solver = scs.SCS(_lp_data(), _CONE, **_KW)
    with pytest.raises(ValueError):
        solver.update(b=np.zeros(_M + 2))


def test_update_c_wrong_size_raises():
    solver = scs.SCS(_lp_data(), _CONE, **_KW)
    with pytest.raises(ValueError):
        solver.update(c=np.zeros(_N + 2))


def test_update_none_is_noop():
    solver = scs.SCS(_lp_data(), _CONE, **_KW)
    s1 = solver.solve()
    solver.update()
    s2 = solver.solve(warm_start=False)
    assert_almost_equal(s1["info"]["pobj"], s2["info"]["pobj"], decimal=6)


def test_update_b_only_changes_solution():
    d = _lp_data()
    solver = scs.SCS(d, _CONE, **_KW)
    s1 = solver.solve()
    solver.update(b=d["b"] * 1.5)
    s2 = solver.solve(warm_start=False)
    assert s2["info"]["status"] == "solved"
    assert abs(s1["info"]["pobj"] - s2["info"]["pobj"]) > 1e-9


def test_update_c_only_changes_solution():
    d = _lp_data()
    solver = scs.SCS(d, _CONE, **_KW)
    s1 = solver.solve()
    solver.update(c=d["c"] * 2.0)
    s2 = solver.solve(warm_start=False)
    assert s2["info"]["status"] == "solved"
    assert_almost_equal(s2["info"]["pobj"], 2 * s1["info"]["pobj"], decimal=3)


def test_update_both_b_and_c():
    d = _lp_data()
    solver = scs.SCS(d, _CONE, **_KW)
    solver.update(b=d["b"] * 1.1, c=d["c"] * 0.9)
    sol = solver.solve()
    assert sol["info"]["status"] == "solved"


# ---------------------------------------------------------------------------
# info / solution schema (reference :2909-2917 and info-key sections)
# ---------------------------------------------------------------------------


def test_all_info_keys_present():
    info = _solve()["info"]
    for k in scs.Settings and __import__(
        "scs_tpu.info", fromlist=["INFO_KEYS"]
    ).INFO_KEYS:
        assert k in info, k
    assert "aa_stats" in info


def test_info_types():
    info = _solve()["info"]
    assert isinstance(info["iter"], int)
    assert isinstance(info["pobj"], float)
    assert isinstance(info["status"], str)
    assert isinstance(info["status_val"], int)


def test_info_status_val_matches_constant():
    info = _solve()["info"]
    assert info["status_val"] == scs.SOLVED
    assert info["status"] == "solved"


def test_solution_shapes_match_problem_dimensions():
    sol = _solve()
    assert sol["x"].shape == (_N,)
    assert sol["y"].shape == (_M,)
    assert sol["s"].shape == (_M,)


def test_solution_keys():
    sol = _solve()
    assert set(sol.keys()) == {"x", "y", "s", "info"}


def test_timing_info_nonnegative():
    info = _solve()["info"]
    for k in ("solve_time", "setup_time", "lin_sys_time", "cone_time",
              "accel_time"):
        assert info[k] >= 0.0


def test_complementary_slackness_lp():
    sol = _solve()
    assert abs(float(sol["s"] @ sol["y"])) < 1e-3


def test_duality_gap_small_for_solved():
    info = _solve()["info"]
    assert abs(info["pobj"] - info["dobj"]) < 1e-3 * (1 + abs(info["pobj"]))


def test_aa_stats_dict_has_expected_keys():
    from scs_tpu.info import AA_STATS_KEYS

    stats = _solve()["info"]["aa_stats"]
    for k in AA_STATS_KEYS:
        assert k in stats, k


def test_aa_stats_no_acceleration():
    """AA off: all-zero stats + NaN last_aa_norm (reference
    test_scs_coverage.py:1320-1330)."""
    sol = _solve(acceleration_lookback=0)
    stats = sol["info"]["aa_stats"]
    assert stats["n_accept"] == 0
    assert stats["iter"] == 0
    assert np.isnan(stats["last_aa_norm"])


def test_two_instances_same_problem_identical_result():
    d = _lp_data()
    s1 = scs.SCS(d, _CONE, **_KW).solve()
    s2 = scs.SCS(d, _CONE, **_KW).solve()
    assert s1["info"]["iter"] == s2["info"]["iter"]
    assert np.array_equal(s1["x"], s2["x"])


# ---------------------------------------------------------------------------
# AUTO dispatch (reference :3237-3321 — strategy-resolution analogue)
# ---------------------------------------------------------------------------


def test_resolve_auto_small_is_direct():
    from scs_tpu.api import _resolve_strategy

    assert _resolve_strategy(scs.LinearSolver.AUTO, 100, 50) == "direct"


def test_resolve_auto_large_without_matrix_is_indirect():
    from scs_tpu.api import _resolve_strategy

    assert _resolve_strategy(scs.LinearSolver.AUTO, 10000, 8192) == "indirect"


def test_resolve_auto_large_blocky_is_bell():
    """AUTO picks bell when the measured block-ELL pack is much smaller
    than dense (api._block_ell_stats cost model)."""
    from scs_tpu.api import _resolve_strategy

    m, n, bs = 8192, 8192, 128
    diag = sp.eye(m, n, format="csc")  # perfectly blocky: 64 tiles
    assert _resolve_strategy(scs.LinearSolver.AUTO, m, n, diag, bs) == "bell"


def test_resolve_auto_large_unstructured_is_indirect():
    from scs_tpu.api import _resolve_strategy

    rng = np.random.RandomState(0)
    m = n = 4224  # > the 4096 direct cutoff
    # unstructured 1% density touches essentially every 128x128 tile
    A = sp.random(m, n, density=0.01, random_state=rng, format="csc")
    assert _resolve_strategy(scs.LinearSolver.AUTO, m, n, A, 128) == "indirect"


@pytest.mark.parametrize(
    "name,expected",
    [
        (scs.LinearSolver.QDLDL, "direct"),
        (scs.LinearSolver.MKL, "direct"),
        (scs.LinearSolver.CPU_DENSE, "direct"),
        (scs.LinearSolver.CUDSS, "direct"),
        (scs.LinearSolver.ACCELERATE, "direct"),
        (scs.LinearSolver.CPU_INDIRECT, "indirect"),
        (scs.LinearSolver.GPU_INDIRECT, "indirect"),
        ("qdldl", "direct"),
        ("cpu_indirect", "indirect"),
    ],
)
def test_linear_solver_names_map(name, expected):
    from scs_tpu.api import _resolve_strategy

    assert _resolve_strategy(name, 100, 50) == expected


def test_invalid_linear_solver_string_raises():
    with pytest.raises(ValueError):
        scs.SCS(_lp_data(), _CONE, linear_solver="not_a_solver", **_KW)


# ---------------------------------------------------------------------------
# legacy one-shot solve()
# ---------------------------------------------------------------------------


def test_legacy_solve_no_P():
    sol = scs.solve(_lp_data(), _CONE, **_KW)
    assert sol["info"]["status"] == "solved"


def test_legacy_solve_with_P():
    rng = np.random.RandomState(5)
    G = rng.randn(_N, 2)
    d = _lp_data()
    d["P"] = sp.csc_matrix(np.triu(G @ G.T * 0.1 + 1e-3 * np.eye(_N)))
    sol = scs.solve(d, _CONE, **_KW)
    assert sol["info"]["status"] == "solved"


def test_legacy_solve_with_warmstart_in_data():
    d = _lp_data()
    ref = scs.solve(d, _CONE, **_KW)
    d2 = _lp_data()
    d2.update(x=ref["x"], y=ref["y"], s=ref["s"])
    sol = scs.solve(d2, _CONE, **_KW)
    assert sol["info"]["status"] == "solved"
    assert sol["info"]["iter"] <= ref["info"]["iter"]


def test_version_and_sizeofs():
    assert isinstance(scs.__version__, str) and scs.__version__
    assert scs.__sizeof_int__ in (4, 8)
    assert scs.__sizeof_float__ in (4, 8)


# ---------------------------------------------------------------------------
# cone mixtures & misc solve behavior
# ---------------------------------------------------------------------------


def test_mixed_lp_and_exp_cone():
    """min t + u s.t. (1, 1, t) in K_exp, 0 <= u <= 2 -> t* = e, u* = 0
    (reference test_scs_coverage.py:1561-1609)."""
    A = sp.csc_matrix(
        np.array(
            [
                [0.0, 0.0, 1.0, 0.0],
                [0.0, 0.0, 0.0, 1.0],
                [0.0, -1.0, 0.0, 0.0],
                [0.0, 1.0, 0.0, 0.0],
                [0.0, 0.0, -1.0, 0.0],
                [0.0, 0.0, 0.0, -1.0],
                [-1.0, 0.0, 0.0, 0.0],
            ]
        )
    )
    b = np.array([1.0, 1.0, 0.0, 2.0, 0.0, 0.0, 0.0])
    c = np.array([1.0, 1.0, 0.0, 0.0])
    sol = scs.solve(
        {"A": A, "b": b, "c": c},
        {"z": 2, "l": 2, "ep": 1},
        eps_abs=1e-7,
        eps_rel=1e-7,
        verbose=False,
        max_iters=20000,
    )
    assert sol["info"]["status"] in ("solved", "solved_inaccurate")
    assert_almost_equal(sol["x"][0], np.e, decimal=3)
    assert_almost_equal(sol["x"][1], 0.0, decimal=3)


def test_two_power_cones():
    """Two power cones with different parameters in one problem."""
    from tests.oracle import gen_feasible

    K = {"p": [0.4, -0.7]}
    data, p_star, _ = gen_feasible(
        K, n=5, density=1.0, rng=np.random.RandomState(11)
    )
    sol = scs.solve(data, K, eps_abs=1e-6, eps_rel=1e-6, verbose=False,
                    max_iters=20000)
    assert sol["info"]["status"] in ("solved", "solved_inaccurate")
    assert_almost_equal(sol["info"]["pobj"], p_star, decimal=3)


def test_zero_cone_only():
    """Pure equality system (z = m): solution of Ax = b."""
    rng = np.random.RandomState(2)
    A = rng.randn(_N, _N)  # square, invertible w.h.p.
    x0 = rng.randn(_N)
    b = A @ x0
    c = rng.randn(_N)
    sol = scs.solve(
        {"A": sp.csc_matrix(A), "b": b, "c": c}, {"z": _N}, **_KW
    )
    assert sol["info"]["status"] == "solved"
    assert np.linalg.norm(sol["x"] - x0) < 1e-2 * (1 + np.linalg.norm(x0))


def test_zero_and_nonneg_cone():
    """Mixed zero + nonneg cones: row 0 an exact equality by construction."""
    rng = np.random.RandomState(8)
    A = rng.randn(_M, _N) / np.sqrt(_M)
    x0 = rng.randn(_N)
    s = np.abs(rng.randn(_M))
    s[0] = 0.0  # zero-cone row: slack exactly 0
    b = A @ x0 + s
    y = np.abs(rng.randn(_M))  # y free on the zero row (dual = all of R)
    c = -(A.T @ y)
    sol = scs.solve(
        {"A": sp.csc_matrix(A), "b": b, "c": c}, {"z": 1, "l": _M - 1}, **_KW
    )
    assert sol["info"]["status"] in ("solved", "solved_inaccurate")


def test_very_sparse_A():
    A = sp.eye(_M, _N, format="csc")
    rng = np.random.RandomState(4)
    x0 = rng.randn(_N)
    s = np.abs(rng.randn(_M))
    b = A @ x0 + s
    c = -(A.T @ np.abs(rng.randn(_M)))
    sol = scs.solve({"A": A, "b": b, "c": c}, _CONE, **_KW)
    assert sol["info"]["status"] == "solved"


def test_large_max_iters_solves():
    sol = _solve(max_iters=10**6)
    assert sol["info"]["status"] == "solved"


def test_unconstrained_qp_known_solution():
    """min 0.5 x'Px + c'x with only a vacuous constraint: x* = -P^-1 c."""
    P = np.diag([1.0, 2.0, 3.0, 4.0])
    c = np.array([-1.0, -2.0, -3.0, -4.0])
    # vacuous nonneg rows: 0'x + s = 1
    A = sp.csc_matrix(np.zeros((1, 4)) + 1e-12)
    b = np.array([1.0])
    sol = scs.solve(
        {"A": A, "b": b, "c": c, "P": sp.csc_matrix(np.triu(P))},
        {"l": 1},
        eps_abs=1e-6, eps_rel=1e-6, verbose=False, max_iters=20000,
    )
    assert sol["info"]["status"] in ("solved", "solved_inaccurate")
    assert_almost_equal(sol["x"], -c / np.diag(P), decimal=3)
