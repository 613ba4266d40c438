"""Coverage tranche 4 (VERDICT r5 item 9): the reference suite's
AUTO-dispatch mock family (test_scs_coverage.py:3237-3321), file-output
edge cases (:3055-3069), and a settings x strategy matrix.

The reference mocks module imports to test backend fallback; this
package's dispatch axis is the strategy resolver (api._resolve_strategy +
the measured block-ELL cost model api._block_ell_stats), so the mocks
patch those instead — same contract, this package's mechanism.
"""

import os
from unittest import mock

import numpy as np
import pytest
from scipy import sparse

import scs_tpu
from scs_tpu.api import (
    LinearSolver,
    _block_ell_stats,
    _resolve_strategy,
)


def _tiny_lp(m=24, n=16, seed=0):
    rng = np.random.RandomState(seed)
    A = rng.randn(m, n) / np.sqrt(m)
    x0 = rng.randn(n)
    b = A @ x0 + np.abs(rng.randn(m))
    c = -(A.T @ np.abs(rng.randn(m)))
    return {"A": sparse.csc_matrix(A), "b": b, "c": c}


def _tiny_qp(m=24, n=16, seed=0):
    data = _tiny_lp(m, n, seed)
    rng = np.random.RandomState(seed + 1)
    G = rng.randn(n, 4)
    P = G @ G.T * 0.1 + 1e-3 * np.eye(n)
    data["P"] = sparse.csc_matrix(np.triu(P))
    return data


# ===========================================================================
# AUTO-dispatch mocks (reference :3237-3321 analogue)
# ===========================================================================


def test_every_reference_backend_name_resolves():
    """All 8 reference LinearSolver names + 2 package names map onto the
    two strategies (reference scs/py/__init__.py:28-37 name parity)."""
    expected = {
        LinearSolver.QDLDL: "direct",
        LinearSolver.MKL: "direct",
        LinearSolver.ACCELERATE: "direct",
        LinearSolver.CPU_DENSE: "direct",
        LinearSolver.CUDSS: "direct",
        LinearSolver.DENSE_DIRECT: "direct",
        LinearSolver.CPU_INDIRECT: "indirect",
        LinearSolver.GPU_INDIRECT: "indirect",
        LinearSolver.PALLAS_CG: "indirect",
    }
    for ls, want in expected.items():
        assert _resolve_strategy(ls, 100, 50) == want, ls
        # string form accepted too
        assert _resolve_strategy(ls.value, 100, 50) == want, ls


def test_invalid_backend_name_raises():
    with pytest.raises(ValueError):
        _resolve_strategy("not_a_solver", 100, 50)


def test_auto_uses_block_ell_cost_model_for_bell():
    """AUTO -> bell exactly when the MEASURED pack is <= 25% of dense
    (mocked cost model; the dispatch decision, not the packer)."""
    A = sparse.eye(8192, 8192, format="csc")
    with mock.patch(
        "scs_tpu.api._block_ell_stats", return_value=(10, 1000)
    ) as mocked:
        assert (
            _resolve_strategy(LinearSolver.AUTO, 8192, 8192, A) == "bell"
        )
        mocked.assert_called_once()
    with mock.patch(
        "scs_tpu.api._block_ell_stats", return_value=(500, 1000)
    ):
        assert (
            _resolve_strategy(LinearSolver.AUTO, 8192, 8192, A)
            == "indirect"
        )
    # boundary: exactly 25% still picks bell (<=)
    with mock.patch(
        "scs_tpu.api._block_ell_stats", return_value=(250, 1000)
    ):
        assert (
            _resolve_strategy(LinearSolver.AUTO, 8192, 8192, A) == "bell"
        )


def test_auto_small_never_consults_cost_model():
    """n <= 4096 -> direct without measuring the pack (the reference's
    macOS-short-circuit analogue: the preferred choice skips probing)."""
    A = sparse.eye(100, 100, format="csc")
    with mock.patch("scs_tpu.api._block_ell_stats") as mocked:
        assert _resolve_strategy(LinearSolver.AUTO, 100, 100, A) == "direct"
        mocked.assert_not_called()


def test_auto_large_without_matrix_falls_back_to_indirect():
    """No A available (e.g. batched dense entry) -> indirect, no probe —
    the reference's import-failure fallback analogue."""
    assert _resolve_strategy(LinearSolver.AUTO, 9000, 8192, None) == "indirect"


def test_explicit_backend_overrides_auto_heuristic():
    """An explicitly requested backend is honored even where AUTO would
    choose differently (reference: explicit names import that module,
    ImportError propagates rather than falling back)."""
    data = _tiny_lp()
    s = scs_tpu.SCS(
        data, {"l": 24},
        linear_solver=LinearSolver.CPU_INDIRECT, verbose=False,
    )
    assert s.stg.solver_strategy == "indirect"
    s2 = scs_tpu.SCS(
        data, {"l": 24}, linear_solver="qdldl", verbose=False
    )
    assert s2.stg.solver_strategy == "direct"


def test_block_ell_stats_measures_structure_not_density():
    """A block-diagonal matrix packs tiny; the same nnz scattered
    uniformly packs ~dense (the scalar-density trap the measured model
    exists to avoid)."""
    bs = 128
    blockdiag = sparse.block_diag(
        [np.ones((bs, bs))] * 8, format="csc"
    )
    packed_bd, dense_bd = _block_ell_stats(blockdiag, bs)
    assert packed_bd * 4 <= dense_bd  # 2/8 ratio for A and A^T
    rng = np.random.RandomState(0)
    scattered = sparse.random(
        8 * bs, 8 * bs, blockdiag.nnz / (8 * bs) ** 2, format="csc",
        random_state=rng,
    )
    packed_sc, dense_sc = _block_ell_stats(scattered, bs)
    assert packed_sc >= dense_sc  # touches every tile twice (A, A^T)


# ===========================================================================
# File-output edge cases (reference :3055-3069 analogue)
# ===========================================================================


def test_write_data_to_missing_directory_raises():
    data = _tiny_lp()
    with pytest.raises((OSError, IOError, FileNotFoundError)):
        s = scs_tpu.SCS(
            data, {"l": 24}, verbose=False,
            write_data_filename="/nonexistent_dir_xyz/out.npz",
        )
        s.solve()


def test_write_data_overwrites_existing_file(tmp_path):
    path = tmp_path / "prob.npz"
    path.write_bytes(b"garbage")
    data = _tiny_lp()
    s = scs_tpu.SCS(
        data, {"l": 24}, verbose=False, write_data_filename=str(path)
    )
    s.solve()
    loaded = np.load(str(path), allow_pickle=True)
    assert "b" in loaded
    np.testing.assert_allclose(loaded["b"], data["b"])


def test_log_csv_has_one_row_per_logged_iteration(tmp_path):
    path = tmp_path / "log.csv"
    data = _tiny_lp()
    s = scs_tpu.SCS(
        data, {"l": 24}, verbose=False, log_csv_filename=str(path),
        phase_timing="always",
    )
    sol = s.solve()
    lines = path.read_text().strip().splitlines()
    header = lines[0].split(",")
    assert header[0] == "iter"
    # instrumented mode logs every iteration
    assert len(lines) - 1 >= sol["info"]["iter"] - 1
    assert len(lines[1].split(",")) == len(header)


def test_write_data_reload_solves_to_same_objective(tmp_path):
    """Snapshot round-trip parity (reference rw.c semantics): reloading
    the written problem and solving gives the same objective."""
    from scs_tpu import io as io_mod

    path = tmp_path / "prob.npz"
    data = _tiny_qp()
    s = scs_tpu.SCS(
        data, {"l": 24}, verbose=False, write_data_filename=str(path)
    )
    sol = s.solve()
    loaded_data, loaded_cone, loaded_settings = io_mod.read_problem(
        str(path)
    )
    sol2 = scs_tpu.solve(
        loaded_data, loaded_cone, verbose=False, **loaded_settings
    )
    assert abs(sol2["info"]["pobj"] - sol["info"]["pobj"]) < 1e-6 * (
        1 + abs(sol["info"]["pobj"])
    )


# ===========================================================================
# Settings x strategy matrix (reference: cross-backend agreement,
# test_scs_coverage.py:2060-2080, extended over the settings axes)
# ===========================================================================


@pytest.mark.parametrize("strategy", ["direct", "indirect"])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("adaptive_scale", [True, False])
def test_strategy_settings_matrix_lp(strategy, normalize, adaptive_scale):
    data = _tiny_lp(seed=3)
    sol = scs_tpu.solve(
        data, {"l": 24},
        solver_strategy=strategy,
        normalize=normalize,
        adaptive_scale=adaptive_scale,
        verbose=False, max_iters=20000,
    )
    assert sol["info"]["status"] == "solved"
    ref = scs_tpu.solve(
        data, {"l": 24}, solver_strategy="direct", verbose=False,
        max_iters=20000,
    )
    assert abs(sol["info"]["pobj"] - ref["info"]["pobj"]) < 1e-3 * (
        1 + abs(ref["info"]["pobj"])
    )


@pytest.mark.parametrize("alpha", [1.0, 1.8])
@pytest.mark.parametrize("lookback", [0, 10])
def test_alpha_acceleration_matrix_qp(alpha, lookback):
    data = _tiny_qp(seed=5)
    sol = scs_tpu.solve(
        data, {"l": 24},
        alpha=alpha, acceleration_lookback=lookback,
        verbose=False, max_iters=20000,
    )
    assert sol["info"]["status"] == "solved"
    if lookback == 0:
        assert sol["info"]["aa_stats"]["n_accept"] == 0
    ref = scs_tpu.solve(data, {"l": 24}, verbose=False, max_iters=20000)
    assert abs(sol["info"]["pobj"] - ref["info"]["pobj"]) < 1e-3 * (
        1 + abs(ref["info"]["pobj"])
    )


@pytest.mark.parametrize("strategy", ["direct", "indirect"])
def test_rho_x_and_scale_settings_respected(strategy):
    data = _tiny_lp(seed=9)
    sol = scs_tpu.solve(
        data, {"l": 24}, solver_strategy=strategy,
        rho_x=1e-4, scale=0.5, verbose=False, max_iters=20000,
    )
    assert sol["info"]["status"] == "solved"


def test_batched_strategy_matrix_agrees():
    """BatchedSCS direct vs indirect on the same batch: objective
    parity (the batched analogue of cross-backend agreement)."""
    from scs_tpu.batch import solve_batch

    rng = np.random.RandomState(2)
    B, m, n = 3, 24, 16
    A = rng.randn(B, m, n) / np.sqrt(m)
    x0 = rng.randn(B, n)
    b = np.einsum("bmn,bn->bm", A, x0) + np.abs(rng.randn(B, m))
    c = -np.einsum("bmn,bm->bn", A, np.abs(rng.randn(B, m)))
    outs = {}
    for strategy in ("direct", "indirect"):
        res = solve_batch(
            {"A": A, "b": b, "c": c}, {"l": m},
            solver_strategy=strategy, verbose=False, max_iters=20000,
        )
        assert all(r["info"]["status"] == "solved" for r in res)
        outs[strategy] = np.array([r["info"]["pobj"] for r in res])
    np.testing.assert_allclose(
        outs["direct"], outs["indirect"], rtol=1e-3, atol=1e-3
    )
