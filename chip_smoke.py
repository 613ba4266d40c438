#!/usr/bin/env python
"""Smoke test of scs_tpu's solve paths on one GPU, at the sizes users run.

    python chip_smoke.py               # every phase below, on one GPU
    python chip_smoke.py --four-cards  # only the four-card paths

Phases (one process; every phase prints one line with its seconds,
iterations, statuses, its comparison value beside the tolerance, and the
process's running `peak_bytes_in_use`):

  1. flagship   BatchedSCS, B=512 dense QPs (m=1500, n=1000), f32, eps 1e-4,
                generated on the device; objectives against the planted p*.
  2. single     scs_tpu.solve on one QP of that family, dtype "auto" (f64)
                and f32; objectives against p*.
  3. bell       one 30000x20000 block-sparse LP, solver_strategy="bell";
                host f64 residuals of (x, y, s) and the objective against
                a "direct" solve of the same LP.
  4. bell_batch BatchedSCS over 8 sparse 30720x20480 LPs (vmapped SpMV);
                host f64 residuals of each.
  5. mixed_cone the reference's mixed cone K (B=64) at 3-decimal parity,
     hi_acc     and f32 + polish, which must certify its whole batch.
  6. kernels    the block-ELL SpMV against scipy f64 (f32, f64, vmapped),
                and the dense hot ops Core._mv/_tv/_build_S against numpy
                f64 at the flagship shape.

With --four-cards: the flagship batch data-parallel over a 4-card mesh
against the one-card solve, and ShardedSCS (dense and "bell") on a
30720x20480 LP against the one-card solve of the same LP.

Exits non-zero (and never prints "ok": true) if JAX finds no GPU or any
phase fails its check. The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import Counter
from typing import NamedTuple

import numpy as np

EPS = 1e-4


def obj_bound(eps, x, y, s, Ax, ATy, Px, b, c):
    """How far a solution that passes the termination test at
    eps_abs = eps_rel = eps can put its objective from the optimum.

    The test bounds the duality gap by g = eps * (1 + max(|x'Px|, |c'x|,
    |b'y|)) and the residuals ||Ax + s - b||_inf, ||Px + A'y + c||_inf by
    r_p = eps * (1 + max(||Ax||, ||s||, ||b||)) and r_d = eps * (1 +
    max(||Px||, ||A'y||, ||c||)). To first order the objective then lies
    within g + r_p * ||y||_1 + r_d * ||x||_1 of p*. Works on one solution
    or on a batch (leading axis).
    """
    inf = lambda v: np.abs(v).max(axis=-1)  # noqa: E731
    dot = lambda u, v: np.sum(u * v, axis=-1)  # noqa: E731
    g = eps * (1 + np.maximum.reduce(
        [np.abs(dot(x, Px)), np.abs(dot(c, x)), np.abs(dot(b, y))]))
    r_p = eps * (1 + np.maximum.reduce([inf(Ax), inf(s), inf(b)]))
    r_d = eps * (1 + np.maximum.reduce([inf(Px), inf(ATy), inf(c)]))
    return g + r_p * np.abs(y).sum(axis=-1) + r_d * np.abs(x).sum(axis=-1)


def lp_bound(eps, A, b, c, sol):
    """obj_bound of an LP solution (P = 0) with sparse/dense host A."""
    x, y, s = (np.asarray(sol[k], np.float64) for k in ("x", "y", "s"))
    return float(obj_bound(eps, x, y, s, A @ x, A.T @ y, np.zeros_like(x),
                           b, c))


def kkt_residuals(A, b, c, x, y, s, eps):
    """Host f64 check of an LP solution (P = 0, cone {"l": m}).

    Returns ||Ax + s_+ - b||_inf and ||A'y + c||_inf, each divided by the
    solver's termination threshold eps_abs + eps_rel * max(norms of the
    terms), with s_+ = max(s, 0) (the returned s, as the reference's,
    need not lie exactly in K, so the primal check includes its
    distance from K); and min(y, 0) over the same dual threshold.
    """
    x, y, s = (np.asarray(v, np.float64) for v in (x, y, s))
    s_plus = np.maximum(s, 0.0)
    Ax, ATy = A @ x, A.T @ y
    inf = lambda v: float(np.abs(v).max())  # noqa: E731
    rp = inf(Ax + s_plus - b) / (eps + eps * max(inf(Ax), inf(s), inf(b)))
    thr_d = eps + eps * max(inf(ATy), inf(c))
    rd = inf(ATy + c) / thr_d
    y_viol = max(0.0, -float(y.min())) / thr_d
    return rp, rd, y_viol


# The solver applies its test (ratio <= 1) to its own iterate, in
# normalized units and the solve's dtype; the returned point is
# un-normalized, and its s is not projected onto K. Measured ratios
# reach ~2.4 (CPU, small sizes) and ~2.1 (H100, full sizes); 5x keeps a
# margin and still fails a point that is an order of magnitude off.
RES_FACTOR = 5.0


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


class Phase:
    """Collects one phase's line; `check` records a failed comparison
    instead of raising so that the line still prints all its values."""

    def __init__(self, name):
        self.name = name
        self.t0 = time.perf_counter()
        self.fields = {}
        self.failures = []

    def check(self, label, value, limit):
        self.fields[label] = f"{value:.3e} (limit {limit:.3e})"
        if not value <= limit:
            self.failures.append(f"{label}={value!r} > {limit!r}")

    def require(self, label, ok, detail):
        self.fields[label] = detail
        if not ok:
            self.failures.append(f"{label}: {detail}")

    def done(self, **extra):
        self.fields.update(extra)
        secs = time.perf_counter() - self.t0
        parts = " ".join(f"{k}={v}" for k, v in self.fields.items())
        print(
            f"[{self.name}] secs={secs:.3f} {parts} "
            f"peak_bytes_in_use={_peak_bytes()}",
            flush=True,
        )
        if self.failures:
            raise AssertionError(f"{self.name} failed: {self.failures}")


def _statuses(results):
    return dict(Counter(r["info"]["status"] for r in results))


# ---------------------------------------------------------------------------
# phases


def phase_flagship(B=512, m=1500, n=1000, eps=EPS, seed=1234):
    """Phase 1: the bench's flagship batch. Returns (pobj, p*, bound)."""
    from scs_tpu import BatchedSCS
    from scs_tpu.bench_cli import gen_batch_device

    ph = Phase("flagship")
    A, P, b, c, p_star = gen_batch_device(B, m, n, seed=seed)
    p_star = np.asarray(p_star)
    solver = BatchedSCS(
        {"A": A, "P": P, "b": b, "c": c}, {"l": m}, dtype="float32",
        eps_abs=eps, eps_rel=eps, max_iters=20000, verbose=False,
    )
    res = solver.solve()
    pobj = np.array([r["info"]["pobj"] for r in res])
    iters = np.array([r["info"]["iter"] for r in res])
    n_solved = sum(r["info"]["status"] == "solved" for r in res)
    ph.require("solved", n_solved == B, f"{n_solved}/{B}")
    # A and P were donated into the solver's setup: regenerate them
    xys = [np.stack([r[k] for r in res]) for k in ("x", "y", "s")]
    bound = _batch_bound(eps, *xys, *gen_batch_device(B, m, n, seed=seed)[:4])
    err = np.abs(pobj - p_star)
    ph.check("max|pobj-p*|/bound", float((err / bound).max()), 1.0)
    ph.done(max_rel_err=f"{(err / (1 + np.abs(p_star))).max():.3e}",
            iters_mean=f"{iters.mean():.1f}", iters_max=int(iters.max()),
            statuses=_statuses(res))
    return pobj, p_star, bound


def _batch_bound(eps, x, y, s, A, P, b, c):
    """obj_bound for a batch of dense QP solutions (B, .) arrays, the
    operator products taken on the device at "highest" precision."""
    import jax
    import jax.numpy as jnp

    x, y, s = (jnp.asarray(v, jnp.float32) for v in (x, y, s))
    with jax.default_matmul_precision("highest"):
        Ax = jnp.einsum("bmn,bn->bm", A, x)
        ATy = jnp.einsum("bmn,bm->bn", A, y)
        Px = jnp.einsum("bnk,bk->bn", P, x)
    f = lambda v: np.asarray(v, np.float64)  # noqa: E731
    return obj_bound(eps, f(x), f(y), f(s), f(Ax), f(ATy), f(Px), f(b),
                     f(c))


def phase_single(m=1500, n=1000, eps=EPS, seed=99):
    """Phase 2: one problem through scs_tpu.solve, dtype auto and f32."""
    from scipy import sparse

    import scs_tpu
    from scs_tpu.bench_cli import gen_batch

    A, P, b, c, p_star = gen_batch(1, m, n, seed=seed, return_opt=True)
    data = {
        "A": sparse.csc_matrix(A[0]), "P": sparse.csc_matrix(np.triu(P[0])),
        "b": b[0], "c": c[0],
    }
    p = float(p_star[0])
    A1, P1, b1, c1 = A[0], P[0], b[0], c[0]
    for dtype, resolved in (("auto", "float64"), ("float32", "float32")):
        ph = Phase(f"single_{dtype}")
        solver = scs_tpu.SCS(
            data, {"l": m}, dtype=dtype, eps_abs=eps, eps_rel=eps,
            max_iters=20000, verbose=False,
        )
        sol = solver.solve()
        info = sol["info"]
        ph.require("status", info["status"] == "solved", info["status"])
        ph.require("dtype", solver.stg.dtype == resolved, solver.stg.dtype)
        x, y, s = (np.asarray(sol[k], np.float64) for k in ("x", "y", "s"))
        bound = float(obj_bound(eps, x, y, s, A1 @ x, A1.T @ y, P1 @ x,
                                b1, c1))
        ph.check("|pobj-p*|", abs(info["pobj"] - p), bound)
        ph.done(iters=info["iter"])


def phase_bell(m=30000, n=20000, density=0.002, eps=EPS, block_size=128):
    """Phase 3: one block-sparse LP through the bell strategy, checked on
    the host and against a direct solve of the same LP."""
    import scs_tpu
    from scs_tpu.bench_cli import gen_bell_lp

    ph = Phase("bell")
    data = gen_bell_lp(m, n, density, bs=block_size)
    A, b, c = data["A"], data["b"], data["c"]
    sol = scs_tpu.solve(
        data, {"l": m}, solver_strategy="bell", bell_block_size=block_size,
        eps_abs=eps, eps_rel=eps, max_iters=50000, verbose=False,
    )
    info = sol["info"]
    ph.require("status", info["status"] == "solved", info["status"])
    rp, rd, cone = kkt_residuals(A, b, c, sol["x"], sol["y"], sol["s"], eps)
    ph.check("res_pri/thr", rp, RES_FACTOR)
    ph.check("res_dual/thr", rd, RES_FACTOR)
    ph.check("y_viol/thr", cone, RES_FACTOR)
    ref = scs_tpu.solve(
        data, {"l": m}, solver_strategy="direct", eps_abs=eps, eps_rel=eps,
        max_iters=50000, verbose=False,
    )
    ph.require("direct_status", ref["info"]["status"] == "solved",
               ref["info"]["status"])
    # each objective lies within its own bound of the optimum
    ph.check("|pobj-pobj_direct|", abs(info["pobj"] - ref["info"]["pobj"]),
             lp_bound(eps, A, b, c, sol) + lp_bound(eps, A, b, c, ref))
    ph.done(iters=info["iter"], direct_iters=ref["info"]["iter"],
            nnz=A.nnz)
    return info["pobj"]


def phase_bell_batch(B=8, m=30720, n=20480, density=0.002, eps=EPS,
                     block_size=128):
    """Phase 4: a batch of sparse LPs through BatchedSCS (vmapped SpMV)."""
    from scs_tpu import BatchedSCS
    from scs_tpu.bench_cli import gen_bell_batch

    ph = Phase("bell_batch")
    As, b, c = gen_bell_batch(B, m, n, density)
    solver = BatchedSCS(
        {"A": As, "b": b, "c": c}, {"l": m}, solver_strategy="bell",
        bell_block_size=block_size, dtype="float32", eps_abs=eps,
        eps_rel=eps, max_iters=20000, verbose=False,
    )
    res = solver.solve()
    n_solved = sum(r["info"]["status"] == "solved" for r in res)
    ph.require("solved", n_solved == B, f"{n_solved}/{B}")
    worst = [0.0, 0.0, 0.0]
    for i, r in enumerate(res):
        vals = kkt_residuals(As[i], b[i], c[i], r["x"], r["y"], r["s"], eps)
        worst = [max(w, v) for w, v in zip(worst, vals)]
    ph.check("max_res_pri/thr", worst[0], RES_FACTOR)
    ph.check("max_res_dual/thr", worst[1], RES_FACTOR)
    ph.check("max_y_viol/thr", worst[2], RES_FACTOR)
    iters = np.array([r["info"]["iter"] for r in res])
    ph.done(iters_mean=f"{iters.mean():.1f}", iters_max=int(iters.max()))


def phase_mixed_and_polish(B_mixed=64, B_hi=32, m_hi=1500, n_hi=1000):
    """Phase 5: the mixed cone K at 3-decimal parity, and f32 + polish."""
    from scs_tpu.bench_cli import _hi_acc_submetric, _mixed_cone_submetric

    ph = Phase("mixed_cone")
    out = _mixed_cone_submetric(B=B_mixed)
    ph.require("solved", out["n_solved"] == B_mixed,
               f"{out['n_solved']}/{B_mixed}")
    # the reference's assert_almost_equal(decimal=3): |err| < 1.5e-3
    ph.check("max|pobj-p*|", out["max_obj_err_vs_planted"], 1.5e-3)
    ph.done(iters_mean=out["mean_iters"], iters_max=out["max_iters_seen"])

    ph = Phase("hi_acc")
    out = _hi_acc_submetric(B=B_hi, m=m_hi, n=n_hi)
    ph.require("certified", out["n_certified"] == B_hi and
               out["status"] == "solved",
               f"{out['n_certified']}/{B_hi} status={out['status']}")
    # polish's own certificate is ~1e-7 relative KKT; its objective must
    # agree with the planted f64 optimum far below eps
    ph.check("max_rel|pobj-p*|", out["max_obj_rel_err_vs_f64"] or np.inf,
             1e-6)
    ph.done(iters_mean=out["mean_iters"])


class _AP(NamedTuple):
    A: object
    P: object


def phase_kernels(m=30000, n=20000, density=0.002, B_bell=8,
                  m_b=30720, n_b=20480, B_dense=8, m_d=1500, n_d=1000,
                  block_size=128):
    """Phase 6: every device op of the hot path against a host f64
    reference. Errors are normalized by the same product taken in
    absolute values (|M| |v|), so each is a relative rounding error: f32
    must stay below 1e-5 (its reductions of 1e3-3e4 terms give ~1e-6;
    a TF32 matmul gives ~1e-4), f64 below 1e-12."""
    import jax
    import jax.numpy as jnp

    from scs_tpu.bench_cli import gen_batch_device, gen_bell_batch, gen_bell_lp
    from scs_tpu.cones import ConeSpec
    from scs_tpu.ops.sparse import bell_spmv_ref, pack_bell
    from scs_tpu.settings import Settings
    from scs_tpu.solver import Core, _hp

    tol = {jnp.float32: 1e-5, jnp.float64: 1e-12}

    def rel_err(got, ref, scale):
        return float(np.abs(np.asarray(got, np.float64) - ref).max()
                     / max(float(np.abs(scale).max()), 1e-300))

    ph = Phase("kernel_bell_spmv")
    A = gen_bell_lp(m, n, density, bs=block_size)["A"]
    rng = np.random.RandomState(5)
    x = rng.randn(n)
    absAx = abs(A) @ np.abs(x)
    for dt in (jnp.float32, jnp.float64):
        bm = pack_bell(A, block_size, dt)
        x_dt = np.asarray(x, dt)
        got = jax.jit(bm.mv)(jnp.asarray(x_dt))
        ph.check(f"mv_{jnp.dtype(dt).name}",
                 rel_err(got, A @ x_dt.astype(np.float64), absAx), tol[dt])
    As, _, _ = gen_bell_batch(B_bell, m_b, n_b, density)
    bms = [pack_bell(Ai, block_size, jnp.float32) for Ai in As]
    xs = rng.randn(B_bell, n_b).astype(np.float32)
    blocks = jnp.stack([bm.A_blocks for bm in bms])
    cols = jnp.stack([bm.A_cols for bm in bms])
    x_pad = jnp.zeros((B_bell, bms[0].n_pad), jnp.float32).at[:, :n_b].set(xs)
    got = jax.jit(jax.vmap(bell_spmv_ref))(blocks, cols, x_pad)[:, :m_b]
    worst = max(
        rel_err(got[i], As[i] @ xs[i].astype(np.float64),
                abs(As[i]) @ np.abs(xs[i]))
        for i in range(B_bell)
    )
    ph.check("vmap_mv_float32", worst, tol[jnp.float32])
    ph.done(shape=f"{m}x{n}", batch_shape=f"{B_bell}x{m_b}x{n_b}")

    ph = Phase("kernel_dense")
    Ad, Pd, _, _, _ = gen_batch_device(B_dense, m_d, n_d, seed=7)
    core = Core(m_d, n_d, True, ConeSpec.from_dict({"l": m_d}),
                Settings(dtype="float32", verbose=False))
    vx = jnp.asarray(rng.randn(B_dense, n_d), jnp.float32)
    vy = jnp.asarray(rng.randn(B_dense, m_d), jnp.float32)
    dy = jnp.asarray(np.abs(rng.randn(B_dense, m_d)) + 0.1, jnp.float32)
    mv = jax.jit(jax.vmap(core._mv))(Ad, vx)
    tv = jax.jit(jax.vmap(core._tv))(Ad, vy)
    build = jax.vmap(core._build_S)
    S_hp = jax.jit(_hp(build))(_AP(Ad, Pd), dy)
    S_default = jax.jit(build)(_AP(Ad, Pd), dy)
    A64, P64 = np.asarray(Ad, np.float64), np.asarray(Pd, np.float64)
    x64, y64, d64 = (np.asarray(v, np.float64) for v in (vx, vy, dy))
    rho = core.stg.rho_x
    worst = dict(mv=0.0, tv=0.0, S=0.0, S_default=0.0)
    for i in range(B_dense):
        Ai = A64[i]
        worst["mv"] = max(worst["mv"], rel_err(
            mv[i], Ai @ x64[i], np.abs(Ai) @ np.abs(x64[i])))
        worst["tv"] = max(worst["tv"], rel_err(
            tv[i], Ai.T @ y64[i], np.abs(Ai).T @ np.abs(y64[i])))
        S_ref = Ai.T @ (Ai * d64[i][:, None]) + P64[i] + rho * np.eye(n_d)
        S_abs = np.abs(Ai).T @ (np.abs(Ai) * d64[i][:, None]) + np.abs(P64[i])
        worst["S"] = max(worst["S"], rel_err(S_hp[i], S_ref, S_abs))
        worst["S_default"] = max(
            worst["S_default"], rel_err(S_default[i], S_ref, S_abs))
    ph.check("mv_float32", worst["mv"], tol[jnp.float32])
    ph.check("tv_float32", worst["tv"], tol[jnp.float32])
    ph.check("build_S_float32_hp", worst["S"], tol[jnp.float32])
    ph.done(shape=f"{B_dense}x{m_d}x{n_d}",
            build_S_default_precision=f"{worst['S_default']:.3e}")


def phase_four_cards(n_dev=4, B=512, m=1500, n=1000, m_lp=30720, n_lp=20480,
                     density=0.002, eps=EPS, block_size=128):
    """The paths that exist only across cards, each against its one-card
    solve: the flagship batch data-parallel over an n_dev mesh, and
    ShardedSCS (dense "indirect" and "bell") on one sparse LP."""
    import jax

    import scs_tpu
    from scs_tpu import BatchedSCS
    from scs_tpu.bench_cli import gen_batch_device, gen_bell_lp
    from scs_tpu.parallel import (
        ShardedSCS, make_mesh, shard_batched_mats, sharded_batch_solve,
    )
    from scs_tpu.solver import _hp

    if len(jax.devices()) < n_dev:
        raise RuntimeError(f"need {n_dev} devices, have {len(jax.devices())}")

    seed = 1234
    pobj_1, p_star, bound_1 = phase_flagship(B, m, n, eps, seed=seed)
    ph = Phase("sharded_batch")
    A, P, b, c, _ = gen_batch_device(B, m, n, seed=seed)
    solver = BatchedSCS(
        {"A": A, "P": P, "b": b, "c": c}, {"l": m}, dtype="float32",
        eps_abs=eps, eps_rel=eps, max_iters=20000, verbose=False,
    )
    mesh = make_mesh(n_dev, axis_name="batch")
    mats = shard_batched_mats(solver.mats, mesh)
    states = sharded_batch_solve(solver.core, mats, mesh, max_iters=20000)
    with mesh:
        x, y, s = jax.jit(_hp(jax.vmap(solver.core._finalize)))(
            states, mats)[:3]
    status = np.asarray(states.status)
    pobj = np.asarray(states.diag.pobj, np.float64)
    iters = np.asarray(states.it)
    n_solved = int((status == 1).sum())
    ph.require("solved", n_solved == B, f"{n_solved}/{B}")
    bound = _batch_bound(eps, x, y, s,
                         *gen_batch_device(B, m, n, seed=seed)[:4])
    ph.check("max|pobj-p*|/bound",
             float((np.abs(pobj - p_star) / bound).max()), 1.0)
    # both objectives lie within their own bounds of the same optimum
    ph.check("max|pobj-pobj_1card|/(bound+bound_1card)",
             float((np.abs(pobj - pobj_1) / (bound + bound_1)).max()), 1.0)
    ph.done(iters_mean=f"{iters.mean():.1f}", iters_max=int(iters.max()),
            devices=n_dev)

    data = gen_bell_lp(m_lp, n_lp, density, bs=block_size)
    A_lp, b_lp, c_lp = data["A"], data["b"], data["c"]
    ph = Phase("one_card_lp")
    ref = scs_tpu.solve(
        data, {"l": m_lp}, solver_strategy="bell",
        bell_block_size=block_size, eps_abs=eps, eps_rel=eps,
        max_iters=50000, verbose=False,
    )
    ph.require("status", ref["info"]["status"] == "solved",
               ref["info"]["status"])
    bound_ref = lp_bound(eps, A_lp, b_lp, c_lp, ref)
    ph.done(iters=ref["info"]["iter"])
    for strategy in ("indirect", "bell"):
        ph = Phase(f"sharded_{strategy}")
        sol = ShardedSCS(
            data, {"l": m_lp}, mesh=make_mesh(n_dev, axis_name="rows"),
            solver_strategy=strategy, bell_block_size=block_size,
            eps_abs=eps, eps_rel=eps, max_iters=50000, verbose=False,
        ).solve()
        info = sol["info"]
        ph.require("status", info["status"] == "solved", info["status"])
        rp, rd, cone = kkt_residuals(A_lp, b_lp, c_lp, sol["x"], sol["y"],
                                     sol["s"], eps)
        ph.check("res_pri/thr", rp, RES_FACTOR)
        ph.check("res_dual/thr", rd, RES_FACTOR)
        ph.check("y_viol/thr", cone, RES_FACTOR)
        ph.check("|pobj-pobj_1card|",
                 abs(info["pobj"] - ref["info"]["pobj"]),
                 lp_bound(eps, A_lp, b_lp, c_lp, sol) + bound_ref)
        ph.done(iters=info["iter"], devices=n_dev)


# ---------------------------------------------------------------------------


def result_line(platform, kind, count):
    """The script's last stdout line."""
    return json.dumps(
        {"ok": True,
         "device": {"platform": platform, "kind": kind, "count": count}}
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card paths and their "
                    "one-card comparisons")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 1

    from scs_tpu.bench_cli import nvidia_smi_line
    from scs_tpu.settings import ensure_compile_cache

    ensure_compile_cache()
    print(f"nvidia-smi: {nvidia_smi_line()}", flush=True)
    print(f"jax {jax.__version__}: {jax.devices()}", flush=True)

    if args.four_cards:
        phase_four_cards()
        count = 4
    else:
        phase_flagship()
        phase_single()
        phase_bell()
        phase_bell_batch()
        phase_mixed_and_polish()
        phase_kernels()
        count = len(jax.devices())
    print(result_line(dev.platform, dev.device_kind, count))
    return 0


if __name__ == "__main__":
    sys.exit(main())
