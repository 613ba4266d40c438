"""Cone projection kernels — jit-safe and vectorized.

Every projection here is the executable-spec counterpart of the reference's
C cone code (scs_source/src/cones.c, exp_cone.c, spectral_cones/*), whose
behavior is pinned down by the reference's NumPy oracle
(/root/reference/test/gen_random_cone_prob.py) and cone-membership tests.

Design (SURVEY.md §7 step 2):
  * The cone layout is static per problem instance, so `make_cone_projector`
    does all ragged-structure work in Python at trace time: segments of the
    slack vector are bucketed by (cone kind, size) and each bucket is
    projected as a dense (num_cones, size) batch — vmap-free vectorization
    that XLA compiles directly.
  * Iterative projections (box, exp, power, spectral) use fixed iteration
    counts inside `lax.fori_loop` — no data-dependent trip counts, so the
    whole projector stays inside one compiled program.
  * Dual-cone projection uses the Moreau decomposition
    Pi_K*(z) = z + Pi_K(-z) (reference: gen_random_cone_prob.py:82-83).

All functions take and return 1-D arrays of shape (m,). Batched problems
vmap over this module at the solver level.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..cones import ConeSpec, sd_cone_size


def _tiny(x):
    """Smallest normal positive value of x's dtype. Guards for log/division
    must be dtype-aware: a literal 1e-300 silently underflows to 0.0 in
    float32, turning the guard into log(0) = -inf -> NaN (the bug that made
    every f32 mixed-cone solve FAIL until round 5)."""
    return jnp.finfo(jnp.result_type(x)).tiny


def _explim(x):
    """Largest safe argument to exp() in x's dtype (~709 f64, ~87 f32)."""
    return 0.99 * float(np.log(jnp.finfo(jnp.result_type(x)).max))


# ---------------------------------------------------------------------------
# Elementwise cones
# ---------------------------------------------------------------------------


def _proj_nonneg(x):
    return jnp.maximum(x, 0.0)


# ---------------------------------------------------------------------------
# Box cone:  K = {(t, s) : t >= 0, bl*t <= s <= bu*t}
# (reference: cones.c box projection, "Newton on t"; homogeneous (t,s) block,
#  see test_scs_coverage.py:555-632 for the encoding.)
# ---------------------------------------------------------------------------


def _proj_box(v, bl, bu, n_iters=100):
    """Project (t, s) = (v[0], v[1:]) onto the box cone.

    Minimizes (t - t0)^2 + ||clip(s0, bl*t, bu*t) - s0||^2 over t >= 0 by
    Newton on the (piecewise-linear, monotone) stationarity condition; for
    fixed t the slack part is the elementwise clip.
    """
    t0 = v[0]
    s0 = v[1:]
    bl_f = jnp.where(jnp.isfinite(bl), bl, 0.0)
    bu_f = jnp.where(jnp.isfinite(bu), bu, 0.0)
    fin_l = jnp.isfinite(bl)
    fin_u = jnp.isfinite(bu)

    def grad(t):
        up_active = fin_u & (s0 > bu_f * t)
        lo_active = fin_l & (s0 < bl_f * t)
        g = (
            (t - t0)
            + jnp.sum(jnp.where(up_active, bu_f * (bu_f * t - s0), 0.0))
            + jnp.sum(jnp.where(lo_active, bl_f * (bl_f * t - s0), 0.0))
        )
        h = (
            1.0
            + jnp.sum(jnp.where(up_active, bu_f * bu_f, 0.0))
            + jnp.sum(jnp.where(lo_active, bl_f * bl_f, 0.0))
        )
        return g, h

    def body(_, t):
        g, h = grad(t)
        return jnp.maximum(t - g / h, 0.0)

    t = lax.fori_loop(0, n_iters, body, jnp.maximum(t0, 0.0))
    lo = jnp.where(fin_l, bl_f * t, -jnp.inf)
    hi = jnp.where(fin_u, bu_f * t, jnp.inf)
    s = jnp.clip(s0, lo, hi)
    return jnp.concatenate([t[None], s])


# ---------------------------------------------------------------------------
# Second-order cone (batched over equal-size cones)
# (reference oracle: gen_random_cone_prob.py:133-150)
# ---------------------------------------------------------------------------


def _proj_soc_batch(z):
    """z: (k, q). Project each row onto the SOC {(t, x): ||x|| <= t}."""
    t = z[:, 0]
    x = z[:, 1:]
    nx = jnp.linalg.norm(x, axis=1)
    # three regimes: inside (nx <= t) -> identity; polar (nx <= -t) -> 0;
    # else boundary scaling.
    coef = jnp.maximum(0.5 * (1.0 + t / jnp.maximum(nx, _tiny(z))), 0.0)
    new_t = jnp.where(nx <= t, t, coef * nx)
    scale_x = jnp.where(nx <= t, 1.0, coef)
    out = jnp.concatenate([new_t[:, None], scale_x[:, None] * x], axis=1)
    return jnp.where((nx <= -t)[:, None], 0.0, out)


# ---------------------------------------------------------------------------
# Real PSD cone, packed triangle with sqrt(2) off-diagonal scaling
# (reference layout: test_scs_coverage.py:1388-1393; oracle proj_sdp at
#  gen_random_cone_prob.py:153-173 — mirrored here operation-for-operation)
# ---------------------------------------------------------------------------


def _psd_unpack_indices(n):
    """Row/col indices of the packed lower-triangle-by-columns layout."""
    iu = np.triu_indices(n)
    rows, cols = iu[1], iu[0]  # oracle swaps to (tidx[1], tidx[0])
    return rows, cols


def _sym_unpack_true(z, n):
    """Packed vector -> the true symmetric matrix X (isometric layout:
    diag entries stored as-is, off-diag stored as sqrt(2)*X_ij).
    z: (k, n(n+1)/2) -> (k, n, n)."""
    k = z.shape[0]
    rows, cols = _psd_unpack_indices(n)
    sqrt2 = jnp.asarray(np.sqrt(2.0), z.dtype)
    a = jnp.zeros((k, n, n), z.dtype).at[:, rows, cols].set(z)
    a = a + jnp.swapaxes(a, 1, 2)
    diag = jnp.arange(n)
    # after symmetrization: diag doubled, off-diag = sqrt(2) X_ij
    a = a / sqrt2
    a = a.at[:, diag, diag].mul(sqrt2 / 2.0)
    return a


def _sym_pack_true(X):
    """(k, n, n) symmetric -> packed (k, n(n+1)/2) with the isometric
    sqrt(2) off-diagonal scaling."""
    n = X.shape[-1]
    rows, cols = _psd_unpack_indices(n)
    sqrt2 = jnp.asarray(np.sqrt(2.0), X.dtype)
    scale = jnp.where(jnp.asarray(rows == cols), 1.0, sqrt2).astype(X.dtype)
    return X[:, rows, cols] * scale[None, :]


def _proj_psd_batch(z, n):
    """z: (k, n(n+1)/2). Batched PSD projection via eigh."""
    k = z.shape[0]
    rows, cols = _psd_unpack_indices(n)
    sqrt2 = jnp.asarray(np.sqrt(2.0), z.dtype)
    a = jnp.zeros((k, n, n), z.dtype).at[:, rows, cols].set(z)
    a = a + jnp.swapaxes(a, 1, 2)
    diag = jnp.arange(n)
    a = a.at[:, diag, diag].mul(1.0 / sqrt2)
    w, v = jnp.linalg.eigh(a)
    w = jnp.maximum(w, 0.0)
    a = jnp.einsum("kij,kj,klj->kil", v, w, v)
    a = a.at[:, diag, diag].mul(1.0 / sqrt2)
    return a[:, rows, cols]


# ---------------------------------------------------------------------------
# Complex PSD cone ('cs'): n^2 reals per cone. Layout: lower triangle by
# columns; diagonal entries real; off-diagonal entries (re, im) pairs scaled
# by sqrt(2). (reference: cones.c complex PSD; dim n^2 per
# test_mix_sd_csd_cone.py:35.)
# ---------------------------------------------------------------------------


def _csd_layout(n):
    """Positions in the packed vector for a column-major lower triangle."""
    diag_pos = []
    off_pos = []  # (pos_re, pos_im, row, col)
    pos = 0
    for j in range(n):
        diag_pos.append((pos, j))
        pos += 1
        for i in range(j + 1, n):
            off_pos.append((pos, pos + 1, i, j))
            pos += 2
    assert pos == n * n
    return diag_pos, off_pos


def _proj_csd_batch(z, n):
    """z: (k, n*n). Batched complex (Hermitian) PSD projection."""
    k = z.shape[0]
    diag_pos, off_pos = _csd_layout(n)
    sqrt2 = np.sqrt(2.0)
    cdtype = jnp.complex128 if z.dtype == jnp.float64 else jnp.complex64

    H = jnp.zeros((k, n, n), cdtype)
    dpos = np.array([p for p, _ in diag_pos])
    didx = np.array([j for _, j in diag_pos])
    H = H.at[:, didx, didx].set(z[:, dpos].astype(cdtype))
    if off_pos:
        rpos = np.array([p for p, _, _, _ in off_pos])
        ipos = np.array([p for _, p, _, _ in off_pos])
        ri = np.array([i for _, _, i, _ in off_pos])
        ci = np.array([j for _, _, _, j in off_pos])
        vals = (z[:, rpos] + 1j * z[:, ipos]).astype(cdtype) / sqrt2
        H = H.at[:, ri, ci].set(vals)
        H = H.at[:, ci, ri].set(jnp.conj(vals))
    w, v = jnp.linalg.eigh(H)
    w = jnp.maximum(w, 0.0)
    Hp = jnp.einsum("kij,kj,klj->kil", v, w.astype(cdtype), jnp.conj(v))
    out = jnp.zeros_like(z)
    out = out.at[:, dpos].set(jnp.real(Hp[:, didx, didx]))
    if off_pos:
        out = out.at[:, rpos].set(jnp.real(Hp[:, ri, ci]) * sqrt2)
        out = out.at[:, ipos].set(jnp.imag(Hp[:, ri, ci]) * sqrt2)
    return out


# ---------------------------------------------------------------------------
# Exponential cone (batched): mirrors the reference oracle's
# bisection-with-inner-Newton (gen_random_cone_prob.py:234-315) with fixed
# iteration counts for jit safety.
#   Kexp = cl{(r, s, t): s > 0, t >= s*exp(r/s)}
# ---------------------------------------------------------------------------


def _exp_newton_onz(rho, y_hat, z_hat, w, n_iters=40):
    """Inner 1-D Newton (oracle newton_exp_onz), vectorized over cones.

    f32-robust formulation: f and fp are multiplied through by rho^2 (the
    Newton step f/fp is invariant), so no term needs 1/rho^2 — which
    overflows f32 once the outer bisection drives rho below ~1e-19 — and
    log(t) - log(rho) replaces log(t/rho), whose quotient can overflow
    first. An overshoot past the t > 0 domain boundary HALVES t (oracle
    inner_z semantics); the old clamp-to-1e-300 parked the iterate on a
    denormal (or exactly 0.0 in f32) where log() is -inf and the whole
    projection went NaN."""
    t = jnp.maximum(jnp.maximum(w - z_hat, -z_hat), 1e-6)

    def body(_, t):
        r2 = rho * rho
        f = t * (t + z_hat) - rho * y_hat + r2 * (
            jnp.log(t) - jnp.log(rho) + 1.0
        )
        fp = 2.0 * t + z_hat + r2 / t
        t_new = t - f / fp
        return jnp.where(t_new > 0, t_new, 0.5 * t)

    return lax.fori_loop(0, n_iters, body, t)


def _exp_solve_with_rho(v, rho, w):
    zb = _exp_newton_onz(rho, v[:, 1], v[:, 2], w)
    x2 = zb + v[:, 2]
    x1 = (1.0 / rho) * zb * x2
    x0 = v[:, 0] - rho
    return jnp.stack([x0, x1, x2], axis=1)


def _exp_calc_grad(v, rho, warm):
    x = _exp_solve_with_rho(v, rho, warm)
    tiny = _tiny(x)
    safe = jnp.maximum(x[:, 1], tiny)
    g = jnp.where(
        x[:, 1] <= 1e-12,
        x[:, 0],
        x[:, 0] + x[:, 1] * jnp.log(safe / jnp.maximum(x[:, 2], tiny)),
    )
    return g, x


def _proj_exp_batch(v, n_doubling=30, n_bisect=64):
    """v: (k, 3). Batched projection onto the exponential cone."""
    r, s, t = v[:, 0], v[:, 1], v[:, 2]

    # Case 1: already in Kexp
    tiny = _tiny(v)
    in_cone = ((s > 0) & (t > 0) & (r <= s * jnp.log(jnp.maximum(t, tiny) / jnp.maximum(s, tiny)))) | (
        (r <= 0) & (s == 0) & (t >= 0)
    )
    # Case 2: -v in Kexp^* -> projection is 0
    lim = _explim(v)
    exp_r = jnp.exp(jnp.clip(s / jnp.where(r != 0, r, 1.0), -lim, lim))
    in_polar = ((-r < 0) & (r * exp_r <= -jnp.e * t)) | ((r == 0) & (-s >= 0) & (-t >= 0))
    # Case 3: analytical (r < 0, s < 0)
    analytic = (r < 0) & (s < 0)

    # Case 4: bisection on rho
    # upper bound by doubling (oracle get_rho_ub), fixed iterations
    def db_body(_, carry):
        lb, rho, x = carry
        g, x_new = _exp_calc_grad(v, rho, x[:, 1])
        grow = g > 0
        lb = jnp.where(grow, rho, lb)
        rho = jnp.where(grow, rho * 2.0, rho)
        x = jnp.where(grow[:, None], x_new, x)
        return lb, rho, x

    lb0 = jnp.zeros_like(r)
    rho0 = jnp.full_like(r, 2.0**-3)
    g0, x0 = _exp_calc_grad(v, rho0, v[:, 1])
    lb, ub, x = lax.fori_loop(0, n_doubling, db_body, (lb0, rho0, v))

    # stop refining once the bracket shrinks below dtype resolution
    # (oracle: `if ub - lb < 1e-14: break`): past that point the inner
    # Newton's root t differs from -z_hat by less than one ulp, so
    # x2 - v2 cancels to 0 and the recovered x is garbage — e.g. for
    # boundary cases whose optimal rho -> 0, 64 unconditioned halvings
    # park rho at ~7e-21 and return s = 0 instead of the true s > 0
    bis_tol = 8.0 * float(jnp.finfo(jnp.result_type(v)).eps)

    def bis_body(_, carry):
        lb, ub, x = carry
        live = (ub - lb) > bis_tol * jnp.maximum(1.0, ub)
        rho = 0.5 * (lb + ub)
        g, x_new = _exp_calc_grad(v, rho, x[:, 1])
        lb = jnp.where(live & (g > 0), rho, lb)
        ub = jnp.where(live & (g <= 0), rho, ub)
        x = jnp.where(live[:, None], x_new, x)
        return lb, ub, x

    lb_f, ub_f, x = lax.fori_loop(0, n_bisect, bis_body, (lb, ub, x))

    # Final polish at the converged rho: recover (x1, x2) from the
    # stationarity equation  zb*x2/rho^2 - y_hat/rho + log(zb/rho) + 1 = 0
    # instead of the direct x2 = zb + z_hat, which loses all precision to
    # cancellation when the root sits at zb ~= -z_hat (optimal rho near
    # 0). Valid only where the inner Newton has converged — i.e. HERE,
    # after the loop, not inside it (mid-bisection zb values are far from
    # the root and the recovery explodes) — so guard on consistency.
    rho_f = 0.5 * (lb_f + ub_f)
    zb_f = _exp_newton_onz(rho_f, s, t, x[:, 1])
    x1s = s - rho_f * (jnp.log(zb_f) - jnp.log(rho_f) + 1.0)
    x2s = rho_f * x1s / zb_f
    stable = jnp.stack([r - rho_f, x1s, x2s], axis=1)
    # trust the recovery ONLY where the direct sum visibly cancelled (it
    # lost nearly all its ulps): everywhere else the loop iterate is at
    # least as accurate, and the recovery has its own complementary
    # cancellation (x1s = s - rho*(...) loses digits when |s| >> x1),
    # which degrades near-apex rows (s << 0, t > 0) if applied eagerly
    x2d = zb_f + t
    eps_dt = float(jnp.finfo(jnp.result_type(v)).eps)
    cancel = jnp.abs(x2d) < 64.0 * eps_dt * jnp.abs(t)
    use = (
        jnp.isfinite(x1s)
        & jnp.isfinite(x2s)
        & (x1s >= 0)
        & (x2s >= 0)
        & (rho_f > 0)
        & cancel
    )
    x = jnp.where(use[:, None], stable, x)

    out = x
    # Degenerate rho -> 0 rows: g < 0 for every rho, so the bisection
    # collapses onto lb = 0, where the inner root zb ~= -z_hat cancels
    # x2 = zb + z_hat to 0 ulps and x is garbage (the oracle drifts here
    # too: SLSQP cross-check shows its s off by ~1e-2). The true limit is
    # the boundary point at s = s0:  p = (r0, s0, s0*exp(r0/s0)).
    collapsed = (lb_f == 0) & (ub_f <= 2.0 * bis_tol)
    s_pos = jnp.maximum(s, 0.0)
    t_lim = s_pos * jnp.exp(
        jnp.clip(r / jnp.maximum(s_pos, tiny), -lim, lim)
    )
    out = jnp.where(
        collapsed[:, None],
        jnp.stack([r, s_pos, jnp.maximum(t_lim, 0.0)], axis=1),
        out,
    )
    out = jnp.where(
        analytic[:, None],
        jnp.stack([r, jnp.zeros_like(s), jnp.maximum(t, 0.0)], axis=1),
        out,
    )
    out = jnp.where(in_polar[:, None], 0.0, out)
    out = jnp.where(in_cone[:, None], v, out)
    return out


# ---------------------------------------------------------------------------
# Power cone (batched): damped Newton, mirrors oracle proj_pow
# (gen_random_cone_prob.py:176-231). K_a = {(x,y,z): x,y>=0, x^a y^(1-a)>=|z|}
# ---------------------------------------------------------------------------


def _proj_pow_batch(v, a, n_iters=40):
    """v: (k, 3), a: (k,) power parameters in (0, 1)."""
    x0, y0, z0 = v[:, 0], v[:, 1], v[:, 2]

    def safe_pow(base, e):
        return jnp.exp(e * jnp.log(jnp.maximum(base, _tiny(base))))

    in_cone = (x0 >= 0) & (y0 >= 0) & (safe_pow(x0, a) * safe_pow(y0, 1 - a) >= jnp.abs(z0))
    in_polar = (
        (x0 <= 0)
        & (y0 <= 0)
        & (safe_pow(-x0 / a, a) * safe_pow(-y0 / (1 - a), 1 - a) >= jnp.abs(z0))
    )

    rh = jnp.abs(z0)

    def calc_x(r, xh, aa):
        return jnp.maximum(0.5 * (xh + jnp.sqrt(xh * xh + 4.0 * aa * (rh - r) * r)), 1e-12)

    def body(_, r):
        x = calc_x(r, x0, a)
        y = calc_x(r, y0, 1 - a)
        f = safe_pow(x, a) * safe_pow(y, 1 - a) - r
        dxdr = a * (rh - 2.0 * r) / (2.0 * x - x0)
        dydr = (1 - a) * (rh - 2.0 * r) / (2.0 * y - y0)
        fp = safe_pow(x, a) * safe_pow(y, 1 - a) * (a * dxdr / x + (1 - a) * dydr / y) - 1.0
        r_new = jnp.clip(r - f / fp, 0.0, rh)
        return jnp.where(jnp.abs(f) < 1e-12, r, r_new)

    r = lax.fori_loop(0, n_iters, body, rh / 2.0)
    x = calc_x(r, x0, a)
    y = calc_x(r, y0, 1 - a)
    z = jnp.sign(z0) * r
    out = jnp.stack([x, y, z], axis=1)
    out = jnp.where(in_polar[:, None], 0.0, out)
    out = jnp.where(in_cone[:, None], v, out)
    return out


# ---------------------------------------------------------------------------
# ell1-norm cone: {(t, x): ||x||_1 <= t}  (reference: ell1_cone.c; bound
# semantics tested at test_spectral_and_complex_cones.py:180-188)
# ---------------------------------------------------------------------------


def _proj_ell1_batch(z):
    """z: (k, n+1) rows (t, x). Exact sort-based epigraph projection."""
    t0 = z[:, 0]
    x0 = z[:, 1:]
    ax = jnp.abs(x0)
    l1 = jnp.sum(ax, axis=1)
    inside = l1 <= t0
    linf = jnp.max(ax, axis=1) if ax.shape[1] > 0 else jnp.zeros_like(t0)
    in_polar = t0 <= -linf

    # Find lam >= 0 with sum(max(|x|-lam,0)) = t0 + lam via the sorted
    # cumulative-sum characterization (waterfilling).
    srt = jnp.sort(ax, axis=1)[:, ::-1]  # descending
    csum = jnp.cumsum(srt, axis=1)
    j = jnp.arange(1, ax.shape[1] + 1)
    # candidate lam if exactly top-j entries stay active:
    lam_j = (csum - t0[:, None]) / (j[None, :] + 1.0)
    # valid when srt_j > lam_j >= srt_{j+1}
    nxt = jnp.concatenate([srt[:, 1:], jnp.full_like(srt[:, :1], -jnp.inf)], axis=1)
    valid = (lam_j < srt) & (lam_j >= nxt) & (lam_j >= 0)
    # pick the first valid j (exactly one exists when not inside/polar)
    lam = jnp.max(jnp.where(valid, lam_j, -jnp.inf), axis=1)
    lam = jnp.maximum(lam, 0.0)

    x = jnp.sign(x0) * jnp.maximum(ax - lam[:, None], 0.0)
    t = t0 + lam
    out = jnp.concatenate([t[:, None], x], axis=1)
    out = jnp.where(in_polar[:, None], 0.0, out)
    return jnp.where(inside[:, None], z, out)


# ---------------------------------------------------------------------------
# Nuclear-norm cone: {(t, X): ||X||_* <= t}, X is m x n column-major
# (reference: nuclear_cone.c; layout per test_spectral_and_complex_cones.py:
#  240-243). SVD + ell1-epigraph projection of the singular values.
# ---------------------------------------------------------------------------


def _proj_nuc_batch(z, mn):
    mm, nn = mn
    t0 = z[:, :1]
    X = z[:, 1:].reshape(-1, nn, mm).transpose(0, 2, 1)  # column-major unpack
    U, sig, Vt = jnp.linalg.svd(X, full_matrices=False)
    proj = _proj_ell1_batch(jnp.concatenate([t0, sig], axis=1))
    t = proj[:, :1]
    sig_p = proj[:, 1:]
    Xp = jnp.einsum("kij,kj,kjl->kil", U, sig_p, Vt)
    return jnp.concatenate([t, Xp.transpose(0, 2, 1).reshape(z.shape[0], -1)], axis=1)


# ---------------------------------------------------------------------------
# Sum-of-k-largest-eigenvalues cone: {(t, X): sum_k-largest eig(X) <= t}
# (reference: sum_largest_cone.c / sum_largest_eval_cone.c). Spectral
# reduction + epigraph projection via nested bisection:
#   prox_{mu*s_k}(w) = w - mu * Pi_Y(w / mu),  Y = {y in [0,1]^n, 1'y = k}
# ---------------------------------------------------------------------------


def _proj_capped_simplex(w, k_val, n_bisect=60):
    """Project rows of w onto {y: 0 <= y <= 1, sum(y) = k}."""
    lo = jnp.min(w, axis=1) - 1.0
    hi = jnp.max(w, axis=1)

    def body(_, carry):
        lo, hi = carry
        mid = 0.5 * (lo + hi)
        ssum = jnp.sum(jnp.clip(w - mid[:, None], 0.0, 1.0), axis=1)
        too_big = ssum > k_val
        lo = jnp.where(too_big, mid, lo)
        hi = jnp.where(too_big, hi, mid)
        return lo, hi

    lo, hi = lax.fori_loop(0, n_bisect, body, (lo, hi))
    tau = 0.5 * (lo + hi)
    return jnp.clip(w - tau[:, None], 0.0, 1.0)


def _sum_k_largest(w, k_val):
    srt = jnp.sort(w, axis=1)[:, ::-1]
    return jnp.sum(srt[:, : int(k_val)], axis=1)


def _proj_sl_vec_batch(t0, w0, k_val, n_bisect=60):
    """Project (t, w) onto {(t, w): sum of k largest w_i <= t}."""
    sk = _sum_k_largest(w0, k_val)
    inside = sk <= t0

    def h(mu):
        y = _proj_capped_simplex(w0 / jnp.maximum(mu, _tiny(mu))[:, None], k_val)
        w = w0 - mu[:, None] * y
        return _sum_k_largest(w, k_val) - t0 - mu, w

    # mu in [0, ub]: at mu = ub = (sk - t0) (clipped positive), h(ub) <= 0
    ub0 = jnp.maximum(sk - t0, 1e-12)
    lo = jnp.zeros_like(t0)
    hi = ub0

    def body(_, carry):
        lo, hi = carry
        mid = 0.5 * (lo + hi)
        val, _ = h(mid)
        pos = val > 0
        lo = jnp.where(pos, mid, lo)
        hi = jnp.where(pos, hi, mid)
        return lo, hi

    lo, hi = lax.fori_loop(0, n_bisect, body, (lo, hi))
    mu = 0.5 * (lo + hi)
    _, w = h(mu)
    t = t0 + mu
    t = jnp.where(inside, t0, t)
    w = jnp.where(inside[:, None], w0, w)
    return t, w


def _proj_sl_batch(z, nk):
    nn, kk = nk
    t0 = z[:, 0]
    X = _sym_unpack_true(z[:, 1:], nn)
    w, v = jnp.linalg.eigh(X)
    t, wp = _proj_sl_vec_batch(t0, w, kk)
    Xp = jnp.einsum("kij,kj,klj->kil", v, wp, v)
    return jnp.concatenate([t[:, None], _sym_pack_true(Xp)], axis=1)


# ---------------------------------------------------------------------------
# Log-determinant cone: K = cl{(t, v, X): v > 0, X PSD, t <= v*logdet(X/v)}
# (reference: spectral_cones/logdet/*; dim = sd_cone_size(n) + 2).
# Spectral reduction + damped Newton on the 2-variable KKT system.
# ---------------------------------------------------------------------------


def _proj_logdet_vec_batch(t0, v0, w0, n_outer=80):
    """Project (t, v, w) onto cl{(t,v,w): v>0, w>0, t <= v*sum(log(w/v))}.

    KKT with multiplier mu >= 0 of g = t - v*sum(log(w/v)) <= 0:
      t   = t0 - mu
      w_i = (w0_i + sqrt(w0_i^2 + 4*mu*v)) / 2
      v   = v0 + mu*(sum(log(w_i/v)) - n)          [phi(v) = 0, phi' > 1]
      root equation  h(mu) = v*slog - (t0 - mu) = 0  (h increasing).

    The projection is one of three candidates (uniqueness of projection +
    facet decomposition of the boundary):
      A: (t0, v0, w0) itself when already in the cone;
      C: the active-constraint KKT point with v > 0 (nested bisection);
      D: the projection onto the v = 0 facet {t <= 0, w >= 0}.
    We return the feasible candidate with minimal distance.
    """
    n = w0.shape[1]
    fn = float(n)

    def solve_v(mu):
        """Inner 1-D bisection on phi(v) = v - v0 - mu*(slog(v) - n)."""

        def slog_of(vv):
            w = 0.5 * (w0 + jnp.sqrt(w0 * w0 + 4.0 * mu[:, None] * vv[:, None]))
            return (
                jnp.sum(jnp.log(jnp.maximum(w, _tiny(w))), axis=1)
                - fn * jnp.log(jnp.maximum(vv, _tiny(vv))),
                w,
            )

        lo = jnp.full_like(v0, 1e-30)
        hi = jnp.maximum(jnp.abs(v0), 1.0)

        def grow(_, carry):
            lo, hi = carry
            slog, _ = slog_of(hi)
            phi = hi - v0 - mu * (slog - fn)
            need = phi < 0  # root above hi
            lo = jnp.where(need, hi, lo)
            hi = jnp.where(need, hi * 4.0, hi)
            return lo, hi

        lo, hi = lax.fori_loop(0, 40, grow, (lo, hi))

        def bis(_, carry):
            lo, hi = carry
            mid = 0.5 * (lo + hi)
            slog, _ = slog_of(mid)
            phi = mid - v0 - mu * (slog - fn)
            neg = phi < 0
            lo = jnp.where(neg, mid, lo)
            hi = jnp.where(neg, hi, mid)
            return lo, hi

        lo, hi = lax.fori_loop(0, 60, bis, (lo, hi))
        v = 0.5 * (lo + hi)
        slog, w = slog_of(v)
        return v, w, slog

    def h_of(mu):
        v, w, slog = solve_v(mu)
        return v * slog - t0 + mu, v, w

    # outer bisection on mu: h increasing, root where constraint active
    lo = jnp.zeros_like(t0)
    hi = jnp.ones_like(t0)

    def grow(_, carry):
        lo, hi = carry
        h, _, _ = h_of(hi)
        need = h < 0
        lo = jnp.where(need, hi, lo)
        hi = jnp.where(need, hi * 4.0, hi)
        return lo, hi

    lo, hi = lax.fori_loop(0, 40, grow, (lo, hi))

    def bis(_, carry):
        lo, hi = carry
        mid = 0.5 * (lo + hi)
        h, _, _ = h_of(mid)
        neg = h < 0
        lo = jnp.where(neg, mid, lo)
        hi = jnp.where(neg, hi, mid)
        return lo, hi

    lo, hi = lax.fori_loop(0, n_outer, bis, (lo, hi))
    mu = 0.5 * (lo + hi)
    _, vC, wC = h_of(mu)
    tC = t0 - mu

    # candidate D: v = 0 facet
    tD = jnp.minimum(t0, 0.0)
    vD = jnp.zeros_like(v0)
    wD = jnp.maximum(w0, 0.0)

    def dist2(t, v, w):
        return (t - t0) ** 2 + (v - v0) ** 2 + jnp.sum((w - w0) ** 2, axis=1)

    use_D = dist2(tD, vD, wD) < dist2(tC, vC, wC)
    t = jnp.where(use_D, tD, tC)
    v = jnp.where(use_D, vD, vC)
    w = jnp.where(use_D[:, None], wD, wC)

    # candidate A: already inside (closure-aware test)
    w_pos = jnp.all(w0 >= 0, axis=1)
    slog0 = jnp.sum(
        jnp.log(jnp.maximum(w0, _tiny(w0))), axis=1
    ) - fn * jnp.log(jnp.maximum(v0, _tiny(v0)))
    inside = jnp.where(
        v0 > 0,
        w_pos & (t0 <= v0 * slog0),
        (v0 == 0) & w_pos & (t0 <= 0),
    )
    t = jnp.where(inside, t0, t)
    v = jnp.where(inside, v0, v)
    w = jnp.where(inside[:, None], w0, w)
    return t, v, w


def _proj_logdet_batch(z, nn):
    t0 = z[:, 0]
    v0 = z[:, 1]
    X = _sym_unpack_true(z[:, 2:], nn)
    w, vec = jnp.linalg.eigh(X)
    t, v, wp = _proj_logdet_vec_batch(t0, v0, w)
    Xp = jnp.einsum("kij,kj,klj->kil", vec, wp, vec)
    return jnp.concatenate([t[:, None], v[:, None], _sym_pack_true(Xp)], axis=1)


# ---------------------------------------------------------------------------
# Projector factory
# ---------------------------------------------------------------------------


def make_cone_projector(spec: ConeSpec, dtype=jnp.float64) -> Callable:
    """Build Pi_K for the full concatenated slack vector (shape (m,)).

    Returns a jit-safe function proj(z, bl=None, bu=None); the box-cone
    bounds may be supplied dynamically (the solver normalizes them with the
    row scaling D, so they are per-instance data, not static structure).
    All ragged layout work happens here in Python. Dual projection: use
    `make_dual_cone_projector`.
    """
    segs = spec.segments()
    m = spec.dim

    # bucket segments by (kind, param); each bucket becomes one batched op
    buckets = {}
    for sg in segs:
        buckets.setdefault((sg.kind, sg.param), []).append(sg)

    # Precompute static gather indices per bucket
    plans = []
    for (kind, param), group in buckets.items():
        idx = np.concatenate(
            [np.arange(sg.offset, sg.offset + sg.length) for sg in group]
        )
        plans.append((kind, param, len(group), idx))

    # host numpy constants: a device-array closure constant is fetched
    # D2H at MLIR-lowering time (see solver.Core.zero_mask note)
    bl_default = np.asarray(spec.bl, dtype)
    bu_default = np.asarray(spec.bu, dtype)

    def proj(z, bl=None, bu=None):
        bl = bl_default if bl is None else bl
        bu = bu_default if bu is None else bu
        out = z

        for kind, param, count, idx in plans:
            vals = z[idx]
            if kind == "z":
                res = jnp.zeros_like(vals)
            elif kind == "l":
                res = _proj_nonneg(vals)
            elif kind == "box":
                res = _proj_box(vals, bl, bu)
            elif kind == "q":
                res = _proj_soc_batch(vals.reshape(count, param)).reshape(-1)
            elif kind == "s":
                if param == 1:
                    res = _proj_nonneg(vals)
                else:
                    res = _proj_psd_batch(
                        vals.reshape(count, sd_cone_size(param)), param
                    ).reshape(-1)
            elif kind == "cs":
                if param == 1:
                    res = _proj_nonneg(vals)
                else:
                    res = _proj_csd_batch(vals.reshape(count, param * param), param).reshape(-1)
            elif kind == "ep":
                res = _proj_exp_batch(vals.reshape(count, 3)).reshape(-1)
            elif kind == "ed":
                # dual exp cone via Moreau
                vv = vals.reshape(count, 3)
                res = (vv + _proj_exp_batch(-vv)).reshape(-1)
            elif kind == "p":
                vv = vals.reshape(count, 3)
                a = jnp.full((count,), abs(param), dtype)
                if param >= 0:
                    res = _proj_pow_batch(vv, a).reshape(-1)
                else:
                    res = (vv + _proj_pow_batch(-vv, a)).reshape(-1)
            elif kind == "ell1":
                res = _proj_ell1_batch(vals.reshape(count, param + 1)).reshape(-1)
            elif kind == "nuc":
                mm, nn = param
                res = _proj_nuc_batch(vals.reshape(count, mm * nn + 1), param).reshape(-1)
            elif kind == "sl":
                nn, kk = param
                res = _proj_sl_batch(
                    vals.reshape(count, sd_cone_size(nn) + 1), param
                ).reshape(-1)
            elif kind == "d":
                res = _proj_logdet_batch(
                    vals.reshape(count, sd_cone_size(param) + 2), param
                ).reshape(-1)
            else:  # pragma: no cover
                raise NotImplementedError(f"cone kind {kind}")
            out = out.at[idx].set(res)
        return out

    return proj


def make_dual_cone_projector(spec: ConeSpec, dtype=jnp.float64) -> Callable:
    """Pi_K*(z) = z + Pi_K(-z) (Moreau; gen_random_cone_prob.py:82-83)."""
    proj = make_cone_projector(spec, dtype)

    def proj_dual(z, bl=None, bu=None):
        return z + proj(-z, bl, bu)

    return proj_dual


# Bounded LRU (see solver._CORE_CACHE note): cap compiled-projector growth
# in long-running processes sweeping many cone structures.
_PROJECTOR_CACHE = {}
_PROJECTOR_CACHE_MAX = 64


def spec_signature(spec: ConeSpec):
    """Static structure key for a ConeSpec (box bounds enter dynamically)."""
    return (
        spec.z,
        spec.l,
        len(spec.bu),
        spec.q,
        spec.s,
        spec.cs,
        spec.ep,
        spec.ed,
        spec.p,
        spec.d,
        spec.nuc,
        spec.ell1,
        spec.sl,
    )


def get_projector(spec: ConeSpec, dtype=jnp.float64) -> Callable:
    """Cached projector keyed by cone structure (shared across instances)."""
    key = (spec_signature(spec), str(dtype))
    if key in _PROJECTOR_CACHE:
        _PROJECTOR_CACHE[key] = _PROJECTOR_CACHE.pop(key)  # refresh LRU
    else:
        while len(_PROJECTOR_CACHE) >= _PROJECTOR_CACHE_MAX:
            _PROJECTOR_CACHE.pop(next(iter(_PROJECTOR_CACHE)))
        _PROJECTOR_CACHE[key] = make_cone_projector(spec, dtype)
    return _PROJECTOR_CACHE[key]
