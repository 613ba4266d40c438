"""Active-set solution polishing — high accuracy WITHOUT the f32 tail.

At eps <= 1e-6 the DR iteration's last decade crawls along the f32
iterate-quantization floor (~13k iterations vs the reference f64's 225,
measured). Polishing sidesteps the crawl: converge fast at the default
eps=1e-4 (~200 iterations), read off the active set, and solve the
equality-constrained KKT system DIRECTLY — one batched factorization +
compensated-refinement passes (ops/df32.py) reach ~f32-ulp KKT residuals
in milliseconds. The result is verified (compensated residuals + sign
conditions) and the un-polished solution is kept when verification
fails, so polishing can only improve a solution, never corrupt one.

This is a capability the REFERENCE DOES NOT HAVE (it iterates to high
eps in f64); the technique is the classic OSQP-style polish (Stellato et
al. 2017, §5.2 — public method, no reference-repo counterpart), adapted
to static shapes via an active-row MASK so it vmaps over problem
batches:

    active d_i = 1 for zero-cone rows and nonneg rows with y_i > s_i
    minimize 0.5 x'Px + c'x  s.t.  (Ax - b)_i = 0 for active i

    KKT:  P x + A' D lam = -c,   D A x = D b      (D = diag(d))
    range-space solve with static regularization eps_reg (QDLDL-style):
      Pt = P + eps_reg I,  W = Pt^-1 A',  G = A W
      M  = D G D + eps_reg I + (1 - d) I           (inactive lam -> 0)
      lam = M^-1 (D A Pt^-1 (-c) - D b),  x = Pt^-1 (-c - A' D lam)
    then iterative refinement against the TRUE (unregularized) KKT with
    compensated residuals, reusing the two Cholesky factors.

Supported cones: zero + nonneg (the flagship family). Other cones fall
back to the unpolished solution.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .ops import df32


def _polish_one(A, P, b, c, d, eps_reg, refine, zero_mask):
    """Single-problem polish (vmappable). `d` is the active-row mask
    (computed by the caller from the ORIGINAL-unit y vs s comparison —
    the normalized-space magnitudes are row-rescaled and would bias the
    complementarity test). Returns (x, y, s, lam_ok)."""
    m, n = A.shape

    idx_n = jnp.arange(n)
    idx_m = jnp.arange(m)
    P0 = P if P.size else jnp.zeros((n, n), A.dtype)
    # scale-aware static regularization (relative to the operator
    # magnitudes, with an absolute floor): f32 Cholesky needs
    # cond(Pt), cond(M) well under ~1e7
    regP = eps_reg * (1.0 + jnp.trace(P0) / n)
    Pt = P0.at[idx_n, idx_n].add(regP)
    cholP = jnp.linalg.cholesky(Pt)

    def p_solve(r):
        return jax.scipy.linalg.cho_solve((cholP, True), r)

    # W = Pt^-1 A' (n, m);  G = A W (m, m) — mask-independent, computed
    # once and reused by the active-set repair round
    W = jax.scipy.linalg.cho_solve((cholP, True), A.T)
    G = A @ W

    regM = eps_reg * (1.0 + jnp.trace(G) / m)

    def solve_with_mask(d):
        M = (d[:, None] * G * d[None, :]).at[idx_m, idx_m].add(
            regM + (1.0 - d)
        )
        cholM = jnp.linalg.cholesky(M)

        def kkt_solve(r1, r2):
            """Regularized masked KKT solve for (dx, dlam) given
            residuals r1 (n,) of the x-row and r2 (m,) of the lam-row."""
            t = A @ p_solve(r1)
            lam = jax.scipy.linalg.cho_solve((cholM, True), d * t - r2)
            x = p_solve(r1 - A.T @ (d * lam))
            return x, lam

        # initial solve: lam = M^-1(D A Pt^-1(-c) - D b), i.e. the
        # lam-row residual convention is r2 = D b (kkt_solve computes
        # d*t - r2 with t = A Pt^-1 r1) — matching the refinement calls,
        # which pass -r2 = d*(b - Ax). (ADVICE r4: the sign-flipped
        # -(d*b) solved D A x = -D b and burned a refinement pass
        # correcting a self-inflicted O(1) error.)
        x, lam = kkt_solve(-c, d * b)

        # refinement against the TRUE KKT (P, not Pt; exact mask), with
        # compensated residuals so the correction targets ~1-ulp.
        # fori_loop, not a Python unroll: this body is traced inside the
        # repair while_loop, and unrolled refinement tripled the trace /
        # compile size of the whole polish program (~15 s of host time
        # per process at the flagship shapes, measured r5)
        def refine_body(_, xl):
            x, lam = xl
            Px = df32.mv(P, x) if P.size else jnp.zeros_like(x)
            r1 = -c - Px - df32.tv(A, d * lam)
            r2 = d * (df32.mv(A, x) - b)
            dx, dlam = kkt_solve(r1, -r2)
            return (x + dx, lam + dlam)

        x, lam = jax.lax.fori_loop(0, refine, refine_body, (x, lam))
        s_raw = b - df32.mv(A, x)
        return x, lam, s_raw

    def viols(d, lam, s_raw):
        """Beyond-noise active-set violations: active rows with clearly
        negative multipliers (release) and inactive rows with clearly
        negative slacks (bind). 1e-6 relative = one decade below the
        acceptance tolerance (1e-5): the loop repairs well past the
        verification bar but cannot chatter on the f32 solve noise
        (measured ~3e-7 relative)."""
        # scale by the RMS magnitude, not the max: the flip decision is
        # per-row and the KKT damage of leaving a wrong row is absolute
        # (~||A_j|| * |lam_j|), so one large multiplier must not loosen
        # the tolerance for every other row
        tol_l = 1e-6 * (1.0 + jnp.sqrt(jnp.mean(lam * lam)))
        tol_s = 1e-6 * (1.0 + jnp.sqrt(jnp.mean(s_raw * s_raw)))
        rel = (d > 0.5) & ~zero_mask & (lam < -tol_l)
        bind = (d < 0.5) & (s_raw < -tol_s)
        return rel, bind

    # active-set REPAIR rounds: a borderline eps=1e-4 iterate can
    # misclassify rows; violations tell us exactly which way to flip.
    # The cascade converges but can need ~6-8 rounds on degenerate
    # problems (measured: 74 mis-bound rows decay ~2x per round), so run
    # under lax.while_loop with an early exit instead of a fixed unroll.
    # The INITIAL solve is folded into the loop as round k=0 (the flip
    # masks are gated on k > 0), so solve_with_mask is traced exactly
    # ONCE in the whole program — the duplicate trace was half the
    # polish program's compile cost.
    def cond(carry):
        d, x, lam, s_raw, k = carry
        rel, bind = viols(d, lam, s_raw)
        return (k == 0) | ((k < 25) & (jnp.any(rel) | jnp.any(bind)))

    def body(carry):
        d, x, lam, s_raw, k = carry
        # flip on the RAW sign (not the noise tolerance): the fine flips
        # are what drive the final iterate to the exact active set; only
        # the LOOP EXIT uses the tolerance, so noise-level stragglers
        # cannot spin the loop but clear violations keep repairing
        live = k > 0
        rel = live & (d > 0.5) & ~zero_mask & (lam < 0.0)
        bind = live & (d < 0.5) & (s_raw < 0.0)
        d = jnp.where(
            zero_mask, 1.0, jnp.where(rel, 0.0, jnp.where(bind, 1.0, d))
        )
        x, lam, s_raw = solve_with_mask(d)
        return d, x, lam, s_raw, k + 1

    zeros_m = jnp.zeros(m, A.dtype)
    d, x, lam, s_raw, _ = jax.lax.while_loop(
        cond,
        body,
        (d, jnp.zeros(n, A.dtype), zeros_m, zeros_m, jnp.int32(0)),
    )

    # no blanket clamp into the cone: zeroing every noise-level negative
    # multiplier (~1e-6 relative each, across ~m/2 active rows) adds a
    # measurable ||A' dy|| ~ 1e-5 to the dual residual — worse than the
    # <=1e-6-noise cone violation it removes. The DR reference returns
    # slightly-infeasible duals too; exact membership is not an invariant.
    y_pol = d * lam
    s_pol = jnp.where(zero_mask, 0.0, (1.0 - d) * s_raw)
    # dual feasibility of the polished point: multipliers on active
    # NONNEG rows must be >= 0 (zero-cone duals are free); primal
    # feasibility of inactive rows: slack >= 0
    # sign tolerances scale with the iterate magnitudes (f32 noise of
    # the solve is relative, not absolute)
    tol_l = 1e-5 * (1.0 + jnp.max(jnp.abs(lam)))
    tol_s = 1e-5 * (1.0 + jnp.max(jnp.abs(s_raw)))
    lam_ok = jnp.all(
        jnp.where(zero_mask | (d < 0.5), True, lam >= -tol_l)
    ) & jnp.all(jnp.where(d > 0.5, True, s_raw >= -tol_s))
    return x, y_pol, s_pol, lam_ok


import functools


@functools.lru_cache(maxsize=16)
def _polish_jit(eps_reg, refine, zero_mask_bytes, m):
    """Jitted batched polish program, cached per (eps_reg, refine,
    zero_mask). MUST be jitted: an un-jitted vmap executes op-by-op,
    one dispatch per op."""
    zero_mask = np.frombuffer(zero_mask_bytes, dtype=bool)[:m]

    def fn(A, P, b, c, d):
        with jax.default_matmul_precision("highest"):
            return jax.vmap(
                lambda A1, P1, b1, c1, d1: _polish_one(
                    A1, P1, b1, c1, d1, eps_reg, refine, zero_mask
                )
            )(A, P, b, c, d)

    return jax.jit(fn)


def polish_batch(A, P, b, c, d, zero_mask, *, eps_reg=1e-6, refine=3):
    """Batched polish: A (B,m,n), P (B,n,n) or (B,0,0), b (B,m), c
    (B,n), d (B,m) active masks, zero_mask (m,) bool. Returns
    (x, y, s, lam_ok) batched."""
    zm = np.ascontiguousarray(np.asarray(zero_mask, bool))
    fn = _polish_jit(float(eps_reg), int(refine), zm.tobytes(), zm.size)
    return fn(A, P, b, c, d)


def kkt_errors(A, P, b, c, x, y, s, wr=None, wc=None):
    """Compensated-f32 KKT residual norms per problem (B,): primal
    ||wr * (Ax + s - b)||, dual ||wc * (Px + A'y + c)||, |comp slack|.

    wr (B, m) / wc (B, n) are optional per-row weights. Passing the
    inverse equilibration (1/(D*sc_b), 1/(E*sc_c)) yields the EXACT
    original-unit residual norms of hat-space iterates — tighter than
    the max-row-scale bound previously used in BatchedSCS.polish, which
    overstated residuals by up to max(D)/min(D)."""

    def one(A1, P1, b1, c1, x1, y1, s1, wr1, wc1):
        rp = (df32.mv(A1, x1) + s1 - b1) * wr1
        Px = df32.mv(P1, x1) if P1.size else jnp.zeros_like(x1)
        rd = (Px + df32.tv(A1, y1) + c1) * wc1
        return (
            jnp.linalg.norm(rp),
            jnp.linalg.norm(rd),
            jnp.abs(df32.dot(s1, y1)),
        )

    if wr is None:
        wr = jnp.ones(b.shape, A.dtype)
    if wc is None:
        wc = jnp.ones(c.shape, A.dtype)

    def fn(A, P, b, c, x, y, s, wr, wc):
        with jax.default_matmul_precision("highest"):
            return jax.vmap(one)(A, P, b, c, x, y, s, wr, wc)

    # jitted for the same reason as polish_batch: no op-by-op dispatch
    return jax.jit(fn)(A, P, b, c, x, y, s, wr, wc)
