"""Compensated f32 linear algebra for high-accuracy solves in f32.

eps<=1e-6 work in f32 needs arithmetic whose ERROR is tracked and
corrected (the f32 solve path; native f64 is the other route, and which
one an H100 cell favours is ROADMAP design item 3). The technique is Dekker splitting: each
f32 product a*b is written as p + err with p = fl(a*b) and err exact
(computable in f32 without FMA by splitting both operands into 12-bit
halves). Summing the p-stream and err-stream separately with XLA's tree
reductions leaves ~1-ulp (~1e-7 relative) total error independent of the
product rounding — versus ~n-dependent error for the plain matvec.

Used by the solver for residual evaluation and iterative-refinement
residuals when tolerances are tighter than f32 matvecs can certify
(Core.hi_acc; VERDICT r4 item 5). Bandwidth cost is identical to the
plain matvec (same reads); compute is ~8x, irrelevant at check
frequency.

Reference for the algorithms: Dekker (1971) / Ogita-Rump-Oishi error-free
transformations — public-domain numerics, no reference-repo counterpart
(the reference solver is natively f64, scs/scsobject.h scs_float).
"""

from __future__ import annotations

import jax.numpy as jnp

_SPLIT = 4097.0  # 2^12 + 1 for float32 (24-bit significand)


def _split(a):
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    """p + err == a*b exactly (barring overflow in the split)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def mv(M, v):
    """Compensated M @ v for M (r, c), v (c,): ~1-ulp f32 result."""
    p, err = _two_prod(M, v[None, :])
    return jnp.sum(p, axis=1) + jnp.sum(err, axis=1)


def tv(M, u):
    """Compensated M.T @ u for M (r, c), u (r,)."""
    p, err = _two_prod(M, u[:, None])
    return jnp.sum(p, axis=0) + jnp.sum(err, axis=0)


def dot(a, b):
    """Compensated dot(a, b) for 1-D a, b."""
    p, err = _two_prod(a, b)
    return jnp.sum(p) + jnp.sum(err)
