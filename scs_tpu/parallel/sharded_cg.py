"""Row-block-sharded conjugate gradient across devices — the replacement
for the reference's multithreaded sparse solves on a SINGLE giant problem
(SURVEY.md §2.4: row-block-sharded A with psum-based CG replaces
multithreaded Pardiso).

Layout: A is sharded (m_local, n) per device along a 'rows' mesh axis;
x, rhs, and P are replicated. One CG step:

    q = A @ x                 # local rows, no communication
    t = A.T @ (dy_local * q)  # local partial (n,), then psum over 'rows'
    Sx = rho_x*x + P@x + psum(t)

so each CG iteration costs exactly one psum of an (n,) vector (an
all-reduce that XLA hands to NCCL on GPUs).
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..solver import _hp


def sharded_normal_matvec(A_local, P_mat, dy_local, rho_x, x, axis_name):
    """S x with S = rho_x*I + P + A' diag(dy) A, A row-sharded."""
    q = A_local @ x
    t = A_local.T @ (dy_local * q)
    t = lax.psum(t, axis_name)
    out = rho_x * x + t
    if P_mat is not None:
        out = out + P_mat @ x
    return out


def _cg_body(matvec, Minv, carry):
    x, r, p, rz, k = carry
    Ap = matvec(p)
    alpha = rz / jnp.dot(p, Ap)
    x = x + alpha * p
    r = r - alpha * Ap
    z = Minv * r
    rz_new = jnp.dot(r, z)
    beta = rz_new / rz
    p = z + beta * p
    return x, r, p, rz_new, k + 1


def sharded_cg_solve(
    A,
    dy,
    rhs,
    mesh,
    *,
    P_mat=None,
    rho_x=1e-6,
    tol=1e-9,
    max_iters=500,
    axis_name="rows",
):
    """Solve (rho_x*I + P + A' diag(dy) A) x = rhs with A row-sharded.

    A: (m, n) array (host or device); sharded over `axis_name` rows.
    dy: (m,) row weights, sharded alongside A. rhs: (n,) replicated.
    Returns (x, n_iters).
    """
    n_dev = mesh.shape[axis_name]
    m, n = A.shape
    if m % n_dev != 0:
        pad = n_dev - m % n_dev
        A = jnp.concatenate([A, jnp.zeros((pad, n), A.dtype)])
        dy = jnp.concatenate([dy, jnp.zeros((pad,), dy.dtype)])
        m = m + pad

    row_sharding = NamedSharding(mesh, P(axis_name))
    rep = NamedSharding(mesh, P())
    A = jax.device_put(A, row_sharding)
    dy = jax.device_put(dy, row_sharding)
    rhs = jax.device_put(rhs, rep)
    if P_mat is not None:
        P_mat = jax.device_put(P_mat, rep)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P()) + ((P(),) if P_mat is not None else ()),
        out_specs=(P(), P()),
    )
    def run(A_local, dy_local, rhs_rep, *maybe_P):
        Pm = maybe_P[0] if maybe_P else None

        def matvec(x):
            return sharded_normal_matvec(
                A_local, Pm, dy_local, rho_x, x, axis_name
            )

        # Jacobi preconditioner: diag(S) = rho_x + diag(P) + sum_i dy_i A_i^2
        diag_local = jnp.sum(A_local * A_local * dy_local[:, None], axis=0)
        diagS = rho_x + lax.psum(diag_local, axis_name)
        if Pm is not None:
            diagS = diagS + jnp.diagonal(Pm)
        Minv = 1.0 / diagS

        x0 = jnp.zeros_like(rhs_rep)
        r = rhs_rep - matvec(x0)
        z = Minv * r
        p = z
        rz = jnp.dot(r, z)

        def cond(carry):
            x, r, p, rz, k = carry
            return (jnp.linalg.norm(r) > tol) & (k < max_iters)

        x, r, p, rz, k = lax.while_loop(
            cond,
            lambda c: _cg_body(matvec, Minv, c),
            (x0, r, p, rz, jnp.int32(0)),
        )
        return x, k

    args = (A, dy, rhs) + ((P_mat,) if P_mat is not None else ())
    with mesh:
        x, k = jax.jit(_hp(run))(*args)
    return x, int(k)
