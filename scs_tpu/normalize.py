"""Data equilibration (Ruiz-style) — the on-device counterpart of the
reference's src/normalize.c + linsys/scs_matrix.c scaling.

Transform (self-consistent; derivation in solver.py docstring):
    A_hat = D A E            (D per-cone-block-uniform row scaling)
    P_hat = (sc_c / sc_b) * E P E
    b_hat = sc_b * D b
    c_hat = sc_c * E c
with sc_b = 1/max(||D b||, MIN_SCALE), sc_c = 1/max(||E c||, MIN_SCALE).

Un-normalization of a solution of the scaled problem (tau-normalized):
    x = E x_hat / sc_b
    y = D y_hat / sc_c
    s = D^-1 s_hat / sc_b

Rows of the zero ('z') and nonnegative ('l') cones scale per-row; box-cone
rows scale per-row with the bounds bu/bl adjusted accordingly; all other
cones scale uniformly per cone block (a nonuniform diagonal scaling would
change the cone).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .cones import ConeSpec

MIN_SCALE = 1e-8
NUM_RUIZ_PASSES = 10


def row_block_ids(spec: ConeSpec):
    """Map each row to a scaling block; -1 means per-row (free) scaling."""
    ids = np.full(spec.dim, -1, dtype=np.int64)
    next_id = 0
    for sg in spec.segments():
        if sg.kind in ("z", "l", "box"):
            continue  # per-row scaling allowed (box bounds get adjusted)
        ids[sg.offset : sg.offset + sg.length] = next_id
        next_id += 1
    return ids, next_id


@dataclasses.dataclass
class Scaling:
    D: np.ndarray  # (m,)
    E: np.ndarray  # (n,)
    sc_b: float
    sc_c: float


def ruiz_equilibrate(A, P, b, c, spec: ConeSpec, passes=NUM_RUIZ_PASSES):
    """Equilibrate dense A (m,n), optional dense P (n,n), b (m,), c (n,).

    Returns (A_hat, P_hat, b_hat, c_hat, Scaling, spec_hat) where spec_hat
    carries the adjusted box bounds for the normalized problem.
    """
    A = np.asarray(A, np.float64)
    m, n = A.shape
    D = np.ones(m)
    E = np.ones(n)
    ids, nblocks = row_block_ids(spec)
    has_blocks = nblocks > 0

    Ah = A.copy()
    Ph = None if P is None else np.asarray(P, np.float64).copy()

    for _ in range(passes):
        r = np.max(np.abs(Ah), axis=1)
        if has_blocks:
            # uniformize within cone blocks (max over the block)
            blk_max = np.zeros(nblocks)
            np.maximum.at(blk_max, ids[ids >= 0], r[ids >= 0])
            r = np.where(ids >= 0, blk_max[np.clip(ids, 0, None)], r)
        # all-zero rows/cols must keep scale 1 (a zero row would otherwise
        # blow its scale up by 1/sqrt(MIN_SCALE) every pass)
        r = np.where(r <= MIN_SCALE, 1.0, r)
        r = np.sqrt(r)
        cn = np.max(np.abs(Ah), axis=0)
        if Ph is not None:
            cn = np.maximum(cn, np.max(np.abs(Ph), axis=0))
        cn = np.where(cn <= MIN_SCALE, 1.0, cn)
        cn = np.sqrt(cn)
        Ah /= r[:, None]
        Ah /= cn[None, :]
        if Ph is not None:
            Ph /= cn[:, None]
            Ph /= cn[None, :]
        D /= r
        E /= cn

    bh = D * np.asarray(b, np.float64)
    ch = E * np.asarray(c, np.float64)
    sc_b = 1.0 / max(float(np.linalg.norm(bh)), MIN_SCALE)
    sc_c = 1.0 / max(float(np.linalg.norm(ch)), MIN_SCALE)
    bh *= sc_b
    ch *= sc_c
    if Ph is not None:
        Ph *= sc_c / sc_b

    # adjust box bounds: s'_i = d_i s_i, t' = d_t t  =>  bu' = bu * d_i / d_t
    spec_hat = spec
    if spec.bsize > 0:
        off = spec.z + spec.l
        d_t = D[off]
        d_s = D[off + 1 : off + spec.bsize]
        bu_hat = spec.bu * d_s / d_t
        bl_hat = spec.bl * d_s / d_t
        spec_hat = dataclasses.replace(spec, bu=bu_hat, bl=bl_hat)

    return Ah, Ph, bh, ch, Scaling(D=D, E=E, sc_b=sc_b, sc_c=sc_c), spec_hat


def identity_scaling(m, n):
    return Scaling(D=np.ones(m), E=np.ones(n), sc_b=1.0, sc_c=1.0)


def ruiz_equilibrate_sparse(A, P, b, c, spec: ConeSpec, passes=NUM_RUIZ_PASSES):
    """Sparse-aware Ruiz equilibration: same math as `ruiz_equilibrate`,
    O(nnz) per pass, never materializing a dense (m, n) array — the
    preprocessing path for the block-ELL ("bell") strategy, whose whole
    point is that dense A fits neither device nor host at scale.

    A: scipy CSC (m, n). P: scipy CSC (n, n) FULL symmetric (not triu) or
    None. Returns (A_hat csc, P_hat csc|None, b_hat, c_hat, Scaling,
    spec_hat).
    """
    from scipy import sparse as sp

    A = sp.csc_matrix(A, copy=True)
    m, n = A.shape
    D = np.ones(m)
    E = np.ones(n)
    ids, nblocks = row_block_ids(spec)
    has_blocks = nblocks > 0

    Ah = A
    Ph = None if P is None else sp.csc_matrix(P, copy=True)

    def col_max_abs(M):
        Mab = np.abs(M.data)
        out = np.zeros(M.shape[1])
        np.maximum.at(out, np.repeat(np.arange(M.shape[1]), np.diff(M.indptr)), Mab)
        return out

    for _ in range(passes):
        r = np.zeros(m)
        np.maximum.at(r, Ah.indices, np.abs(Ah.data))
        if has_blocks:
            blk_max = np.zeros(nblocks)
            np.maximum.at(blk_max, ids[ids >= 0], r[ids >= 0])
            r = np.where(ids >= 0, blk_max[np.clip(ids, 0, None)], r)
        r = np.where(r <= MIN_SCALE, 1.0, r)
        r = np.sqrt(r)
        cn = col_max_abs(Ah)
        if Ph is not None:
            cn = np.maximum(cn, col_max_abs(Ph))
        cn = np.where(cn <= MIN_SCALE, 1.0, cn)
        cn = np.sqrt(cn)
        # scale in place on the CSC data arrays: A <- D_r^-1 A E_c^-1
        col_of = np.repeat(np.arange(n), np.diff(Ah.indptr))
        Ah.data /= r[Ah.indices]
        Ah.data /= cn[col_of]
        if Ph is not None:
            pcol = np.repeat(np.arange(n), np.diff(Ph.indptr))
            Ph.data /= cn[Ph.indices]
            Ph.data /= cn[pcol]
        D /= r
        E /= cn

    bh = D * np.asarray(b, np.float64)
    ch = E * np.asarray(c, np.float64)
    sc_b = 1.0 / max(float(np.linalg.norm(bh)), MIN_SCALE)
    sc_c = 1.0 / max(float(np.linalg.norm(ch)), MIN_SCALE)
    bh *= sc_b
    ch *= sc_c
    if Ph is not None:
        Ph.data *= sc_c / sc_b

    spec_hat = spec
    if spec.bsize > 0:
        off = spec.z + spec.l
        d_t = D[off]
        d_s = D[off + 1 : off + spec.bsize]
        spec_hat = dataclasses.replace(
            spec, bu=spec.bu * d_s / d_t, bl=spec.bl * d_s / d_t
        )

    return Ah, Ph, bh, ch, Scaling(D=D, E=E, sc_b=sc_b, sc_c=sc_c), spec_hat


# ---------------------------------------------------------------------------
# On-device (jnp) equilibration — used by the batched and sharded paths.
# ---------------------------------------------------------------------------


def ruiz_equilibrate_jnp(
    A,
    P,
    b,
    c,
    *,
    ids,
    nblocks: int,
    box_off: int,
    bsize: int,
    bl,
    bu,
    passes: int = NUM_RUIZ_PASSES,
):
    """Pure-jnp Ruiz equilibration of ONE problem; `jax.vmap` it for a batch.

    Device-side counterpart of `ruiz_equilibrate` (same math): at batch
    1000 the host numpy version is thousands of dense (m, n) passes of
    setup before the device sees anything — here the whole equilibration
    is one fused XLA program riding HBM bandwidth.

    Parameters
    ----------
    A: (m, n) array. P: (n, n) array or None. b: (m,), c: (n,).
    ids: (m,) int32 cone-block ids (-1 = per-row scaling) — from
        `row_block_ids`, converted to an array (static per cone structure).
    nblocks, box_off, bsize: static ints from the ConeSpec.
    bl, bu: (bsize-1,) box bounds (finite entries scaled; +-inf preserved).

    Returns (A_hat, P_hat, b_hat, c_hat, D, E, sc_b, sc_c, bl_hat, bu_hat);
    P_hat is None when P is None, bl_hat/bu_hat are zero-length when there
    is no box cone.
    """
    import jax
    import jax.numpy as jnp

    has_P = P is not None
    dtype = A.dtype
    m, n = A.shape
    ids = jnp.asarray(ids, jnp.int32)
    has_blocks = nblocks > 0
    neg_inf = jnp.asarray(-jnp.inf, dtype)

    def one_pass(carry, _):
        Ah, Ph, D, E = carry
        r = jnp.max(jnp.abs(Ah), axis=1)
        if has_blocks:
            seg_in = jnp.where(ids >= 0, r, neg_inf)
            blk_max = jax.ops.segment_max(
                seg_in, jnp.clip(ids, 0, None), num_segments=nblocks
            )
            r = jnp.where(ids >= 0, blk_max[jnp.clip(ids, 0, None)], r)
        r = jnp.where(r <= MIN_SCALE, 1.0, r)
        r = jnp.sqrt(r)
        cn = jnp.max(jnp.abs(Ah), axis=0)
        if has_P:
            cn = jnp.maximum(cn, jnp.max(jnp.abs(Ph), axis=0))
        cn = jnp.where(cn <= MIN_SCALE, 1.0, cn)
        cn = jnp.sqrt(cn)
        Ah = Ah / r[:, None] / cn[None, :]
        if has_P:
            Ph = Ph / cn[:, None] / cn[None, :]
        return (Ah, Ph, D / r, E / cn), None

    P0 = P if has_P else jnp.zeros((0, 0), dtype)
    (Ah, Ph, D, E), _ = jax.lax.scan(
        one_pass,
        (A, P0, jnp.ones(m, dtype), jnp.ones(n, dtype)),
        None,
        length=passes,
    )

    bh = D * b
    ch = E * c
    sc_b = 1.0 / jnp.maximum(jnp.linalg.norm(bh), MIN_SCALE)
    sc_c = 1.0 / jnp.maximum(jnp.linalg.norm(ch), MIN_SCALE)
    bh = bh * sc_b
    ch = ch * sc_c
    if has_P:
        Ph = Ph * (sc_c / sc_b)
    else:
        Ph = None

    if bsize > 0:
        d_t = D[box_off]
        d_s = jax.lax.dynamic_slice(D, (box_off + 1,), (bsize - 1,))
        bu_hat = jnp.asarray(bu, dtype) * d_s / d_t
        bl_hat = jnp.asarray(bl, dtype) * d_s / d_t
    else:
        bu_hat = jnp.zeros(0, dtype)
        bl_hat = jnp.zeros(0, dtype)

    return Ah, Ph, bh, ch, D, E, sc_b, sc_c, bl_hat, bu_hat
