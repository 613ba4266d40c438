"""Block-ELL sparse matrix-vector product — the sparse layout behind the
large-problem indirect strategy.

The reference's indirect backend does CSC SpMV on the CPU
(scs_source/linsys/cpu/indirect/private.c over scs_matrix.c). Here the
matrix is cut into (bs x bs) dense tiles, and each block-row stores a
fixed number (`width`) of nonzero tiles plus their block-column ids.
SpMV then becomes a gather of `width` x tiles per block-row followed by
`width` dense (bs x bs) @ (bs,) products — static shapes that XLA
compiles to a gather and a batched dot.

Host-side packing is done by the native C++ runtime
(native.pack_block_ell); this module provides:

  * bell_spmv_ref   — the SpMV in plain jnp (every backend and dtype; the
                      one implementation the solver uses, and the
                      reference; a hand-written Triton version measured
                      no faster end to end on the H100, see PERF.md)
  * BellMatrix      — packed (A, A^T) pair with .mv / .rmv
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax.numpy as jnp


def bell_spmv_ref(blocks, cols, x_pad):
    """Block-ELL SpMV: y (nbr*bs,) = A @ x.

    blocks: (nbr, width, bs, bs) storing each tile TRANSPOSED
    (blocks[r, w, j, i] = A_tile[i, j]); cols: (nbr, width) int32;
    x_pad: (nbc*bs,) zero-padded input.
    """
    nbr, width, bs, _ = blocks.shape
    xb = x_pad.reshape(-1, bs)  # (nbc, bs)
    gathered = xb[cols]  # (nbr, width, bs)
    y = jnp.einsum(
        "rwji,rwj->ri", blocks, gathered,
        preferred_element_type=blocks.dtype,
    )
    return y.reshape(nbr * bs)


class BellMatrix(NamedTuple):
    """Packed block-ELL representation of A and A^T (the pre-transposed
    A^T mirrors the reference GPU backend's gpu_atrans option,
    meson.build:291-293)."""

    m: int
    n: int
    bs: int
    A_blocks: jnp.ndarray  # (nbr, wA, bs, bs)
    A_cols: jnp.ndarray  # (nbr, wA)
    At_blocks: jnp.ndarray  # (nbc, wAt, bs, bs)
    At_cols: jnp.ndarray  # (nbc, wAt)
    col_sq: jnp.ndarray  # (n,) sum_i A_ij^2  (Jacobi preconditioner data)
    row_sq: jnp.ndarray  # (m,) sum_j A_ij^2

    @property
    def m_pad(self):
        return self.A_blocks.shape[0] * self.bs

    @property
    def n_pad(self):
        return self.At_blocks.shape[0] * self.bs

    def mv(self, x):
        """A @ x for x of length n (returns length m)."""
        x_pad = jnp.zeros(self.n_pad, self.A_blocks.dtype).at[: self.n].set(x)
        return bell_spmv_ref(self.A_blocks, self.A_cols, x_pad)[: self.m]

    def rmv(self, y):
        """A^T @ y for y of length m (returns length n)."""
        y_pad = jnp.zeros(self.m_pad, self.At_blocks.dtype).at[: self.m].set(y)
        return bell_spmv_ref(self.At_blocks, self.At_cols, y_pad)[: self.n]


def pack_bell_host(A_csc, block_size=128, np_dtype=np.float32):
    """Host-side block-ELL pack of (A, A^T): NUMPY arrays only, no device
    upload. The batched bell path stacks B of these before one H2D
    transfer instead of fetching per-problem device arrays back.

    Returns (A_blocks, A_cols, At_blocks, At_cols, col_sq, row_sq).
    """
    from scipy import sparse as sp  # noqa: PLC0415

    from .. import native  # noqa: PLC0415

    A_csc = sp.csc_matrix(A_csc)
    A_csc.sort_indices()
    At_csc = sp.csc_matrix(A_csc.T)
    At_csc.sort_indices()

    def pack(M):
        if native.available:
            blocks, cols = native.pack_block_ell(M, block_size)
        else:
            blocks, cols = _pack_bell_numpy(M, block_size)
        # store tiles transposed (the layout bell_spmv_ref contracts)
        return (
            np.ascontiguousarray(
                blocks.transpose(0, 1, 3, 2), dtype=np_dtype
            ),
            np.asarray(cols, np.int32),
        )

    A_blocks, A_cols = pack(A_csc)
    At_blocks, At_cols = pack(At_csc)
    d = np.asarray(A_csc.multiply(A_csc).sum(axis=0), np_dtype).ravel()
    r = np.asarray(A_csc.multiply(A_csc).sum(axis=1), np_dtype).ravel()
    return A_blocks, A_cols, At_blocks, At_cols, d, r


def pack_bell(A_csc, block_size=128, dtype=jnp.float32):
    """Pack a scipy CSC matrix into a BellMatrix (A and A^T).

    Uses the native C++ packer when available, else a numpy fallback.
    """
    m, n = A_csc.shape
    np_dtype = np.float64 if dtype == jnp.float64 else np.float32
    A_blocks, A_cols, At_blocks, At_cols, d, r = pack_bell_host(
        A_csc, block_size, np_dtype
    )
    return BellMatrix(
        m=m,
        n=n,
        bs=block_size,
        A_blocks=jnp.asarray(A_blocks, dtype),
        A_cols=jnp.asarray(A_cols, jnp.int32),
        At_blocks=jnp.asarray(At_blocks, dtype),
        At_cols=jnp.asarray(At_cols, jnp.int32),
        col_sq=jnp.asarray(d, dtype),
        row_sq=jnp.asarray(r, dtype),
    )


def pack_bell_sym_host(P_csc, block_size=128, np_dtype=np.float32):
    """Host-side symmetric pack: numpy (blocks, cols, diag), no upload."""
    from scipy import sparse as sp  # noqa: PLC0415

    from .. import native  # noqa: PLC0415

    P_csc = sp.csc_matrix(P_csc)
    P_csc.sort_indices()
    if native.available:
        blocks, cols = native.pack_block_ell(P_csc, block_size)
    else:
        blocks, cols = _pack_bell_numpy(P_csc, block_size)
    blocks = np.ascontiguousarray(
        blocks.transpose(0, 1, 3, 2), dtype=np_dtype
    )
    return (
        blocks,
        np.asarray(cols, np.int32),
        np.asarray(P_csc.diagonal(), np_dtype),
    )


def pack_bell_sym(P_csc, block_size=128, dtype=jnp.float32):
    """Pack a symmetric sparse matrix (full P, not triu) into a one-sided
    block-ELL operator (solver.PBell): symmetry means a single pack serves
    P @ x in both orientations; diag(P) is extracted for the Jacobi
    preconditioner (solver._diagS)."""
    from ..solver import PBell  # noqa: PLC0415

    np_dtype = np.float64 if dtype == jnp.float64 else np.float32
    blocks, cols, diag = pack_bell_sym_host(P_csc, block_size, np_dtype)
    return PBell(
        blocks=jnp.asarray(blocks, dtype),
        cols=jnp.asarray(cols, jnp.int32),
        diag=jnp.asarray(diag, dtype),
    )


def pack_bell_sharded(A_csc, n_dev, block_size=128, dtype=jnp.float32):
    """Per-device block-ELL packs of (A, A^T) for a ROW-sharded operator
    (SURVEY §2.4: row-block-sharded A across devices).

    The m rows (must be a multiple of n_dev*block_size — callers pre-pad
    with zero-cone rows) are split contiguously into n_dev groups; device
    d gets the pack of its row slice A_d AND the pack of A_d^T, so that

        A @ x    = all_gather_d(A_d @ x)          (x replicated)
        A^T @ y  = psum_d(A_d^T @ y_d)            (y_d = local rows)

    — one (n,)-psum / (m,)-all-gather per matvec between devices.
    Per-device widths are padded to the maximum across devices (padding
    slots have zero tiles pointing at block 0 — harmless), and all arrays
    are stacked with a leading n_dev axis for shard_map.

    Returns (A_blocks, A_cols, At_blocks, At_cols, colsq_all) with
    shapes (n_dev, nbr_loc, wA, bs, bs), (n_dev, nbr_loc, wA),
    (n_dev, nbc, wAt, bs, bs), (n_dev, nbc, wAt), (n,).
    """
    from scipy import sparse as sp  # noqa: PLC0415

    m, n = A_csc.shape
    if m % (n_dev * block_size) != 0:
        raise ValueError(
            f"sharded bell pack requires m ({m}) to be a multiple of "
            f"n_dev*block_size ({n_dev * block_size}); pad rows first"
        )
    m_loc = m // n_dev
    A_csc = sp.csc_matrix(A_csc)
    packs = [
        pack_bell(
            A_csc[d * m_loc : (d + 1) * m_loc], block_size, dtype
        )
        for d in range(n_dev)
    ]

    def stack_padded(blocks_list, cols_list):
        w = max(b.shape[1] for b in blocks_list)
        outs_b, outs_c = [], []
        for b, c in zip(blocks_list, cols_list):
            pad = w - b.shape[1]
            if pad:
                b = np.concatenate(
                    [np.asarray(b), np.zeros(
                        (b.shape[0], pad) + b.shape[2:], np.asarray(b).dtype
                    )],
                    axis=1,
                )
                c = np.concatenate(
                    [np.asarray(c), np.zeros((c.shape[0], pad), np.int32)],
                    axis=1,
                )
            outs_b.append(np.asarray(b))
            outs_c.append(np.asarray(c))
        return jnp.asarray(np.stack(outs_b), dtype), jnp.asarray(
            np.stack(outs_c), jnp.int32
        )

    A_blocks, A_cols = stack_padded(
        [p.A_blocks for p in packs], [p.A_cols for p in packs]
    )
    At_blocks, At_cols = stack_padded(
        [p.At_blocks for p in packs], [p.At_cols for p in packs]
    )
    colsq_all = jnp.sum(
        jnp.stack([jnp.asarray(p.col_sq, dtype) for p in packs]), axis=0
    )
    return A_blocks, A_cols, At_blocks, At_cols, colsq_all


def pack_bell_sym_sharded(P_csc, n_dev, block_size=128, dtype=jnp.float32):
    """Per-device block-ELL packs of the symmetric quadratic-cost matrix
    P for a ROW-sharded operator (VERDICT r4 item 7): device d holds the
    pack of its contiguous row slice P_d of the row-zero-padded P, so

        P @ x = all_gather_d(P_d @ x)[:n]        (x replicated)

    — the same communication pattern as the sharded A @ x (one tiled
    all-gather between devices; symmetry means no second pack or
    psum is needed for the transpose orientation). Rows are zero-padded
    to a multiple of n_dev*block_size (padding rows are all-zero tiles —
    the gathered result is sliced back to n by the caller).

    Returns a solver.PBell with leading n_dev axes on blocks/cols
    ((n_dev, nbr_loc, w, bs, bs), (n_dev, nbr_loc, w)) and a replicated
    (n,) diag.
    """
    from scipy import sparse as sp  # noqa: PLC0415

    from ..solver import PBell  # noqa: PLC0415

    P_csc = sp.csc_matrix(P_csc)
    n = P_csc.shape[0]
    pad = (-n) % (n_dev * block_size)
    if pad:
        P_csc = sp.vstack(
            [P_csc.tocsr(), sp.csr_matrix((pad, n))]
        ).tocsc()
    n_rows = n + pad
    n_loc = n_rows // n_dev
    P_csr = P_csc.tocsr()
    packs = [
        pack_bell(
            P_csr[d * n_loc : (d + 1) * n_loc].tocsc(), block_size, dtype
        )
        for d in range(n_dev)
    ]

    w = max(p.A_blocks.shape[1] for p in packs)
    outs_b, outs_c = [], []
    for p in packs:
        b_, c_ = np.asarray(p.A_blocks), np.asarray(p.A_cols)
        padw = w - b_.shape[1]
        if padw:
            b_ = np.concatenate(
                [b_, np.zeros((b_.shape[0], padw) + b_.shape[2:], b_.dtype)],
                axis=1,
            )
            c_ = np.concatenate(
                [c_, np.zeros((c_.shape[0], padw), np.int32)], axis=1
            )
        outs_b.append(b_)
        outs_c.append(c_)
    return PBell(
        blocks=jnp.asarray(np.stack(outs_b), dtype),
        cols=jnp.asarray(np.stack(outs_c), jnp.int32),
        diag=jnp.asarray(P_csc.diagonal()[:n], dtype),
    )


def _pack_bell_numpy(A_csc, bs):
    """Pure-numpy block-ELL packer (fallback when g++ is unavailable)."""
    m, n = A_csc.shape
    nbr, nbc = -(-m // bs), -(-n // bs)
    coo = A_csc.tocoo()
    bi, bj = coo.row // bs, coo.col // bs
    pair_ids = bi * nbc + bj
    uniq = np.unique(pair_ids)
    slots = {}
    counts = np.zeros(nbr, np.int64)
    for p in uniq:
        r = p // nbc
        slots[p] = counts[r]
        counts[r] += 1
    width = max(int(counts.max()) if nbr else 0, 1)
    blocks = np.zeros((nbr, width, bs, bs))
    cols = np.zeros((nbr, width), np.int64)
    for p in uniq:
        cols[p // nbc, slots[p]] = p % nbc
    slot_of = np.array([slots[p] for p in pair_ids])
    blocks[bi, slot_of, coo.row % bs, coo.col % bs] = coo.data
    return blocks, cols
