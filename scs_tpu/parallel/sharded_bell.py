"""Row-sharded block-ELL (bell) solver core — the sparse counterpart of
ShardedSCS's dense row-sharded path (VERDICT r3 item 7: the one case that
truly needs multi-chip memory is a giant SPARSE problem whose dense form
fits nowhere).

Layout (built by ops.sparse.pack_bell_sharded): device d holds the
block-ELL pack of its contiguous row slice A_d AND the pack of A_d^T.
Every iterate vector is replicated; the two operator touches communicate:

    A @ x    : local SpMV, then all_gather of the (m,)
               result over the 'rows' axis
    A^T @ y  : dynamic-slice the local y rows by axis index, local SpMV
               of the transposed pack, then psum of the (n,) partials

Everything else in the DR iteration (cone projection, AA, residuals,
adaptive rescale, CG driver) operates on replicated vectors and runs
identically on every device, so the whole Core machinery is reused — the
compiled programs are simply wrapped in shard_map with the bell arrays
sharded on their leading device axis.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from ..solver import BellData, Core, Mats, PBell, _hp


class ShardedBellCore(Core):
    """Core whose compiled programs run under shard_map with the bell
    pack row-sharded across a 1-D mesh. A quadratic cost P rides its own
    row-sharded symmetric pack (ops.sparse.pack_bell_sym_sharded): the
    local P_d @ x rows are all-gathered exactly like A @ x."""

    def __init__(self, m, n, has_P, spec, stg, mesh, axis_name):
        self.mesh = mesh
        self.axis = axis_name
        super().__init__(m, n, has_P, spec, stg)

        bell_spec = BellData(
            A_blocks=P(axis_name),
            A_cols=P(axis_name),
            At_blocks=P(axis_name),
            At_cols=P(axis_name),
            colsq_all=P(),
            colsq_zero=P(),
        )
        pbell_spec = (
            PBell(blocks=P(axis_name), cols=P(axis_name), diag=P())
            if has_P
            else None
        )
        mats_spec = Mats(
            A=P(), P=P(), bn=P(), cn=P(), bl=P(), bu=P(), D=P(), E=P(),
            sc_b=P(), sc_c=P(), norm_b=P(), norm_c=P(),
            bell=bell_spec, pbell=pbell_spec,
        )
        self._mats_spec = mats_spec
        # check_vma=False: outputs ARE replicated (every device runs the
        # identical math on replicated vectors after each psum /
        # all_gather), but the static varying-manual-axes analysis cannot
        # prove it through axis_index-driven dynamic slices.
        smap = partial(jax.shard_map, mesh=mesh, check_vma=False)

        # Re-wrap the compiled entry points built by Core.__init__ so the
        # collectives inside _Ax/_ATy have their mesh axis. State and all
        # outputs are replicated (P() prefix specs).
        self._jit_init = jax.jit(
            _hp(smap(self._init_pure, in_specs=(mats_spec,), out_specs=P()))
        )
        self._jit_init_from_factor = jax.jit(
            _hp(
                smap(
                    self._init_from_factor,
                    in_specs=(mats_spec, P()),
                    out_specs=P(),
                )
            )
        )
        self._jit_chunk = jax.jit(
            _hp(smap(self._chunk, in_specs=(P(), mats_spec), out_specs=P()))
        )

        @partial(jax.jit, static_argnums=(2, 3))
        def jit_multi(state, mats, seg, max_iters):
            fn = smap(
                lambda s, mt: self._multi_chunk(s, mt, seg, max_iters),
                in_specs=(P(), mats_spec),
                out_specs=P(),
            )
            return _hp(fn)(state, mats)

        self._jit_multi_chunk = jit_multi
        self._jit_finalize = jax.jit(
            _hp(
                smap(self._finalize, in_specs=(P(), mats_spec), out_specs=P())
            )
        )
        # _jit_final_scalars / _jit_probe operate on replicated state only
        # (no collectives) — the plain jits from Core.__init__ stand.

    def phase_times(self, state, mats):
        """Per-phase calibration needs standalone jits of collective-
        bearing phase fns; not supported under the mesh — report zeros
        (phase_timing='always' is rejected by ShardedSCS)."""
        return {"lin_sys": 0.0, "cone": 0.0, "accel_trial": 0.0}

    # -- sharded operator touches -----------------------------------------

    def _local_pack(self, arr):
        """Strip the per-device leading axis (size 1 inside shard_map)."""
        return arr[0]

    def _Ax(self, mats: Mats, x):
        from ..ops.sparse import bell_spmv_ref  # noqa: PLC0415

        bell = mats.bell
        blocks = self._local_pack(bell.A_blocks)
        cols = self._local_pack(bell.A_cols)
        bs = blocks.shape[-1]
        n_pad = bell.At_blocks.shape[1] * bs
        x_pad = jnp.zeros(n_pad, x.dtype).at[: self.n].set(x)
        y_loc = bell_spmv_ref(blocks, cols, x_pad)  # (m_loc,)
        # m is a multiple of n_dev*bs by construction (ShardedSCS pads),
        # so the tiled gather reassembles exactly the (m,) vector
        return lax.all_gather(y_loc, self.axis, tiled=True)

    def _ATy(self, mats: Mats, y):
        from ..ops.sparse import bell_spmv_ref  # noqa: PLC0415

        bell = mats.bell
        blocks = self._local_pack(bell.At_blocks)
        cols = self._local_pack(bell.At_cols)
        bs = blocks.shape[-1]
        m_loc = bell.A_blocks.shape[1] * bs
        d = lax.axis_index(self.axis)
        y_loc = lax.dynamic_slice(y, (d * m_loc,), (m_loc,))
        t = bell_spmv_ref(blocks, cols, y_loc)[: self.n]
        return lax.psum(t, self.axis)

    def _Px(self, mats: Mats, x):
        """P @ x with P row-sharded (pack_bell_sym_sharded): local SpMV
        of this device's row slice of the symmetric pack, then a tiled
        all-gather over the rows axis — identical communication to _Ax
        (symmetry makes the transpose orientation unnecessary)."""
        from ..ops.sparse import bell_spmv_ref  # noqa: PLC0415

        pb = mats.pbell
        blocks = self._local_pack(pb.blocks)  # (nbr_loc, w, bs, bs)
        cols = self._local_pack(pb.cols)
        bs = blocks.shape[-1]
        n_pad_cols = -(-self.n // bs) * bs  # packer's column padding
        x_pad = jnp.zeros(n_pad_cols, x.dtype).at[: self.n].set(x)
        y_loc = bell_spmv_ref(blocks, cols, x_pad)  # (n_loc,) local rows of P @ x
        return lax.all_gather(y_loc, self.axis, tiled=True)[: self.n]
