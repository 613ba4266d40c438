"""Single-problem solve with the constraint matrix row-sharded across a
device mesh — the replacement for the reference's multithreaded sparse
direct backend on ONE giant problem (SURVEY.md §2.4: row-block-sharded A
+ psum-CG across devices replaces multithreaded Pardiso,
meson.build:315-348).

Design: the full DR loop (linear projection, cone projection, Anderson
acceleration, residuals, adaptive rescale) runs as ONE jit-compiled
program under the mesh. Only `A` carries a non-trivial sharding
(PartitionSpec('rows', None)); every iterate vector is replicated. XLA's
SPMD partitioner then places the collectives exactly where the math needs
them: `A @ x` computes local row blocks (no communication), `A.T @ y`
reduces partial (n,)-results with an all-reduce between devices —
the same communication pattern as `sharded_cg.sharded_cg_solve`, but
integrated into the solver instead of a standalone kernel.

The memory object that makes a problem "too big for one chip" is A itself
(m x n); sharding it divides per-chip HBM by the mesh size while iterate
vectors (O(m + n)) stay replicated.
"""

from __future__ import annotations

import numpy as np
from scipy import sparse as _sp

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from ..api import SCS
from .mesh import make_mesh


class ShardedSCS(SCS):
    """SCS solver for one problem with A row-sharded over a mesh.

    Parameters are those of `SCS`, plus:
      mesh: a 1-D `jax.sharding.Mesh` (axis: rows). Defaults to all
            visible devices.

    The row dimension is padded to a multiple of the mesh size by
    PREPENDING rows to the zero cone (A rows and b entries of zeros — the
    constraint 0 = 0, decoupled from the problem); padding is stripped
    from y and s on output.
    """

    def __init__(self, data, cone, mesh=None, **settings):
        if mesh is None:
            mesh = make_mesh(axis_name="rows")
        if len(mesh.axis_names) != 1:
            raise ValueError("ShardedSCS expects a 1-D mesh")
        self.mesh = mesh
        self._rows_axis = mesh.axis_names[0]
        n_dev = int(np.prod(list(mesh.shape.values())))
        self._n_dev = n_dev

        # Two sharding strategies, both matrix-free (no (n, n) dense
        # factor; every operator touch is an A / A^T matvec):
        #   "indirect" — dense A row-sharded, XLA SPMD places the psum;
        #   "bell"     — the block-ELL pack row-sharded via shard_map
        #                (ShardedBellCore), for giant SPARSE problems
        #                whose dense form fits on no single chip.
        strategy = settings.setdefault("solver_strategy", "indirect")
        if strategy not in ("indirect", "bell"):
            raise ValueError(
                "ShardedSCS requires solver_strategy='indirect' or 'bell'"
            )
        self._bell_mode = strategy == "bell"
        if self._bell_mode:
            if settings.get("phase_timing") == "always":
                raise ValueError(
                    "phase_timing='always' is not supported on the "
                    "sharded bell path"
                )

        b = np.asarray(
            data["b"].todense() if _sp.issparse(data["b"]) else data["b"],
            np.float64,
        ).ravel()
        # bell: each device's row slice must pack into whole (bs x bs)
        # tiles, so rows pad to a multiple of n_dev * block_size
        pad_mult = (
            n_dev * int(settings.get("bell_block_size", 128))
            if self._bell_mode
            else n_dev
        )
        pad = (-len(b)) % pad_mult
        self._row_pad = pad
        if pad:
            data = dict(data)
            cone = dict(cone)
            A = data["A"]
            if _sp.issparse(A):
                A = _sp.vstack(
                    [_sp.csc_matrix((pad, A.shape[1])), A.tocsc()]
                ).tocsc()
            else:
                A = np.vstack([np.zeros((pad, np.shape(A)[1])), np.asarray(A)])
            data["A"] = A
            data["b"] = np.concatenate([np.zeros(pad), b])
            cone["z"] = int(cone.get("z", 0)) + pad

        super().__init__(data, cone, **settings)

        if self._bell_mode:
            # _build_bell already placed the per-device packs with their
            # leading-axis sharding, and the shard_map-wrapped core
            # (ShardedBellCore) computed _state0 under the mesh.
            return

        # place the operator: A row-sharded, everything else replicated
        row = NamedSharding(mesh, P(self._rows_axis, None))
        rep = NamedSharding(mesh, P())
        self.mats = self.mats._replace(
            A=jax.device_put(self.mats.A, row),
            **{
                f: jax.device_put(getattr(self.mats, f), rep)
                for f in ("P", "bn", "cn", "bl", "bu", "D", "E")
            },
        )
        # re-run setup with the sharded operator so gx/gy (and any state
        # the factorization holds) are computed under the mesh layout
        with self.mesh:
            self._state0 = self.core.init_state(self.mats)
            _ = self._state0.gx.block_until_ready()

    # -- strategy hooks -----------------------------------------------------

    def _make_core(self, m, n, has_P, spec_hat):
        if self._bell_mode:
            from .sharded_bell import ShardedBellCore

            return ShardedBellCore(
                m, n, has_P, spec_hat, self.stg, self.mesh, self._rows_axis
            )
        return super()._make_core(m, n, has_P, spec_hat)

    def _build_bell(self, Ah_sp, Ph_sp, spec_hat, dtype):
        from ..ops.sparse import pack_bell_sharded, pack_bell_sym_sharded
        from ..solver import BellData, PBell

        import jax.numpy as jnp

        bs = int(self.stg.bell_block_size)
        Ab, Ac, Atb, Atc, colsq_all = pack_bell_sharded(
            Ah_sp, self._n_dev, bs, dtype
        )
        zmask = spec_hat.zero_row_mask().astype(np.float64)
        Asq = Ah_sp.multiply(Ah_sp)
        colsq_zero = np.asarray(zmask @ Asq).ravel()
        shard = NamedSharding(self.mesh, P(self._rows_axis))
        rep = NamedSharding(self.mesh, P())
        bell = BellData(
            A_blocks=jax.device_put(Ab, shard),
            A_cols=jax.device_put(Ac, shard),
            At_blocks=jax.device_put(Atb, shard),
            At_cols=jax.device_put(Atc, shard),
            colsq_all=jax.device_put(colsq_all, rep),
            colsq_zero=jax.device_put(jnp.asarray(colsq_zero, dtype), rep),
        )
        pbell = None
        if Ph_sp is not None:
            # row-sharded symmetric pack of P (VERDICT r4 item 7): local
            # P_d @ x rows all-gather like A @ x (see ShardedBellCore._Px)
            pb = pack_bell_sym_sharded(Ph_sp, self._n_dev, bs, dtype)
            pbell = PBell(
                blocks=jax.device_put(pb.blocks, shard),
                cols=jax.device_put(pb.cols, shard),
                diag=jax.device_put(pb.diag, rep),
            )
        return bell, pbell

    def _update_locked(self, b=None, c=None):
        if b is not None and self._row_pad:
            b = np.concatenate(
                [np.zeros(self._row_pad), np.asarray(b, np.float64).ravel()]
            )
        with self.mesh:
            out = super()._update_locked(b, c)
        rep = NamedSharding(self.mesh, P())
        self.mats = self.mats._replace(
            bn=jax.device_put(self.mats.bn, rep),
            cn=jax.device_put(self.mats.cn, rep),
        )
        return out

    def _solve_locked(self, warm_start, x, y, s):
        if y is not None and self._row_pad:
            y = np.concatenate([np.zeros(self._row_pad), np.asarray(y).ravel()])
        if s is not None and self._row_pad:
            s = np.concatenate([np.zeros(self._row_pad), np.asarray(s).ravel()])
        with self.mesh:
            out = super()._solve_locked(warm_start, x, y, s)
        pad = self._row_pad
        if pad:
            out["y"] = out["y"][pad:]
            out["s"] = out["s"][pad:]
        return out
