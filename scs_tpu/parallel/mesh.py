"""Scenario-batch sharding over a device mesh.

The reference's concurrency model is many solver instances on many OS
threads (free-threaded CPython, SURVEY.md §2.5). The replacement here: a
batch of problems laid out over a 1-D `jax.sharding.Mesh` — data-parallel
over the batch axis, with every solver step jit-partitioned by XLA.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..info import UNFINISHED
from ..solver import _hp


def make_mesh(n_devices=None, axis_name="batch"):
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))


def shard_batched_mats(mats, mesh, axis_name="batch"):
    """Place batched Mats (leading batch dim on every leaf) on the mesh."""
    sharding = NamedSharding(mesh, P(axis_name))
    return jax.tree.map(lambda a: jax.device_put(a, sharding), mats)


def sharded_batch_solve(core, mats, mesh, axis_name="batch", max_iters=None):
    """Solve a sharded batch of problems; one compiled program, XLA inserts
    the (trivial) collectives for the data-parallel layout.

    `mats` must already be sharded with `shard_batched_mats`. Returns the
    final states (sharded the same way).
    """
    max_iters = max_iters if max_iters is not None else core.stg.max_iters

    def masked_chunk(state, m_):
        new = core._chunk(state, m_)
        keep = state.status == UNFINISHED

        def merge(old, newv):
            return jnp.where(
                keep if old.ndim == 0 else keep.reshape((1,) * old.ndim),
                newv,
                old,
            )

        return jax.tree.map(merge, state, new)

    vchunk = jax.vmap(masked_chunk)
    vinit = jax.vmap(core._init_pure)

    def run(mats):
        states = vinit(mats)

        def cond(s):
            return jnp.any((s.status == UNFINISHED) & (s.it < max_iters))

        return lax.while_loop(cond, lambda s: vchunk(s, mats), states)

    sharding = NamedSharding(mesh, P(axis_name))
    run_jit = jax.jit(_hp(run), in_shardings=(jax.tree.map(lambda _: sharding, mats),))
    with mesh:
        return run_jit(mats)
