"""Batched multi-agent registration (BASELINE config 5).

``vmap`` lifts the whole jitted ICP loop over an agent axis; with a device
mesh the batch axis shards across chips (pure data parallelism — each
agent's registration is independent). One dispatch registers B scans.
"""

from __future__ import annotations

import functools

import jax

from ..cloud import Cloud
from ..ops.icp import ICPConfig, ICPResult, icp_core


@functools.partial(jax.jit, static_argnames=("cfg",))
def batched_register(readings: Cloud, references: Cloud,
                     T_inits: jax.Array,
                     cfg: ICPConfig = ICPConfig()) -> ICPResult:
    """Register a batch: readings/references carry a leading agent axis
    ``[B, N, ...]``; ``T_inits`` is ``[B, 4, 4]``. Returns a batched
    :class:`ICPResult`. One dispatch runs the vmapped ICP loop; agents
    that converge early idle until the last one does."""
    return jax.vmap(lambda r, m, t: icp_core(r, m, t, cfg))(
        readings, references, T_inits)


def shard_batch(mesh: jax.sharding.Mesh, axis: str = "dp"):
    """NamedSharding placing the leading agent axis on a mesh axis; use as
    ``jax.device_put(batch, shard_batch(mesh))`` before
    :func:`batched_register` so XLA runs agents fully in parallel."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    def put(tree):
        def shard_leaf(x):
            spec = P(axis) if getattr(x, "ndim", 0) >= 1 else P()
            return jax.device_put(x, NamedSharding(mesh, spec))
        return jax.tree_util.tree_map(shard_leaf, tree)

    return put
