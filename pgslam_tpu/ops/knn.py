"""Brute-force tiled k-nearest-neighbour correspondence search.

Replacement for libpointmatcher's kd-tree ``KDTreeMatcher``
(``matcher->init(reference)`` / ``findClosests(reading)``,
reference call sites ``Localizer.hpp:317,328`` and ``LoopCloser.hpp:356-358``
— the hot loop of every ICP iteration).

A kd-tree is the wrong shape for an accelerator: pointer chasing and
dynamic control flow. Instead we compute squared distances tile-by-tile with
``d2 = |q|^2 - 2 q.r + |r|^2`` and keep a running top-k, so the full
``[Nq, Nr]`` distance matrix never materializes. The ``lax.scan`` over
reference tiles keeps peak memory at ``[Nq, tile]`` while XLA fuses the
norm/compare chain into the matmul epilogue.

Masking: invalid reference points get ``+inf`` distance so they are never
selected; invalid query rows return matches that downstream code masks out
(weights are zeroed in :mod:`pgslam_tpu.ops.outlier`).

For very large reference clouds prefer :mod:`pgslam_tpu.ops.gridknn`
(voxel-hash candidate search) or the Pallas kernel in
:mod:`pgslam_tpu.ops.knn_pallas`.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import jax.numpy as jnp

from ..utils.pytree import pytree_dataclass
# Host-side constant: module import must NOT touch the JAX backend.
INF = np.float32(np.inf)


@pytree_dataclass
class Matches:
    """Match result, analog of libpointmatcher ``Matches``.

    ``dists2``: ``[Nq, k]`` squared distances (kd-tree convention).
    ``ids``:    ``[Nq, k]`` indices into the reference cloud.
    """

    dists2: jax.Array
    ids: jax.Array

    @property
    def k(self) -> int:
        return self.dists2.shape[-1]


def _merge_topk(best_d, best_i, tile_d, tile_i, k: int):
    """Merge running top-k with a new tile's candidates (small k)."""
    d = jnp.concatenate([best_d, tile_d], axis=-1)
    i = jnp.concatenate([best_i, tile_i], axis=-1)
    neg_top, arg = jax.lax.top_k(-d, k)
    return -neg_top, jnp.take_along_axis(i, arg, axis=-1)


@functools.partial(
    jax.jit, static_argnames=("k", "tile_ref", "tile_query", "precision"))
def knn_brute_force(
    query: jax.Array,          # [Nq, 3]
    query_mask: jax.Array,     # [Nq] bool
    reference: jax.Array,      # [Nr, 3]
    reference_mask: jax.Array, # [Nr] bool
    *,
    k: int = 1,
    tile_ref: int = 2048,
    tile_query: int = 0,       # 0 = no query tiling
    precision=jax.lax.Precision.HIGHEST,
) -> Matches:
    """Exact masked kNN from each query point to the reference cloud."""
    nq = query.shape[0]
    nr = reference.shape[0]
    if tile_query and nq > tile_query:
        # Process query chunks serially to bound the [tile_q, tile_r] block.
        pad = (-nq) % tile_query
        q = jnp.pad(query, ((0, pad), (0, 0)))
        qm = jnp.pad(query_mask, (0, pad))
        q = q.reshape(-1, tile_query, 3)
        qm = qm.reshape(-1, tile_query)
        res = jax.lax.map(
            lambda args: knn_brute_force(
                args[0], args[1], reference, reference_mask,
                k=k, tile_ref=tile_ref, tile_query=0, precision=precision),
            (q, qm))
        return Matches(dists2=res.dists2.reshape(-1, k)[:nq],
                       ids=res.ids.reshape(-1, k)[:nq])

    # Pad reference so tiles divide evenly; padding is masked to +inf.
    pad = (-nr) % tile_ref
    ref = jnp.pad(reference, ((0, pad), (0, 0)))
    ref_mask = jnp.pad(reference_mask, (0, pad))
    n_tiles = ref.shape[0] // tile_ref
    ref_tiles = ref.reshape(n_tiles, tile_ref, 3)
    mask_tiles = ref_mask.reshape(n_tiles, tile_ref)

    q_sq = jnp.sum(query * query, axis=-1, keepdims=True)  # [Nq, 1]

    def body(carry, tile):
        best_d, best_i = carry
        r, m, base = tile
        r_sq = jnp.sum(r * r, axis=-1)  # [T]
        # [Nq, T] squared distances via a matmul.
        cross = jax.lax.dot_general(
            query, r, (((1,), (1,)), ((), ())), precision=precision)
        d2 = q_sq - 2.0 * cross + r_sq[None, :]
        d2 = jnp.where(m[None, :], jnp.maximum(d2, 0.0), INF)
        if k == 1:
            tile_min = jnp.min(d2, axis=-1, keepdims=True)
            tile_arg = jnp.argmin(d2, axis=-1, keepdims=True) + base
        else:
            neg, arg = jax.lax.top_k(-d2, k)
            tile_min, tile_arg = -neg, arg + base
        # argmin/top_k return int64 under jax_enable_x64; pin the carry
        # dtype so the fp64 instantiation path scans cleanly.
        tile_arg = tile_arg.astype(jnp.int32)
        return _merge_topk(best_d, best_i, tile_min, tile_arg, k), None

    init = (jnp.full((nq, k), INF, dtype=query.dtype),
            jnp.zeros((nq, k), jnp.int32))
    bases = jnp.arange(n_tiles, dtype=jnp.int32) * tile_ref
    (best_d, best_i), _ = jax.lax.scan(body, init, (ref_tiles, mask_tiles, bases))
    # Clamp ids of all-invalid rows to 0 to keep gathers in-bounds.
    valid = jnp.isfinite(best_d)
    best_i = jnp.where(valid, best_i, 0)
    return Matches(dists2=best_d, ids=best_i)


def gather_matches(reference_cloud, matches: Matches, j: int = 0):
    """Gather matched reference points (and descriptors) for match column j.

    Returns (points [Nq,3], descriptors dict of [Nq,D]).
    """
    ids = matches.ids[:, j]
    pts = jnp.take(reference_cloud.points, ids, axis=0)
    desc = {name: jnp.take(val, ids, axis=0)
            for name, val in reference_cloud.descriptors.items()}
    return pts, desc
