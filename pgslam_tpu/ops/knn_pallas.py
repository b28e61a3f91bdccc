"""Exact masked 1-NN search as a Pallas kernel for NVIDIA GPUs (Triton route).

The matcher is the inner loop of every ICP iteration. The plain XLA
version (:func:`pgslam_tpu.ops.knn.knn_brute_force`) computes
``|q|^2 - 2 q.r + |r|^2`` as an ``[Nq, tile]`` block per reference tile,
which goes through device memory. This kernel keeps everything in
registers:

* the grid runs over (query blocks, reference splits). A block holds
  ``block_q`` queries; a split is a contiguous run of reference tiles, so
  that a small reading (a few thousand points) still fills the card;
* an in-kernel loop walks the split's reference tiles of ``block_r``
  points. Each (query, slot) pair keeps a running min distance and the
  tile it came from, so the loop body is three differences, three FMAs,
  one compare and two selects, with no cross-lane reduction;
* the squared distance is computed directly as ``sum((q - r)^2)``: a K=3
  contraction gives the tensor cores nothing to do, and the direct
  difference has no cancellation at 50 m coordinates;
* each program writes one distance and one id per query; the splits are
  combined by a small argmin in XLA.

Masked reference points carry an ``+inf`` x coordinate, so their
distance is ``+inf`` and a strict ``<`` never selects them. Ties go to the
lowest reference index, as in the brute-force matcher.

The kernel serves k=1 only (what ICP uses); :func:`nn_pallas` sends k>1
to the brute-force matcher. :func:`use_kernel` decides, by platform,
whether the kernel runs at all.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .knn import Matches, knn_brute_force

# Enough programs to keep every SM of the card busy with a few blocks each
# when the query set is small, but at least 16 reference tiles per program:
# shorter walks pay the per-program setup and final reduction too often
# (under vmap the batch multiplies the programs anyway). Measured on an
# H100 (PERF.md).
_TARGET_PROGRAMS = 1024
_MIN_TILES_PER_SPLIT = 16
# Warps per program for the default 64x64 tile: 4 was best or within 6%
# of best among the block shapes and warp counts tried on an H100
# (PERF.md).
_NUM_WARPS = 4


def use_kernel(platform: str) -> bool:
    """The one place that decides whether the matcher kernel runs.

    ``"gpu"`` runs the kernel; ``"cpu"`` takes the XLA brute-force path
    (the kernel has no native CPU lowering, and interpret mode is for
    tests); any other platform is an error rather than a silent
    fallback."""
    if platform == "gpu":
        return True
    if platform == "cpu":
        return False
    raise NotImplementedError(
        f"no nearest-neighbour kernel for platform {platform!r}")


def _kernel(qx_ref, qy_ref, qz_ref, rx_ref, ry_ref, rz_ref, d_ref, i_ref,
            *, block_r: int, tiles_per_split: int):
    s = pl.program_id(1)
    qx = qx_ref[...][:, None]                                 # [BQ, 1]
    qy = qy_ref[...][:, None]
    qz = qz_ref[...][:, None]
    bq = qx.shape[0]
    base = s * (tiles_per_split * block_r)

    def body(t, carry):
        best_d, best_t = carry
        sl = pl.ds(base + t * block_r, block_r)
        dx = qx - rx_ref[sl][None, :]                         # [BQ, BR]
        dy = qy - ry_ref[sl][None, :]
        dz = qz - rz_ref[sl][None, :]
        d2 = dx * dx + dy * dy + dz * dz
        better = d2 < best_d
        return (jnp.where(better, d2, best_d),
                jnp.where(better, t, best_t))

    init = (jnp.full((bq, block_r), jnp.inf, jnp.float32),
            jnp.zeros((bq, block_r), jnp.int32))
    best_d, best_t = jax.lax.fori_loop(0, tiles_per_split, body, init)
    d = jnp.min(best_d, axis=1)                               # [BQ]
    slot = jax.lax.broadcasted_iota(jnp.int32, (bq, block_r), 1)
    ids = base + best_t * block_r + slot
    big = jnp.int32(2 ** 31 - 1)
    d_ref[...] = d
    i_ref[...] = jnp.min(jnp.where(best_d == d[:, None], ids, big), axis=1)


def _splits(nq_blocks: int, nr_tiles: int) -> int:
    return max(1, min(nr_tiles // _MIN_TILES_PER_SPLIT,
                      -(-_TARGET_PROGRAMS // nq_blocks)))


@functools.partial(
    jax.jit,
    static_argnames=("k", "block_q", "block_r", "interpret"))
def nn_pallas(query: jax.Array,            # [NQ, 3]
              query_mask: jax.Array,       # [NQ]
              reference: jax.Array,        # [NR, 3]
              reference_mask: jax.Array,   # [NR]
              *, k: int = 1, block_q: int = 64, block_r: int = 64,
              interpret: bool = False) -> Matches:
    """Exact masked nearest neighbour. Returns squared distances
    ``[NQ, k]`` (+inf for masked queries or when no reference is valid)
    and indices (0 where the distance is +inf), like
    :func:`knn_brute_force`.

    k>1 is served by :func:`knn_brute_force`: the running top-k buffers
    would cost registers that the k=1 loop spends on its tile. ``interpret``
    runs the kernel in the Pallas interpreter; tests pass it on the CPU."""
    if k != 1:
        return knn_brute_force(query, query_mask, reference, reference_mask,
                               k=k)
    nq, nr = query.shape[0], reference.shape[0]
    nq_blocks = -(-nq // block_q)
    nr_tiles = -(-nr // block_r)
    n_splits = _splits(nq_blocks, nr_tiles)
    tiles_per_split = -(-nr_tiles // n_splits)
    nqp = nq_blocks * block_q
    nrp = n_splits * tiles_per_split * block_r

    q = jnp.pad(query.astype(jnp.float32), ((0, nqp - nq), (0, 0)))
    r = reference.astype(jnp.float32)
    rx = jnp.where(reference_mask, r[:, 0], jnp.inf)
    rx = jnp.pad(rx, (0, nrp - nr), constant_values=jnp.inf)
    ry = jnp.pad(r[:, 1], (0, nrp - nr))
    rz = jnp.pad(r[:, 2], (0, nrp - nr))

    q_spec = pl.BlockSpec((block_q,), lambda i, s: (i,))
    r_spec = pl.BlockSpec((nrp,), lambda i, s: (0,))
    out_spec = pl.BlockSpec((block_q,), lambda i, s: (s * nq_blocks + i,))
    d, ids = pl.pallas_call(
        functools.partial(_kernel, block_r=block_r,
                          tiles_per_split=tiles_per_split),
        grid=(nq_blocks, n_splits),
        in_specs=[q_spec] * 3 + [r_spec] * 3,
        out_specs=[out_spec, out_spec],
        out_shape=[jax.ShapeDtypeStruct((n_splits * nqp,), jnp.float32),
                   jax.ShapeDtypeStruct((n_splits * nqp,), jnp.int32)],
        compiler_params=pltriton.CompilerParams(num_warps=_NUM_WARPS,
                                                num_stages=1),
        backend="triton",
        interpret=interpret,
        name="nn_pallas",
    )(q[:, 0], q[:, 1], q[:, 2], rx, ry, rz)

    # Combine the splits; argmin takes the first split on ties, which is
    # the lower reference index.
    d = d.reshape(n_splits, nqp)[:, :nq]
    ids = ids.reshape(n_splits, nqp)[:, :nq]
    best = jnp.argmin(d, axis=0)
    d = jnp.take_along_axis(d, best[None], axis=0)[0]
    ids = jnp.take_along_axis(ids, best[None], axis=0)[0]
    hit = query_mask & jnp.isfinite(d)
    d = jnp.where(hit, d, jnp.inf)[:, None]
    ids = jnp.where(hit, ids, 0)[:, None]
    return Matches(dists2=d, ids=ids)
