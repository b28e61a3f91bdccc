"""Data-point filter chains — analog of libpointmatcher's
``DataPointsFilters`` (applied to raw input at ``Localizer.hpp:103`` and in
the partial-ICP replay at ``Localizer.hpp:314-326``).

Design: every filter is *mask-only* — it never changes array shapes, it
only clears validity bits and/or adds descriptor channels. That keeps all
downstream kernels fixed-shape (compile once). An optional :func:`compact`
pass pushes valid points to the front so a chain can end by shrinking to a
smaller static capacity when the config promises an upper bound.

Filter configs are frozen dataclasses (hashable), so a whole chain can be a
static argument to a jitted pipeline.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..cloud import Cloud
from .knn import knn_brute_force


# --------------------------------------------------------------------------
# Filter configs
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Identity:
    """No-op (libpointmatcher ``IdentityDataPointsFilter``)."""


@dataclasses.dataclass(frozen=True)
class RandomSampling:
    """Keep each point independently with probability ``prob``."""
    prob: float = 0.75


@dataclasses.dataclass(frozen=True)
class MaxPointCount:
    """Keep at most ``count`` valid points (first ones win)."""
    count: int = 10000


@dataclasses.dataclass(frozen=True)
class MaxDist:
    """Drop points farther than ``dist`` from the origin along ``dim``
    (-1 = radial)."""
    dist: float = 100.0
    dim: int = -1


@dataclasses.dataclass(frozen=True)
class MinDist:
    """Drop points closer than ``dist`` to the origin along ``dim``."""
    dist: float = 0.5
    dim: int = -1


@dataclasses.dataclass(frozen=True)
class BoundingBox:
    """Drop points inside (or outside) an axis-aligned box."""
    xmin: float = -1.0
    xmax: float = 1.0
    ymin: float = -1.0
    ymax: float = 1.0
    zmin: float = -1.0
    zmax: float = 1.0
    remove_inside: bool = True


@dataclasses.dataclass(frozen=True)
class VoxelGrid:
    """Keep one point per occupied voxel (grid subsampling).

    Implemented as a scatter-min race over a hash table: for each voxel the
    surviving point is the one with the smallest index. ``hash_size`` should
    be a few times the expected occupied-voxel count; hash collisions only
    make the filter slightly more aggressive, never incorrect.

    ``method``: "scatter" (hash-table race), "sort" (lexsort dedup with
    identical keep-mask — no scatter op), or "auto". "auto" resolves to
    "scatter" on every backend (see ``_voxel_method``); "sort" remains
    for scatter-hostile backends.
    """
    voxel_size: float = 0.2
    hash_size: int = 1 << 16
    method: str = "auto"


@dataclasses.dataclass(frozen=True)
class Compact:
    """Push valid points to the front and shrink to a fixed capacity —
    shape-changing, so only meaningful as the LAST element of a chain.
    Pair with a subsampling filter (VoxelGrid/RandomSampling/MaxPointCount)
    so the surviving count fits; extra valid points are dropped. This is
    how a pipeline turns '64k-point input' into a '16k-point working set'
    while every downstream kernel stays fixed-shape."""
    capacity: int = 16384


@dataclasses.dataclass(frozen=True)
class ObservationDirection:
    """Add unit vectors pointing from each point toward the sensor center
    (libpointmatcher ``ObservationDirectionDataPointsFilter``). Must run in
    the sensor frame — the reason the reference applies input filters before
    the sensor->robot transform (``Localizer.hpp:100-106``)."""
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0


@dataclasses.dataclass(frozen=True)
class SurfaceNormal:
    """Estimate per-point normals from the ``knn`` nearest neighbours via
    PCA (libpointmatcher ``SurfaceNormalDataPointsFilter``). Adds a
    ``normals`` descriptor; optionally orients normals toward the sensor
    using the ``observationDirections`` descriptor if present."""
    knn: int = 8
    orient: bool = True
    tile_query: int = 4096


@dataclasses.dataclass(frozen=True)
class Shadow:
    """Drop "shadow" points: surface normal nearly perpendicular to the
    observation direction (grazing-angle returns, libpointmatcher
    ``ShadowDataPointsFilter``). Requires ``normals`` and
    ``observationDirections`` descriptors (run SurfaceNormal +
    ObservationDirection first); passes through silently otherwise."""
    eps: float = 0.1   # keep if |cos(angle)| >= eps


@dataclasses.dataclass(frozen=True)
class MaxDensity:
    """Cap local point density (libpointmatcher
    ``MaxDensityDataPointsFilter`` intent): within each voxel of size
    ``radius``, keep at most ``max_count`` points. Same hash-race scheme
    as VoxelGrid, extended to count slots."""
    radius: float = 0.5
    max_count: int = 4
    hash_size: int = 1 << 16


@dataclasses.dataclass(frozen=True)
class FixStepSampling:
    """Keep every ``step``-th valid point (libpointmatcher
    ``FixStepSamplingDataPointsFilter`` with a constant step)."""
    step: int = 2


FilterConfig = (Identity, RandomSampling, MaxPointCount, MaxDist, MinDist,
                BoundingBox, VoxelGrid, ObservationDirection, SurfaceNormal,
                Shadow, MaxDensity, FixStepSampling, Compact)
Chain = Tuple  # tuple of filter configs


# --------------------------------------------------------------------------
# Filter implementations (Cloud -> Cloud, jit-friendly)
# --------------------------------------------------------------------------

def _apply_one(cfg, cloud: Cloud, key: jax.Array) -> Cloud:
    if isinstance(cfg, Identity):
        return cloud
    if isinstance(cfg, RandomSampling):
        keep = jax.random.bernoulli(key, cfg.prob, (cloud.capacity,))
        return cloud.replace(mask=cloud.mask & keep)
    if isinstance(cfg, MaxPointCount):
        rank = jnp.cumsum(cloud.mask.astype(jnp.int32)) - 1
        return cloud.replace(mask=cloud.mask & (rank < cfg.count))
    if isinstance(cfg, MaxDist):
        d = _dist_along(cloud.points, cfg.dim)
        return cloud.replace(mask=cloud.mask & (d <= cfg.dist))
    if isinstance(cfg, MinDist):
        d = _dist_along(cloud.points, cfg.dim)
        return cloud.replace(mask=cloud.mask & (d >= cfg.dist))
    if isinstance(cfg, BoundingBox):
        p = cloud.points
        inside = ((p[:, 0] >= cfg.xmin) & (p[:, 0] <= cfg.xmax)
                  & (p[:, 1] >= cfg.ymin) & (p[:, 1] <= cfg.ymax)
                  & (p[:, 2] >= cfg.zmin) & (p[:, 2] <= cfg.zmax))
        drop = inside if cfg.remove_inside else ~inside
        return cloud.replace(mask=cloud.mask & ~drop)
    if isinstance(cfg, VoxelGrid):
        return _voxel_grid(cfg, cloud)
    if isinstance(cfg, Compact):
        return compact(cloud, cfg.capacity)
    if isinstance(cfg, ObservationDirection):
        center = jnp.array([cfg.x, cfg.y, cfg.z], cloud.points.dtype)
        vec = center[None, :] - cloud.points
        norm = jnp.linalg.norm(vec, axis=-1, keepdims=True)
        direction = vec / jnp.maximum(norm, 1e-12)
        return cloud.with_descriptor("observationDirections", direction)
    if isinstance(cfg, SurfaceNormal):
        return compute_normals(cloud, knn=cfg.knn, orient=cfg.orient,
                               tile_query=cfg.tile_query)
    if isinstance(cfg, Shadow):
        if "normals" not in cloud.descriptors or \
                "observationDirections" not in cloud.descriptors:
            return cloud
        cos = jnp.abs(jnp.sum(cloud.descriptors["normals"]
                              * cloud.descriptors["observationDirections"],
                              axis=-1))
        return cloud.replace(mask=cloud.mask & (cos >= cfg.eps))
    if isinstance(cfg, MaxDensity):
        return _max_density(cfg, cloud)
    if isinstance(cfg, FixStepSampling):
        rank = jnp.cumsum(cloud.mask.astype(jnp.int32)) - 1
        return cloud.replace(mask=cloud.mask & (rank % cfg.step == 0))
    raise TypeError(f"unknown filter config {type(cfg)}")


def _max_density(cfg: "MaxDensity", cloud: Cloud) -> Cloud:
    """Keep at most max_count points per voxel: race for slots
    [hash, 0..max_count) with scatter-min over slot-strided indices."""
    cell = jnp.floor(cloud.points / cfg.radius).astype(jnp.int32)
    h = (cell[:, 0] * 73856093) ^ (cell[:, 1] * 19349663) \
        ^ (cell[:, 2] * 83492791)
    h = jnp.abs(h) % cfg.hash_size
    n = cloud.capacity
    idx = jnp.arange(n, dtype=jnp.int32)
    keep = jnp.zeros((n,), bool)
    for _ in range(cfg.max_count):
        # Winner of this round per bucket: smallest not-yet-kept index.
        contender = jnp.where(cloud.mask & ~keep, idx, n)
        table = jnp.full((cfg.hash_size,), n, jnp.int32).at[h].min(contender)
        keep = keep | (table[h] == idx)
    return cloud.replace(mask=cloud.mask & keep)


def _dist_along(points, dim: int):
    if dim < 0:
        return jnp.linalg.norm(points, axis=-1)
    return jnp.abs(points[:, dim])


def _voxel_grid(cfg: VoxelGrid, cloud: Cloud) -> Cloud:
    pts = cloud.points / cfg.voxel_size
    cell = jnp.floor(pts).astype(jnp.int32)
    # 3D -> hash bucket (large odd primes; collisions only over-subsample).
    h = (cell[:, 0] * 73856093) ^ (cell[:, 1] * 19349663) ^ (cell[:, 2] * 83492791)
    h = jnp.abs(h) % cfg.hash_size
    n = cloud.capacity
    idx = jnp.arange(n, dtype=jnp.int32)
    # Invalid points race with index n (never wins).
    contender = jnp.where(cloud.mask, idx, n)
    if _voxel_method(cfg) == "sort":
        keep = _first_in_bucket_sort(h, contender, n)
    else:
        table = jnp.full((cfg.hash_size,), n, jnp.int32)
        table = table.at[h].min(contender)
        keep = table[h] == idx
    return cloud.replace(mask=cloud.mask & keep)


def _voxel_method(cfg: VoxelGrid) -> str:
    """Scatter-min vs sort-dedup backend selection.

    "auto" resolves to the scatter race everywhere: the sort form's XLA
    graph is large and slow to compile. "sort" remains available for
    scatter-hostile backends
    (bit-identical keep mask, regression-tested in
    test_cloud_ops.py::test_voxel_grid_sort_matches_scatter)."""
    method = getattr(cfg, "method", "auto")
    return "scatter" if method == "auto" else method


def _first_in_bucket_sort(h: jax.Array, contender: jax.Array,
                          n: int) -> jax.Array:
    """keep[i] = (i is the smallest valid index in its hash bucket) —
    bit-identical to the scatter-min race, computed with sorts and
    gathers only. Lexsort (bucket-major, contender-minor) puts each
    bucket's winning contender first in its run; a neighbour-compare
    marks run heads; the inverse permutation (itself obtained by sorting
    the permutation — not by a scatter, which would reintroduce the
    serialization this path exists to avoid) maps the marks back."""
    order = jnp.lexsort((contender, h))
    hs = jnp.take(h, order)
    cs = jnp.take(contender, order)
    head = jnp.concatenate([jnp.ones((1,), bool), hs[1:] != hs[:-1]])
    keep_sorted = head & (cs < n)
    inv = jnp.argsort(order)
    return jnp.take(keep_sorted, inv)


def compute_normals(cloud: Cloud, *, knn: int = 8, orient: bool = True,
                    tile_query: int = 4096) -> Cloud:
    """Per-point normal estimation: kNN within the cloud + 3x3 PCA.

    The smallest-eigenvalue eigenvector of the neighbourhood covariance is
    the surface normal. Invalid points get a zero normal.
    """
    pts = cloud.points
    matches = knn_brute_force(pts, cloud.mask, pts, cloud.mask,
                              k=knn, tile_query=tile_query)
    neigh = jnp.take(pts, matches.ids, axis=0)                 # [N, k, 3]
    valid = jnp.isfinite(matches.dists2)                       # [N, k]
    w = valid.astype(pts.dtype)
    cnt = jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1.0)
    mean = jnp.sum(neigh * w[..., None], axis=-2) / cnt        # [N, 3]
    centered = (neigh - mean[:, None, :]) * w[..., None]
    cov = jnp.einsum("nki,nkj->nij", centered, centered) / cnt[..., None]
    # Regularize so eigh is well-conditioned on degenerate neighbourhoods.
    cov = cov + 1e-9 * jnp.eye(3, dtype=pts.dtype)
    eigvals, eigvecs = jnp.linalg.eigh(cov)                    # ascending
    normal = eigvecs[..., 0]                                   # [N, 3]
    if orient and "observationDirections" in cloud.descriptors:
        obs = cloud.descriptors["observationDirections"]
        flip = jnp.sum(normal * obs, axis=-1, keepdims=True) < 0.0
        normal = jnp.where(flip, -normal, normal)
    normal = jnp.where(cloud.mask[:, None], normal, 0.0)
    out = cloud.with_descriptor("normals", normal)
    # Surface curvature descriptor (lambda_min / trace), cheap and useful.
    curv = eigvals[..., 0] / jnp.maximum(jnp.sum(eigvals, axis=-1), 1e-12)
    return out.with_descriptor(
        "surfaceCurvature",
        jnp.where(cloud.mask, curv, 0.0)[:, None])


def apply_chain(chain: Chain, cloud: Cloud,
                key: Optional[jax.Array] = None) -> Cloud:
    """Apply a filter chain in order. ``key`` seeds stochastic filters;
    defaults to a fixed key for reproducibility."""
    if key is None:
        key = jax.random.PRNGKey(0)
    for i, cfg in enumerate(chain):
        cloud = _apply_one(cfg, cloud, jax.random.fold_in(key, i))
    return cloud


@functools.partial(jax.jit, static_argnames=("chain",))
def apply_chain_jit(chain: Chain, cloud: Cloud, key: jax.Array) -> Cloud:
    """One-dispatch jitted filter chain. Eager chains issue one device
    dispatch per primitive, which dominates wall time on remote-attached
    accelerators; this folds the whole chain into a single call."""
    return apply_chain(chain, cloud, key)


def compact(cloud: Cloud, capacity: Optional[int] = None) -> Cloud:
    """Push valid points to the front and optionally shrink capacity.

    Stable (preserves input order among valid points); rows beyond the
    surviving count are zero-filled with mask False. Jit-friendly:
    output capacity is static.

    Implemented as a cumsum-rank scatter rather than stable-argsort +
    row-gather: the scatter form is one cumsum plus one drop-mode
    scatter, and large sort graphs compile slowly (see VoxelGrid's
    "sort" method note). This sits on the per-scan hot path (reading prep
    of every registration).
    """
    cap = (cloud.capacity if capacity is None
           else min(capacity, cloud.capacity))
    rank = jnp.cumsum(cloud.mask.astype(jnp.int32)) - 1
    # Valid rows scatter to their rank; invalid rows (dest=cap) and
    # rank-overflow rows (rank >= cap: more survivors than capacity —
    # extra valid points are dropped, per the Compact contract) fall
    # out via mode="drop".
    dest = jnp.where(cloud.mask, rank, cap)

    def put(a):
        out = jnp.zeros((cap,) + a.shape[1:], a.dtype)
        return out.at[dest].set(a, mode="drop")

    n_valid = jnp.minimum(jnp.sum(cloud.mask.astype(jnp.int32)), cap)
    mask_out = jnp.arange(cap, dtype=jnp.int32) < n_valid
    return Cloud(points=put(cloud.points), mask=mask_out,
                 descriptors={k: put(v)
                              for k, v in cloud.descriptors.items()})
