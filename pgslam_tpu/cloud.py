"""Fixed-shape padded point-cloud container — the analog of
libpointmatcher's ``DataPoints`` (reference: ``types.h:20``, concatenation at
``LocalMap.hpp:222``, emptiness check at ``LocalMap.hpp:85``).

Where ``DataPoints`` stores a dynamic 4xN homogeneous feature matrix plus
named descriptor rows, a :class:`Cloud` stores:

* ``points``  — ``[N_max, 3]`` float array, padded with zeros,
* ``mask``    — ``[N_max]`` bool validity mask (True = real point),
* ``descriptors`` — dict of named ``[N_max, D]`` channels (``normals``,
  ``observationDirections``, ...).

Every shape is static, so any pipeline built on Clouds compiles once and
never recompiles as real point counts vary — the core fixed-shape discipline
of this rebuild.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .utils.pytree import pytree_dataclass

# Descriptor channels that rotate with the cloud (unit direction fields).
ROTATED_DESCRIPTORS = ("normals", "observationDirections", "eigVectors")

# Fixed-point protocol: a Cloud whose ``points`` are int16 is MILLIMETER
# fixed point (the KITTI-native grid; +-32.767 m envelope, 0.5 mm max
# round-off vs ~10 mm LiDAR range noise). Packed clouds halve
# host->device bytes — the lever for transfer-bound live SLAM — and
# every jitted ingest path
# dequantizes them in-graph via :func:`dequantize_cloud`.
MM_SCALE = 1000.0


def dequantize_cloud(cloud: Cloud, dtype=jnp.float32) -> Cloud:
    """In-graph dequantization of an int16 millimeter cloud; identity for
    float clouds (the branch is static: dtype is part of the jit key)."""
    if cloud.points.dtype != jnp.int16:
        return cloud
    return cloud.replace(
        points=cloud.points.astype(dtype) * (1.0 / MM_SCALE))


@pytree_dataclass
class Cloud:
    """Padded point cloud. A pytree; safe under jit/vmap/scan."""

    points: jax.Array            # [N, 3]
    mask: jax.Array              # [N] bool
    descriptors: Dict[str, jax.Array] = dataclasses.field(default_factory=dict)

    @property
    def capacity(self) -> int:
        return self.points.shape[-2]

    def count(self) -> jax.Array:
        """Number of valid points (traced scalar)."""
        return jnp.sum(self.mask, axis=-1)

    def is_empty(self) -> jax.Array:
        """Analog of ``DataPoints.features.cols() == 0`` (LocalMap.hpp:85)."""
        return self.count() == 0

    def has(self, name: str) -> bool:
        return name in self.descriptors

    def descriptor(self, name: str) -> jax.Array:
        return self.descriptors[name]

    def with_descriptor(self, name: str, value: jax.Array) -> "Cloud":
        new = dict(self.descriptors)
        new[name] = value
        return self.replace(descriptors=new)

    def masked_points(self, fill: float = 0.0) -> jax.Array:
        return jnp.where(self.mask[..., None], self.points,
                         jnp.full_like(self.points, fill))


def make_cloud(points, mask=None, descriptors=None, capacity: Optional[int] = None,
               dtype=jnp.float32) -> Cloud:
    """Build a Cloud from a (possibly unpadded) point array.

    ``capacity`` pads/truncates to a fixed size. Host-side helper (uses
    numpy); do not call under jit.
    """
    if np.asarray(points).dtype == np.int16 and dtype == jnp.float32:
        # int16 points are the packed millimeter protocol (MM_SCALE):
        # keep them packed — the jitted ingest dequantizes in-graph, and
        # upcasting here would forfeit the halved h2d bytes.
        dtype = jnp.int16
        if descriptors:
            raise ValueError("int16 (mm fixed-point) clouds cannot carry "
                             "descriptors")
    np_dt = np.dtype(jnp.dtype(dtype))   # keep fp64 inputs fp64 end-to-end
    pts = np.asarray(points, dtype=np_dt)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"points must be [N, 3], got {pts.shape}")
    n = pts.shape[0]
    if mask is None:
        m = np.ones((n,), dtype=bool)
    else:
        m = np.asarray(mask, dtype=bool)
    descriptors = dict(descriptors or {})
    if capacity is None:
        capacity = n
    if n > capacity:
        raise ValueError(f"{n} points exceed capacity {capacity}")
    pad = capacity - n
    if pad:
        pts = np.concatenate([pts, np.zeros((pad, 3), np_dt)], axis=0)
        m = np.concatenate([m, np.zeros((pad,), bool)], axis=0)
        descriptors = {
            k: np.concatenate(
                [np.asarray(v, np_dt),
                 np.zeros((pad,) + np.asarray(v).shape[1:], np_dt)], axis=0)
            for k, v in descriptors.items()
        }
    return Cloud(points=jnp.asarray(pts, dtype=dtype),
                 mask=jnp.asarray(m),
                 descriptors={k: jnp.asarray(v, dtype=dtype)
                              for k, v in descriptors.items()})


def empty_cloud(capacity: int, descriptor_spec: Optional[Dict[str, int]] = None,
                dtype=jnp.float32) -> Cloud:
    """All-padding cloud of a given capacity."""
    desc = {name: jnp.zeros((capacity, dim), dtype=dtype)
            for name, dim in (descriptor_spec or {}).items()}
    return Cloud(points=jnp.zeros((capacity, 3), dtype=dtype),
                 mask=jnp.zeros((capacity,), dtype=bool),
                 descriptors=desc)


def transform_cloud(T: jax.Array, cloud: Cloud) -> Cloud:
    """Apply a rigid transform to a cloud; rotates direction descriptors.

    Equivalent of libpointmatcher's ``RigidTransformation::compute``
    (created at ``LocalMap.hpp:37``, applied at ``Localizer.hpp:106``).
    Jit-friendly.
    """
    from . import se3

    pts = se3.apply(T, cloud.points)
    desc = {}
    for name, value in cloud.descriptors.items():
        if name in ROTATED_DESCRIPTORS and value.shape[-1] == 3:
            desc[name] = se3.rotate(T, value)
        else:
            desc[name] = value
    return cloud.replace(points=pts, descriptors=desc)


_transform_cloud_jit = None


def transform_cloud_jit(T: jax.Array, cloud: Cloud) -> Cloud:
    """Jitted :func:`transform_cloud` (one dispatch instead of several)."""
    global _transform_cloud_jit
    if _transform_cloud_jit is None:
        _transform_cloud_jit = jax.jit(transform_cloud)
    return _transform_cloud_jit(T, cloud)


def concatenate_clouds(clouds: Sequence[Cloud]) -> Cloud:
    """Concatenate along the point axis (``DataPoints::concatenate`` analog,
    ``LocalMap.hpp:222``). Output capacity = sum of input capacities.

    Descriptors: union of keys; missing channels are zero-filled so shapes
    stay static.
    """
    keys = sorted({k for c in clouds for k in c.descriptors})
    pts = jnp.concatenate([c.points for c in clouds], axis=0)
    mask = jnp.concatenate([c.mask for c in clouds], axis=0)
    desc = {}
    for k in keys:
        dim = next(c.descriptors[k].shape[-1] for c in clouds if k in c.descriptors)
        parts = []
        for c in clouds:
            if k in c.descriptors:
                parts.append(c.descriptors[k])
            else:
                parts.append(jnp.zeros((c.capacity, dim), dtype=pts.dtype))
        desc[k] = jnp.concatenate(parts, axis=0)
    return Cloud(points=pts, mask=mask, descriptors=desc)


def stack_clouds(clouds: Sequence[Cloud]) -> Cloud:
    """Stack equal-capacity clouds along a new leading batch axis."""
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs, axis=0), *clouds)


def pad_cloud(cloud: Cloud, capacity: int) -> Cloud:
    """Grow a cloud's capacity with padding (jit-friendly: static sizes)."""
    extra = capacity - cloud.capacity
    if extra < 0:
        raise ValueError("pad_cloud cannot shrink")
    if extra == 0:
        return cloud
    pts = jnp.concatenate(
        [cloud.points, jnp.zeros((extra, 3), cloud.points.dtype)], axis=0)
    mask = jnp.concatenate([cloud.mask, jnp.zeros((extra,), bool)], axis=0)
    desc = {k: jnp.concatenate(
        [v, jnp.zeros((extra, v.shape[-1]), v.dtype)], axis=0)
        for k, v in cloud.descriptors.items()}
    return Cloud(points=pts, mask=mask, descriptors=desc)
