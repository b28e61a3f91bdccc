"""LocalMap — the sliding-window submap the robot localizes against.

Rebuild of ``LocalMap.h/hpp``: a circular buffer of up to N keyframe
(vertex, payload-snapshot) pairs (``LocalMap.h:13-20``) plus the
concatenated cloud expressed in the *reference keyframe*'s frame — the
reference keyframe being the LAST element of the buffer
(``LocalMap.hpp:111-120``). Staleness is tracked by comparing snapshot
``update_time`` stamps against the live graph (``LocalMap.hpp:169-183``).

The cloud build (``BuildCloudFromData``, ``LocalMap.hpp:209-224``) is a
single jitted kernel over stacked fixed-capacity keyframe clouds, so a
composition change costs one device dispatch regardless of window size.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import se3
from .cloud import Cloud
from .graph.pose_graph import Keyframe, PoseGraph


class Composition:
    """Vertex-id circular buffer (boost::circular_buffer semantics):
    ``push_back`` evicts the *front* once capacity is reached. The back is
    the reference keyframe."""

    def __init__(self, capacity: int, items: Sequence[int] = ()):
        self.capacity = int(capacity)
        self._items: List[int] = []
        for v in items:
            self.push_back(v)

    def push_back(self, v: int) -> None:
        self._items.append(int(v))
        if len(self._items) > self.capacity:
            self._items.pop(0)

    def clear(self) -> None:
        self._items.clear()

    def back(self) -> int:
        return self._items[-1]

    def __iter__(self):
        return iter(self._items)

    def __len__(self):
        return len(self._items)

    def __contains__(self, v) -> bool:
        return int(v) in self._items

    def __getitem__(self, i):
        return self._items[i]

    def __repr__(self):
        return f"Composition(cap={self.capacity}, {self._items})"

    def copy(self) -> "Composition":
        return Composition(self.capacity, self._items)

    def as_list(self) -> List[int]:
        return list(self._items)


def _build_cloud_impl(points, masks, descs, T_refkf_kf, slot_valid,
                      desc_keys: Tuple[str, ...]):
    """Transform each keyframe cloud into the reference frame and flatten.

    points [C, N, 3], masks [C, N], descs {k: [C, N, D]},
    T_refkf_kf [C, 4, 4], slot_valid [C] -> flat arrays [C*N, ...].
    """
    pts = se3.apply(T_refkf_kf, points)                    # [C, N, 3]
    mask = masks & slot_valid[:, None]
    out_desc = {}
    for k in desc_keys:
        v = descs[k]
        if k in ("normals", "observationDirections", "eigVectors") \
                and v.shape[-1] == 3:
            v = se3.rotate(T_refkf_kf, v)
        out_desc[k] = v.reshape(-1, v.shape[-1])
    return (pts.reshape(-1, 3), mask.reshape(-1), out_desc)


_build_cloud_kernel = functools.partial(
    jax.jit, static_argnames=("desc_keys",))(_build_cloud_impl)


def stack_composition(graph: PoseGraph, comp_ids, capacity: int):
    """Stack a composition's keyframe clouds + relative transforms into the
    fixed-shape inputs of :func:`_build_cloud_kernel`.

    Returns (points [C,N,3], masks [C,N], descs, T_refkf_kf [C,4,4],
    slot_valid [C], desc_keys, T_world_ref [4,4]).
    """
    return stack_keyframes([graph.keyframe(v) for v in comp_ids], capacity)


def stack_keyframes(kfs, capacity: int):
    """Stack keyframe snapshots (see :func:`stack_composition`)."""
    ref = kfs[-1]
    C = capacity
    T_ref = np.asarray(ref.optimized_T_world_kf, np.float64)
    T_refkf_world = np.linalg.inv(T_ref)
    caps = {kf.cloud.capacity for kf in kfs}
    if len(caps) != 1:
        raise ValueError(
            f"composition requires equal keyframe cloud capacities: {caps}")
    n = caps.pop()
    desc_keys = tuple(sorted(kfs[0].cloud.descriptors.keys()))

    def pad(arrs, fill):
        return arrs + [fill] * (C - len(arrs))

    points = jnp.stack(pad([kf.cloud.points for kf in kfs],
                           jnp.zeros((n, 3), jnp.float32)))
    masks = jnp.stack(pad([kf.cloud.mask for kf in kfs],
                          jnp.zeros((n,), bool)))
    descs = {}
    for k in desc_keys:
        d = kfs[0].cloud.descriptors[k].shape[-1]
        descs[k] = jnp.stack(pad([kf.cloud.descriptors[k] for kf in kfs],
                                 jnp.zeros((n, d), jnp.float32)))
    Ts = jnp.asarray(np.stack(pad(
        [(T_refkf_world @ np.asarray(kf.optimized_T_world_kf, np.float64)
          ).astype(np.float32) for kf in kfs],
        np.eye(4, dtype=np.float32))))
    slot_valid = jnp.asarray([True] * len(kfs) + [False] * (C - len(kfs)))
    return (points, masks, descs, Ts, slot_valid, desc_keys,
            T_ref.astype(np.float32))


def stack_compositions(graph: PoseGraph, ids_list, capacity: int):
    """Stack M compositions' keyframe payloads into ``[M, C, ...]`` build
    inputs with ONE ``jnp.stack`` per leaf across all M*C slots (the
    per-composition :func:`stack_composition` loop pays ~5 eager device
    ops per composition).

    Returns (points [M,C,N,3], masks, descs, Ts, slot_valid, desc_keys,
    T_world_refs [M,4,4] host numpy)."""
    M = len(ids_list)
    C = capacity
    kf0 = graph.keyframe(ids_list[0][-1])
    ncap = kf0.cloud.capacity
    desc_keys = tuple(sorted(kf0.cloud.descriptors.keys()))
    zero_pts = jnp.zeros((ncap, 3), jnp.float32)
    zero_mask = jnp.zeros((ncap,), bool)
    zero_desc = {k: jnp.zeros((ncap, kf0.cloud.descriptors[k].shape[-1]),
                              jnp.float32) for k in desc_keys}

    pts_l, mask_l, Ts_l, valid_l, T_refs = [], [], [], [], []
    desc_l = {k: [] for k in desc_keys}
    for ids in ids_list:
        kfs = [graph.keyframe(v) for v in ids]
        T_ref = np.asarray(kfs[-1].optimized_T_world_kf, np.float64)
        T_refs.append(T_ref.astype(np.float32))
        T_refkf_world = np.linalg.inv(T_ref)
        for kf in kfs:
            pts_l.append(kf.cloud.points)
            mask_l.append(kf.cloud.mask)
            for k in desc_keys:
                desc_l[k].append(kf.cloud.descriptors[k])
            Ts_l.append((T_refkf_world
                         @ np.asarray(kf.optimized_T_world_kf, np.float64)
                         ).astype(np.float32))
        for _ in range(C - len(kfs)):
            pts_l.append(zero_pts)
            mask_l.append(zero_mask)
            for k in desc_keys:
                desc_l[k].append(zero_desc[k])
            Ts_l.append(np.eye(4, dtype=np.float32))
        valid_l += [True] * len(kfs) + [False] * (C - len(kfs))

    points = jnp.stack(pts_l).reshape(M, C, ncap, 3)
    masks = jnp.stack(mask_l).reshape(M, C, ncap)
    descs = {k: jnp.stack(v).reshape(M, C, ncap, -1)
             for k, v in desc_l.items()}
    Ts = jnp.asarray(np.stack(Ts_l).reshape(M, C, 4, 4))
    slot_valid = jnp.asarray(np.asarray(valid_l).reshape(M, C))
    return (points, masks, descs, Ts, slot_valid, desc_keys,
            np.stack(T_refs))


def batch_rebuild(local_maps, pad_to: int = 0,
                  return_stacked: bool = False) -> Optional[Cloud]:
    """Rebuild several LocalMaps' clouds in ONE vmapped device dispatch
    (multi-agent path). All maps must share capacity / keyframe cloud
    capacity / descriptor keys (same pipeline config guarantees this).

    The batch is padded (repeating the first entry) to ``pad_to`` when
    given, else to a power-of-two bucket — a single fixed batch shape
    beats per-size recompiles even at the cost of padded compute.

    Assembly cost discipline (every eager op pays a dispatch): keyframe
    payloads stack with ONE
    ``jnp.stack`` per leaf across all maps*slots (not per map), and the
    per-map output clouds are sliced INSIDE the jitted build (one
    executable writes all per-map buffers) instead of ``bucket × leaves``
    eager slice dispatches after it.

    With ``return_stacked=True`` also returns the batched cloud
    ``[bucket, C*N, ...]`` (the loop closer feeds it straight into the
    fleet verification dispatch without re-stacking per-map slices)."""
    if not local_maps:
        return None
    if len(local_maps) == 1 and pad_to <= 1 and not return_stacked:
        local_maps[0]._build_cloud()
        return None
    n = len(local_maps)
    bucket = max(pad_to, 1 << (n - 1).bit_length())
    lms = list(local_maps) + [local_maps[0]] * (bucket - n)

    C = local_maps[0]._capacity
    kf0 = local_maps[0]._data[-1][1]
    ncap = kf0.cloud.capacity
    desc_keys = tuple(sorted(kf0.cloud.descriptors.keys()))
    zero_pts = jnp.zeros((ncap, 3), jnp.float32)
    zero_mask = jnp.zeros((ncap,), bool)
    zero_desc = {k: jnp.zeros((ncap, kf0.cloud.descriptors[k].shape[-1]),
                              jnp.float32) for k in desc_keys}

    pts_l, mask_l, Ts_l, valid_l = [], [], [], []
    desc_l = {k: [] for k in desc_keys}
    for lm in lms:
        if lm._capacity != C:
            raise ValueError("batch_rebuild requires equal map capacities")
        kfs = [kf for _, kf in lm._data]
        T_ref = np.asarray(kfs[-1].optimized_T_world_kf, np.float64)
        T_refkf_world = np.linalg.inv(T_ref)
        for kf in kfs:
            if kf.cloud.capacity != ncap:
                raise ValueError(
                    "batch_rebuild requires equal keyframe cloud capacities")
            pts_l.append(kf.cloud.points)
            mask_l.append(kf.cloud.mask)
            for k in desc_keys:
                desc_l[k].append(kf.cloud.descriptors[k])
            Ts_l.append((T_refkf_world
                         @ np.asarray(kf.optimized_T_world_kf, np.float64)
                         ).astype(np.float32))
        for _ in range(C - len(kfs)):
            pts_l.append(zero_pts)
            mask_l.append(zero_mask)
            for k in desc_keys:
                desc_l[k].append(zero_desc[k])
            Ts_l.append(np.eye(4, dtype=np.float32))
        valid_l += [True] * len(kfs) + [False] * (C - len(kfs))

    points = jnp.stack(pts_l).reshape(bucket, C, ncap, 3)
    masks = jnp.stack(mask_l).reshape(bucket, C, ncap)
    descs = {k: jnp.stack(v).reshape(bucket, C, ncap, -1)
             for k, v in desc_l.items()}
    Ts = jnp.asarray(np.stack(Ts_l).reshape(bucket, C, 4, 4))
    slot_valid = jnp.asarray(np.asarray(valid_l).reshape(bucket, C))

    batched, slices = _batched_build(points, masks, descs, Ts, slot_valid,
                                     desc_keys=desc_keys)
    for (pts_i, mask_i, descs_i), lm in zip(slices, local_maps):
        lm._cloud = Cloud(points=pts_i, mask=mask_i, descriptors=descs_i)
    if return_stacked:
        return Cloud(points=batched[0], mask=batched[1],
                     descriptors=batched[2])
    return None


@functools.partial(jax.jit, static_argnames=("desc_keys",))
def _batched_build(points, masks, descs, Ts, slot_valid, desc_keys):
    # Slices for EVERY padded batch entry, cut in-jit: callers take the
    # first k. Slicing all of them (vs a static n_out arg) keeps the jit
    # cache keyed on the padded shape alone — a varying count would
    # retrace + recompile per distinct live-set size.
    pts, mask, out_descs = jax.vmap(
        lambda p, m, d, t, s: _build_cloud_impl(p, m, d, t, s, desc_keys)
    )(points, masks, descs, Ts, slot_valid)
    slices = [(pts[i], mask[i], {k: v[i] for k, v in out_descs.items()})
              for i in range(pts.shape[0])]
    return (pts, mask, out_descs), slices


class LocalMap:
    """Sliding-window submap (``LocalMap.h:8-57``)."""

    def __init__(self, capacity: int):
        self._capacity = int(capacity)
        self._data: List[Tuple[int, Keyframe]] = []   # back = reference kf
        self._cloud: Optional[Cloud] = None

    # -- construction / refresh (LocalMap.hpp:55-80) -----------------------

    @classmethod
    def from_graph(cls, graph: PoseGraph, comp: Composition) -> "LocalMap":
        lm = cls(comp.capacity)
        lm.update_to_new_composition(graph, comp)
        return lm

    def update_to_new_composition(self, graph: PoseGraph, comp: Composition,
                                  build: bool = True) -> None:
        self._capacity = comp.capacity
        self._data = [(v, graph.keyframe(v)) for v in comp]
        if build:
            self._build_cloud()

    def update_from_graph(self, graph: PoseGraph, build: bool = True) -> None:
        """Refresh payload snapshots for the current vertices."""
        self._data = [(v, graph.keyframe(v)) for v, _ in self._data]
        if build:
            self._build_cloud()

    # -- basic accessors ---------------------------------------------------

    def capacity(self) -> int:
        return self._capacity

    def has_cloud(self) -> bool:
        return self._cloud is not None and len(self._data) > 0

    def cloud(self) -> Cloud:
        return self._cloud

    def cloud_in_world_frame(self) -> Cloud:
        """``LocalMap.hpp:95-98``."""
        from .cloud import transform_cloud_jit
        T = jnp.asarray(self.reference_keyframe().optimized_T_world_kf)
        return transform_cloud_jit(T, self._cloud)

    def get_composition(self) -> Composition:
        return Composition(self._capacity, [v for v, _ in self._data])

    def reference_vertex(self) -> int:
        return self._data[-1][0]

    def reference_keyframe(self) -> Keyframe:
        return self._data[-1][1]

    # -- composition comparison (LocalMap.hpp:123-166) ---------------------

    def has_same_vertex_set(self, comp: Composition) -> bool:
        return set(v for v, _ in self._data) == set(comp)

    def has_same_reference_vertex(self, comp: Composition) -> bool:
        return len(self._data) > 0 and len(comp) > 0 and \
            self._data[-1][0] == comp.back()

    def has_same_composition(self, comp: Composition) -> bool:
        return self.has_same_reference_vertex(comp) and \
            self.has_same_vertex_set(comp)

    # -- staleness (LocalMap.hpp:169-183) ----------------------------------

    def is_outdated(self, graph: PoseGraph) -> bool:
        return any(graph.update_times[v] > kf.update_time
                   for v, kf in self._data)

    def is_reference_keyframe_outdated(self, graph: PoseGraph) -> bool:
        v, kf = self._data[-1]
        return graph.update_times[v] > kf.update_time

    # -- queries (LocalMap.hpp:186-205) ------------------------------------

    def find_closest_vertex(self, T_world_x) -> int:
        """Nearest composition vertex to a world pose (translation metric,
        metrics.hpp:7-12). Host-side numpy: the window is tiny and a device
        round-trip here would cost more than the whole query."""
        T = np.asarray(T_world_x)
        d = [np.linalg.norm(kf.optimized_T_world_kf[:3, 3] - T[:3, 3])
             for _, kf in self._data]
        return self._data[int(np.argmin(d))][0]

    # -- cloud assembly (LocalMap.hpp:209-224) -----------------------------

    def _build_cloud(self) -> None:
        if not self._data:
            self._cloud = None
            return
        points, masks, descs, Ts, slot_valid, desc_keys, _ = \
            stack_keyframes([kf for _, kf in self._data], self._capacity)
        pts, mask, out_desc = _build_cloud_kernel(points, masks, descs, Ts,
                                                  slot_valid, desc_keys)
        self._cloud = Cloud(points=pts, mask=mask, descriptors=out_desc)
