"""Pose-graph store + MapManager — single-writer host state.

Replacement for the reference's Boost.Graph ``adjacency_list``
(``types.h:57``) and ``MapManager`` (``MapManager.h:17-65``,
``MapManager.hpp``). Instead of a pointer-based graph we keep a
struct-of-arrays layout (poses ``[V, 4, 4]``, edge endpoint ids ``[E, 2]``,
measurements ``[E, 4, 4]``, covariances ``[E, 6, 6]``) that exports
directly to device for vectorized distance queries and the jitted
pose-graph optimizer — no per-vertex host loops on the hot paths.

Vertices are integer ids (0..n-1, insertion order), which also matches the
reference's sequential ``Keyframe::id`` assignment (``MapManager.hpp:50``).
``update_time`` is a monotonically increasing integer stamp; the reference
uses wall-clock timestamps but only ever *compares* them for staleness
(``LocalMap.hpp:169-183``), so ordering is all that matters.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import jax.numpy as jnp
import numpy as np

from ..cloud import Cloud

ODOM_CONSTRAINT = 0   # Constraint::kOdomConstraint (types.h:42-45)
LOOP_CONSTRAINT = 1   # Constraint::kLoopConstraint


@dataclasses.dataclass
class Keyframe:
    """Vertex payload snapshot (``types.h:32-38``)."""

    id: int
    cloud: Cloud
    T_world_kf: np.ndarray            # [4, 4] pose at creation
    optimized_T_world_kf: np.ndarray  # [4, 4] current best pose
    update_time: int


class PoseGraph:
    """Growable struct-of-arrays pose graph.

    Arrays are numpy on the host (the single writer); device exports are
    produced on demand. Capacities grow by doubling so jitted consumers see
    a small number of distinct static shapes.
    """

    def __init__(self, initial_vertex_capacity: int = 64,
                 initial_edge_capacity: int = 128):
        self.n_vertices = 0
        self.n_edges = 0
        vc, ec = initial_vertex_capacity, initial_edge_capacity
        self.poses = np.zeros((vc, 4, 4), np.float32)
        self.optimized_poses = np.zeros((vc, 4, 4), np.float32)
        self.update_times = np.zeros((vc,), np.int64)
        self.clouds: List[Optional[Cloud]] = []
        self.edge_from = np.zeros((ec,), np.int32)
        self.edge_to = np.zeros((ec,), np.int32)
        self.edge_T = np.zeros((ec, 4, 4), np.float32)
        self.edge_cov = np.zeros((ec, 6, 6), np.float32)
        self.edge_type = np.zeros((ec,), np.int32)
        self.edge_weight = np.zeros((ec,), np.float32)
        # Device-mirror bookkeeping (optim/resident.py): poses written
        # through update_keyframe_transform land here so the resident
        # optimizer uploads only what changed; any NON-append mutation
        # (e.g. checkpoint restore) must bump mutation_epoch, which
        # invalidates every mirror.
        self.pose_dirty: set = set()
        self.mutation_epoch = 0

    # -- growth ------------------------------------------------------------

    def _ensure_vertex_capacity(self, n: int):
        cap = self.poses.shape[0]
        if n <= cap:
            return
        new = max(cap * 2, n)
        self.poses = _grow(self.poses, new)
        self.optimized_poses = _grow(self.optimized_poses, new)
        self.update_times = _grow(self.update_times, new)

    def _ensure_edge_capacity(self, n: int):
        cap = self.edge_from.shape[0]
        if n <= cap:
            return
        new = max(cap * 2, n)
        self.edge_from = _grow(self.edge_from, new)
        self.edge_to = _grow(self.edge_to, new)
        self.edge_T = _grow(self.edge_T, new)
        self.edge_cov = _grow(self.edge_cov, new)
        self.edge_type = _grow(self.edge_type, new)
        self.edge_weight = _grow(self.edge_weight, new)

    # -- mutation ----------------------------------------------------------

    def add_vertex(self, cloud: Cloud, T_world_kf, update_time: int) -> int:
        v = self.n_vertices
        self._ensure_vertex_capacity(v + 1)
        self.poses[v] = np.asarray(T_world_kf, np.float32)
        self.optimized_poses[v] = np.asarray(T_world_kf, np.float32)
        self.update_times[v] = update_time
        self.clouds.append(cloud)
        self.n_vertices += 1
        return v

    def add_edge(self, u: int, v: int, T_from_to, cov, etype: int) -> int:
        if self.has_edge(u, v):
            # Mirrors the reference's duplicate-edge guard
            # (MapManager.hpp:88,122).
            raise ValueError(f"edge ({u}, {v}) already exists in the graph")
        e = self.n_edges
        self._ensure_edge_capacity(e + 1)
        self.edge_from[e] = u
        self.edge_to[e] = v
        T = np.asarray(T_from_to, np.float32)
        self.edge_T[e] = T
        self.edge_cov[e] = np.asarray(cov, np.float32)
        self.edge_type[e] = etype
        # Host-side translation norm (== metrics.weight, metrics.hpp:20-24):
        # the eager-jnp form costs a full device round-trip per edge insert
        # inside every keyframe spawn.
        self.edge_weight[e] = float(np.linalg.norm(T[:3, 3]))
        self.n_edges += 1
        return e

    def has_edge(self, u: int, v: int) -> bool:
        f = self.edge_from[:self.n_edges]
        t = self.edge_to[:self.n_edges]
        return bool(np.any(((f == u) & (t == v)) | ((f == v) & (t == u))))

    # -- queries -----------------------------------------------------------

    def keyframe(self, v: int) -> Keyframe:
        """Snapshot of vertex payload (copy semantics, like ``graph_[v]``)."""
        return Keyframe(id=v, cloud=self.clouds[v],
                        T_world_kf=self.poses[v].copy(),
                        optimized_T_world_kf=self.optimized_poses[v].copy(),
                        update_time=int(self.update_times[v]))

    def adjacent_vertices(self, v: int) -> np.ndarray:
        """Neighbors of v (``boost::adjacent_vertices``, Localizer.hpp:400)."""
        f = self.edge_from[:self.n_edges]
        t = self.edge_to[:self.n_edges]
        out = np.concatenate([t[f == v], f[t == v]])
        return np.unique(out)

    def edges_between(self, vertex_set) -> np.ndarray:
        """Edge indices with both endpoints inside ``vertex_set``."""
        vs = np.asarray(sorted(vertex_set))
        f = self.edge_from[:self.n_edges]
        t = self.edge_to[:self.n_edges]
        keep = np.isin(f, vs) & np.isin(t, vs)
        return np.nonzero(keep)[0]

    # -- device exports ----------------------------------------------------

    def device_poses(self, optimized: bool = True):
        arr = self.optimized_poses if optimized else self.poses
        return jnp.asarray(arr[:self.n_vertices])

    def device_edges(self):
        e = self.n_edges
        return (jnp.asarray(self.edge_from[:e]), jnp.asarray(self.edge_to[:e]),
                jnp.asarray(self.edge_T[:e]), jnp.asarray(self.edge_cov[:e]),
                jnp.asarray(self.edge_type[:e]),
                jnp.asarray(self.edge_weight[:e]))


def _grow(arr: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((n,) + arr.shape[1:], arr.dtype)
    out[:arr.shape[0]] = arr
    return out


class MapManager:
    """Sole owner of the pose graph + observer hub (``MapManager.h:17-65``).

    Holds back-references to the Localizer and LoopCloser and pushes
    notifications both ways, mirroring ``MapManager.hpp:96-100`` (new
    keyframe -> LoopCloser) and ``MapManager.hpp:150-157`` (optimization
    writeback -> Localizer).
    """

    def __init__(self):
        self.graph = PoseGraph()
        self.fixed_vertex: Optional[int] = None
        self._clock = 0
        self._localizers: List = []  # weak-ref analog (MapManager.h:61-63)
        self._loop_closer = None

    # -- wiring ------------------------------------------------------------

    def set_localizer(self, localizer) -> None:
        self._localizers = [localizer]

    def add_localizer(self, localizer) -> None:
        """Register an additional observer (multi-agent: several
        Localizers share one graph and all must resync after
        optimization writeback)."""
        self._localizers.append(localizer)

    def set_loop_closer(self, loop_closer) -> None:
        self._loop_closer = loop_closer

    def get_graph(self) -> PoseGraph:
        return self.graph

    def get_fixed_vertex(self) -> int:
        return self.fixed_vertex

    def now(self) -> int:
        self._clock += 1
        return self._clock

    # -- mutating API (MapManager.h:43-48) ---------------------------------

    def add_first_keyframe(self, cloud: Cloud, T_world_kf) -> int:
        """``MapManager.hpp:46-62``: first vertex becomes the optimization
        anchor."""
        v = self.graph.add_vertex(cloud, T_world_kf, self.now())
        if self.fixed_vertex is None:   # multi-agent: first agent anchors
            self.fixed_vertex = v
        return v

    def add_new_keyframe(self, from_v: int, T_world_newkf, meas_T_from_newkf,
                         meas_cov_from_newkf, cloud: Cloud) -> int:
        """``MapManager.hpp:65-105``: vertex + odometry edge + LoopCloser
        notification."""
        if not (0 <= from_v < self.graph.n_vertices):
            raise ValueError("AddNewKeyframe: vertex 'from' must exist")
        from ..utils import counters
        counters["map/keyframes"] += 1
        v = self.graph.add_vertex(cloud, T_world_newkf, self.now())
        self.graph.add_edge(from_v, v, meas_T_from_newkf,
                            meas_cov_from_newkf, ODOM_CONSTRAINT)
        if self._loop_closer is not None:
            self._loop_closer.add_new_vertex(v)
        return v

    def add_loop_closing_constraint(self, from_v: int, to_v: int, T_from_to,
                                    cov_from_to) -> None:
        """``MapManager.hpp:115-127``."""
        self.graph.add_edge(from_v, to_v, T_from_to, cov_from_to,
                            LOOP_CONSTRAINT)

    def update_keyframe_transform(self, v: int, T, update_time: int) -> None:
        """``MapManager.hpp:130-134``: optimizer writeback."""
        self.graph.optimized_poses[v] = np.asarray(T, np.float32)
        self.graph.update_times[v] = update_time
        self.graph.pose_dirty.add(int(v))

    def update_keyframe_transforms_bulk(self, poses: np.ndarray,
                                        update_time: int,
                                        mark_dirty: bool = True) -> None:
        """Vectorized writeback of vertices ``0..len(poses)`` — the
        optimizer's batch path (the per-vertex loop is O(V) Python per
        optimize: ~tens of ms at 16k poses on the shared host core).
        ``mark_dirty=False`` is for the device-resident optimizer, whose
        writes come FROM the device mirror and need no re-upload."""
        n = len(poses)
        self.graph.optimized_poses[:n] = np.asarray(poses, np.float32)
        self.graph.update_times[:n] = update_time
        if mark_dirty:
            self.graph.pose_dirty.update(range(n))

    def notify_keyframe_update(self) -> None:
        """``MapManager.hpp:150-157``: tell the Localizer poses moved."""
        for localizer in self._localizers:
            localizer.update_from_graph()

    def drain_loop_closer(self) -> None:
        """Consume any deferred loop-closure verifications (the
        LoopCloser's ``deferred_verification`` mode). Called by the
        localizer at the start of the next scan's window so the
        verification's d2h sync overlaps fresh device work."""
        lc = self._loop_closer
        if lc is not None and getattr(lc, "_deferred", None):
            lc.drain_deferred()

    # -- export ------------------------------------------------------------

    def write_graphviz(self, path: str) -> None:
        """DOT dump of the graph topology (``MapManager.hpp:137-147``)."""
        g = self.graph
        lines = ["graph G {"]
        for v in range(g.n_vertices):
            lines.append(f"{v} [label={v}];")
        for e in range(g.n_edges):
            attr = "" if g.edge_type[e] == ODOM_CONSTRAINT else " [style=dashed]"
            lines.append(f"{g.edge_from[e]}--{g.edge_to[e]}{attr};")
        lines.append("}")
        with open(path, "w") as fh:
            fh.write("\n".join(lines) + "\n")
