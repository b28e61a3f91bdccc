"""Optimizer component — the back-end bridging the pose graph to the
jitted SE(3) LM solver.

Rebuild of ``Optimizer.h/hpp``: per batch of verified loop constraints it
(1) collects every existing graph edge plus the pending loop edges into a
factor set (``Optimizer.hpp:89-112``), (2) seeds initial values from the
current optimized poses (``:115-121``), (3) anchors the fixed vertex with a
sigma=1e-6 prior (``:124-130``), (4) runs Levenberg-Marquardt — here the
batched-PCG solver in :mod:`pgslam_tpu.optim.pgo` — and (5) writes the
results back, only then inserting the loop edges into the graph
(``:135-157``).

Covariance ordering: the reference converts PM's [t; r] to GTSAM's [r; t]
(``Optimizer.hpp:33-42``); our solver consumes PM order natively so no
conversion happens on the hot path. :func:`pm_cov_to_gtsam_cov` is kept
for interoperability/parity tests.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Tuple

import jax.numpy as jnp
import numpy as np

from .graph.pose_graph import MapManager
from .optim.pgo import PGOConfig, optimize_pose_graph

log = logging.getLogger("pgslam_tpu.optimizer")


def pm_cov_to_gtsamcov(mat: np.ndarray) -> np.ndarray:  # pragma: no cover
    return pm_cov_to_gtsam_cov(mat)


def pm_cov_to_gtsam_cov(mat: np.ndarray) -> np.ndarray:
    """Swap 3x3 sub-blocks: [t; r] order -> [r; t] order
    (``Optimizer.hpp:33-42``). Involutive."""
    out = np.empty_like(mat)
    out[..., :3, :3] = mat[..., 3:, 3:]
    out[..., 3:, 3:] = mat[..., :3, :3]
    out[..., 3:, :3] = mat[..., :3, 3:]
    out[..., :3, 3:] = mat[..., 3:, :3]
    return out


def _bucket(n: int, bucket: int) -> int:
    """Round up to the next power of two at least ``bucket`` wide.

    Power-of-two growth keeps the number of distinct jit shapes (each a
    PGO compile) logarithmic in the graph size."""
    return max(bucket, 1 << max(0, n - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    pgo: PGOConfig = PGOConfig()
    shape_bucket: int = 64
    # Device-resident graph mirror (optim/resident.py): keep the padded pose/edge arrays on device across optimize calls and
    # upload only deltas (appended vertices/edges + this batch's pending
    # constraints); the writeback downloads a packed pose vector. "auto"
    # enables it everywhere (the solve is the same jitted function, so
    # results are bit-identical to a rebuild); "off"
    # restores the full re-upload path. PGSLAM_PGO_RESIDENT=0 is the env
    # kill switch.
    resident: str = "auto"
    # Packed-writeback format: "exact12" ([V, 12] top-3x4 rows,
    # bit-identical round-trip), "quat7" ([V, 7] quat+translation, ~9x
    # fewer d2h bytes, ~1e-7 rotation round-off), or "auto" (exact12
    # below resident.QUAT_MIN_V padded vertices, quat7 at/above it).
    writeback_pack: str = "auto"


class Optimizer:
    """``Optimizer.h:13-55``."""

    def __init__(self, map_manager: MapManager,
                 config: OptimizerConfig = OptimizerConfig()):
        self.mm = map_manager
        self.config = config
        # (from, to, T_from_to, cov_from_to) pending loop constraints.
        self.data_buffer: List[Tuple[int, int, np.ndarray, np.ndarray]] = []
        self.last_stats = None
        # Multi-agent/MT batching: queue constraints and optimize once per
        # drain (OptimizerMT.hpp:59-62 drains ALL pending constraints per
        # optimization batch, vs the single-item ST path Optimizer.hpp:27-28).
        self.queue_mode = False
        self._mirror = None          # lazy ResidentPGO (see optim/resident)
        self._nv_snapshot = None     # vertex count at prepare time — the
        # writeback must not touch vertices appended mid-solve (the MT LM
        # runs unlocked, OptimizerMT.hpp:71-82; the padded result rows for
        # them are identity and would clobber real keyframe poses)

    # -- entry (Optimizer.hpp:25-30): single-item batch per call -----------

    def add_new_data(self, from_v: int, to_v: int, T_from_to,
                     cov_from_to) -> None:
        item = (int(from_v), int(to_v),
                np.asarray(T_from_to, np.float32),
                np.asarray(cov_from_to, np.float32))
        if self.queue_mode:
            self.data_buffer.append(item)
            return
        self.data_buffer = [item]
        self.process_data()

    def process_pending(self) -> None:
        """Drain every queued constraint in ONE optimization batch
        (``OptimizerMT.hpp:59-62`` semantics; the fleet path calls this
        once per step — each accepted closure otherwise pays a full LM
        solve)."""
        if self.data_buffer:
            self.process_data()

    def _resident_enabled(self) -> bool:
        import os
        if os.environ.get("PGSLAM_PGO_RESIDENT", "") == "0":
            return False
        return self.config.resident != "off"

    def process_data(self) -> None:
        log.info("[Optimizer] Building factor graph with %d new loop "
                 "closing factors", len(self.data_buffer))
        resident_failed = False
        if self._resident_enabled():
            # Device-resident path: delta prepare (locked in MT via the
            # prepare_for_optimization_resident override), one fused
            # delta-apply + solve dispatch, ONE packed d2h for poses +
            # stats (the classic path's per-stat float() fetches each
            # paid a device round-trip).
            log.info("[Optimizer] Optimizing using the factor graph")
            try:
                # The prepare is inside the fail-soft too: a host-side
                # bookkeeping error (stale dirty index, bucket mismatch)
                # must degrade to the classic path the same way a device
                # failure does. prepare consumes
                # pose_dirty, but the classic fallback rebuilds from
                # the full graph and invalidate() forces the mirror's
                # own full re-upload next call, so nothing is lost.
                prep = self.prepare_for_optimization_resident()
                new_poses, self.last_stats = self._mirror.execute(prep)
            except Exception as e:
                # Fail-soft: invalidate the mirror and run this batch
                # through the classic path — a slower optimize beats a
                # crashed SLAM loop. The dirty-pose snapshot the prepare
                # consumed is re-covered by the full rebuild either path
                # does next. Counted, so a run can assert it never
                # happened.
                from .utils import counters
                counters["optimizer/resident_fallbacks"] += 1
                log.warning("[Optimizer] resident optimize failed "
                            "(%s: %s) — falling back to the classic "
                            "path for this batch", type(e).__name__, e)
                if self._mirror is not None:   # prepare may have died
                    self._mirror.invalidate()  # before constructing it
                resident_failed = True
        if not self._resident_enabled() or resident_failed:
            poses, vmask, ef, et, eT, ec, emask, fixed, rmask = \
                self.prepare_for_optimization()
            log.info("[Optimizer] Optimizing using the factor graph")
            new_poses, stats = optimize_pose_graph(
                poses, vmask, ef, et, eT, ec, emask, fixed,
                robust_emask=rmask, config=self.config.pgo)
            self.last_stats = {k: float(np.asarray(v))
                               for k, v in stats.items()}
        log.info("[Optimizer] Updating graph poses and adding loop closing "
                 "edges (cost %.3e -> %.3e in %d iters)",
                 self.last_stats["initial_cost"],
                 self.last_stats["final_cost"],
                 int(self.last_stats["iterations"]))
        from .utils import counters
        counters["optimizer/runs"] += 1
        self.update_after_optimization(np.asarray(new_poses))
        log.info("[Optimizer] Finished")

    # -- factor assembly (Optimizer.hpp:80-132) ----------------------------

    def prepare_for_optimization_resident(self):
        """Delta snapshot for the device-resident mirror (graph reads
        only — the MT override takes the graph lock, exactly like
        prepare_for_optimization)."""
        if self._mirror is None:
            from .optim.resident import ResidentPGO
            self._mirror = ResidentPGO(self.config.pgo,
                                       shape_bucket=self.config.shape_bucket,
                                       pack=self.config.writeback_pack)
        g = self.mm.get_graph()
        self._nv_snapshot = g.n_vertices
        return self._mirror.prepare(g, self.mm.get_fixed_vertex(),
                                    self.data_buffer)

    def prepare_for_optimization(self):
        g = self.mm.get_graph()
        nv, ne = g.n_vertices, g.n_edges
        self._nv_snapshot = nv
        n_pending = len(self.data_buffer)
        V = _bucket(nv, self.config.shape_bucket)
        E = _bucket(ne + n_pending, self.config.shape_bucket)

        poses = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
        poses[:nv] = g.optimized_poses[:nv]          # initial values :115-121
        vmask = np.zeros(V, bool)
        vmask[:nv] = True

        ef = np.zeros(E, np.int32)
        et = np.zeros(E, np.int32)
        eT = np.tile(np.eye(4, dtype=np.float32), (E, 1, 1))
        ec = np.tile(np.eye(6, dtype=np.float32), (E, 1, 1))
        emask = np.zeros(E, bool)
        ef[:ne] = g.edge_from[:ne]                   # existing edges :89-97
        et[:ne] = g.edge_to[:ne]
        eT[:ne] = g.edge_T[:ne]
        ec[:ne] = g.edge_cov[:ne]
        emask[:ne] = True
        for k, (f, t, T, c) in enumerate(self.data_buffer):  # pending :100-112
            ef[ne + k], et[ne + k] = f, t
            eT[ne + k], ec[ne + k] = T, c
            emask[ne + k] = True

        fixed = jnp.int32(self.mm.get_fixed_vertex())    # prior :124-130
        # Robust kernels (when enabled) apply to loop-closure edges only
        # (existing loop edges + the pending batch); odometry keeps its
        # quadratic cost.
        rmask = None
        if self.config.pgo.robust != "none":
            from .graph.pose_graph import LOOP_CONSTRAINT
            rm = np.zeros(E, bool)
            rm[:ne] = g.edge_type[:ne] == LOOP_CONSTRAINT
            rm[ne:ne + n_pending] = True
            rmask = rm
        return (jnp.asarray(poses), jnp.asarray(vmask), ef,
                et, eT, ec, emask, fixed, rmask)

    # -- writeback (Optimizer.hpp:135-157) ---------------------------------

    def update_after_optimization(self, new_poses: np.ndarray) -> None:
        g = self.mm.get_graph()
        t_opt = self.mm.now()   # one stamp for the whole batch (:69)
        # Write back ONLY the prepare-time vertex snapshot: vertices
        # appended mid-solve (MT: the LM runs unlocked) have identity
        # padding rows in new_poses — writing those would clobber real
        # keyframe poses with identity. The reference's GTSAM values map
        # has the same scope (it only contains prepare-time vertices,
        # Optimizer.hpp:115-121,140-143).
        n = min(len(new_poses), g.n_vertices)
        if self._nv_snapshot is not None:
            n = min(n, self._nv_snapshot)
        # mark_dirty=False: these values ARE the device result (or its
        # packed round-trip) — the mirror needs no re-upload for them.
        self.mm.update_keyframe_transforms_bulk(new_poses[:n], t_opt,
                                                mark_dirty=False)
        for (f, t, T, c) in self.data_buffer:
            self.mm.add_loop_closing_constraint(f, t, T, c)
        self.data_buffer = []
        if self._mirror is not None:
            self._mirror.confirm_inserts(g)
        self.mm.notify_keyframe_update()
