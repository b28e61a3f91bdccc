"""LoopCloser — loop-closure detection and verification.

Rebuild of ``LoopCloser.h/hpp``: per new keyframe, find vertices that are
geometrically close but topologically far (``LoopCloser.hpp:220-224``),
assemble a candidate local map by Dijkstra on a loop-edge-free filtered
graph with an early-stop visitor (``LoopCloser.hpp:263-298``), verify with
a second ICP (``LoopCloser.hpp:98``), and accept only if the ICP did not
hit its iteration cap, overlap clears the threshold, and the recomputed
residual is small (``LoopCloser.hpp:308-340``).

The per-vertex Dijkstra visitor computing geometric distances
(``LoopCloser.hpp:139-161``) collapses into one vectorized norm over the
pose array.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import se3
from .cloud import Cloud
from .graph.pose_graph import LOOP_CONSTRAINT, MapManager
from .graph.shortest_path import candidate_composition, dijkstra
from .localmap import Composition, LocalMap

from .ops.icp import ICPConfig, ICPEngine, ICPResult, compute_residual

log = logging.getLogger("pgslam_tpu.loopcloser")


def _verify_impl(readings, refs, T0s, cfg, reading_chain, ref_chain):
    """The whole verification stage in-graph: reading + reference filter
    chains, the verification registration, and the fresh residual
    recompute of ``LoopCloser.hpp:343-365``. Returns
    (results, residuals, prepared refs)."""
    from .ops import filters as F
    from .ops.icp import icp_core
    key = jax.random.PRNGKey(0)
    if reading_chain:
        readings = jax.vmap(
            lambda c: F.apply_chain(reading_chain, c, key))(readings)
    if ref_chain:
        refs = jax.vmap(lambda c: F.apply_chain(ref_chain, c, key))(refs)
    results = jax.vmap(lambda r, m, t: icp_core(r, m, t, cfg))(
        readings, refs, T0s)
    residuals = jax.vmap(
        lambda r, m, t: compute_residual(r, m, t, cfg))(
            readings, refs, results.T)
    return results, residuals, refs


@functools.partial(jax.jit, static_argnames=("cfg", "reading_chain",
                                             "ref_chain"))
def _verify_batch(readings, refs, T0s, cfg, reading_chain, ref_chain):
    """ONE dispatch for the fleet's whole verification stage (filter
    chains, vmapped registration and residuals) instead of hundreds of
    eager ops per drain."""
    results, residuals, _ = _verify_impl(readings, refs, T0s, cfg,
                                         reading_chain, ref_chain)
    return results, residuals


@functools.partial(jax.jit, static_argnames=("cfg", "reading_chain",
                                             "ref_chain"))
def _verify_one(reading, ref, T0, cfg, reading_chain, ref_chain):
    """Single-vertex verification (the ST ``ProcessVertex`` path): one
    dispatch, and the result + fresh residual ride ONE packed f32 buffer
    (one device-to-host copy instead of one per result leaf). Also returns the
    prepared reference so the engine's ``setMap`` state stays what the
    split path would have left.

    Deliberately NOT a B=1 call of :func:`_verify_impl`: vmap changes
    reduction order (golden-replay trajectories are pinned at 1e-5), so
    the un-batched ops here stay bit-identical to the split
    set_map/engine/residual sequence they replace."""
    from .localizer import _pack_result_vec
    from .ops import filters as F
    from .ops.icp import icp_core
    key = jax.random.PRNGKey(0)
    if reading_chain:
        reading = F.apply_chain(reading_chain, reading, key)
    if ref_chain:
        ref = F.apply_chain(ref_chain, ref, key)
    result = icp_core(reading, ref, T0, cfg, None)
    residual = compute_residual(reading, ref, result.T, cfg)
    return _pack_result_vec(result, residual), ref


@dataclasses.dataclass(frozen=True)
class LoopCloserConfig:
    # Reference defaults: LoopCloser.hpp:16-21
    topo_dist_threshold: float = 3.0
    geom_dist_threshold: float = 3.0
    overlap_threshold: float = 0.8
    residual_error_threshold: float = 5000.0
    candidate_local_map_size: int = 3
    icp: ICPConfig = ICPConfig()
    # Deferred verification: a keyframe spawn dispatches the
    # candidate-map build + verification ICP immediately but consumes the
    # packed result at the NEXT scan's drain, so the d2h sync overlaps
    # the next scan's transfer+compute instead of serializing inside the
    # spawn event. Same
    # snapshot discipline as the MT variant, which runs verification
    # unlocked on snapshot data (LoopCloserMT.hpp:71-75); acceptance and
    # the optimizer run land one scan later. Grid-matcher configs fall
    # back to synchronous verification (their index builds inside
    # set_map). Off by default: the ST golden fixtures pin the
    # synchronous cascade.
    deferred_verification: bool = False


class LoopCloser:
    """``LoopCloser.h:14-83``."""

    def __init__(self, map_manager: MapManager, optimizer,
                 config: LoopCloserConfig = LoopCloserConfig()):
        self.mm = map_manager
        self.optimizer = optimizer
        self.config = config
        self._validate_verification_profile(config.icp)
        self.icp_engine = ICPEngine(config.icp)
        self.candidate_local_map = LocalMap(config.candidate_local_map_size)
        self.input_vertex: Optional[int] = None
        self.input_cloud: Optional[Cloud] = None
        self.input_T_world_kf: Optional[np.ndarray] = None
        self.T_refkf_kf: Optional[np.ndarray] = None
        self.last_result: Optional[ICPResult] = None
        # Multi-agent: queue vertices and verify in fleet-fused batches
        # (OptimizerMT-style batching of the verification stage).
        self.queue_mode = False
        self.batch_pad_to = 0
        self._pending = []
        # Deferred-verification records (config.deferred_verification):
        # dispatched-but-unconsumed verifications, oldest first.
        self._deferred = []

    # -- entry (LoopCloser.hpp:77-110) -------------------------------------

    def add_new_vertex(self, v: int) -> None:
        if self.queue_mode:
            self._pending.append(int(v))
            return
        if self.config.deferred_verification \
                and self.config.icp.matcher != "grid":
            rec = self._dispatch_verification(int(v))
            if rec is not None:
                self._deferred.append(rec)
            return
        self.process_vertex(v)

    def drain_deferred(self) -> None:
        """Consume every dispatched-but-unconsumed verification (deferred
        mode). Called at the next scan's window by the localizer (via
        ``MapManager.drain_loop_closer``) and by ``flush``."""
        while self._deferred:
            self._commit_verification(self._deferred.pop(0))

    # -- batched verification (multi-agent path) ---------------------------

    def process_pending_batched(self) -> None:
        """Drain queued vertices: host candidate searches, ONE batched
        candidate-map build, ONE batched verification ICP, then serial
        acceptance + optimization for survivors."""
        if not self._pending:
            return
        from .cloud import stack_clouds
        from .localmap import batch_rebuild
        from .ops import filters as F

        vs, self._pending = self._pending, []
        graph = self.mm.get_graph()
        reqs = []
        for v in vs:
            comp = self.find_candidate_composition(v)
            if comp is not None:
                reqs.append((v, comp))
        if not reqs:
            return
        size = self.config.candidate_local_map_size
        lms = []
        for v, comp in reqs:
            lm = LocalMap(size)
            lm.update_to_new_composition(graph, comp, build=False)
            lms.append(lm)
        # Pad to a power-of-two batch so a new compile happens only when
        # the bucket grows.
        n = len(reqs)
        bucket = max(self.batch_pad_to, 1 << (n - 1).bit_length())
        stacked_refs = batch_rebuild(lms, pad_to=bucket,
                                     return_stacked=True)

        cfg = self.config.icp
        readings = [graph.clouds[v] for v, _ in reqs]
        T0s = []
        for (v, _), lm in zip(reqs, lms):
            ref_kf = lm.reference_keyframe()
            T0s.append((np.linalg.inv(
                np.asarray(ref_kf.optimized_T_world_kf, np.float64))
                @ np.asarray(graph.optimized_poses[v], np.float64)
            ).astype(np.float32))
        pad = bucket - n
        readings += [readings[0]] * pad
        T0s += [T0s[0]] * pad
        stacked_readings = stack_clouds(readings)

        # Mirror ICPEngine.prepare_reference / prepare_reading as static
        # chains so the whole verification runs in _verify_batch's ONE
        # jitted dispatch.
        ref_chain = cfg.reference_filters
        if cfg.error == "point_to_plane" and not any(
                isinstance(f, F.SurfaceNormal) for f in ref_chain):
            if "normals" not in stacked_refs.descriptors:
                ref_chain = ref_chain + (F.SurfaceNormal(),)
        results, residuals = jax.device_get(_verify_batch(
            stacked_readings, stacked_refs,
            jnp.asarray(np.stack(T0s)), cfg,
            cfg.reading_filters, ref_chain))

        accepted_pairs = set()
        for i, ((v, comp), lm) in enumerate(zip(reqs, lms)):
            result = jax.tree_util.tree_map(lambda x: x[i], results)
            self.input_vertex = v
            self.input_cloud = graph.clouds[v]
            self.input_T_world_kf = graph.optimized_poses[v].copy()
            self.candidate_local_map = lm
            self.T_refkf_kf = np.asarray(result.T)
            self.last_result = result
            from .utils import counters
            ref_v = lm.reference_vertex()
            if self.mm.get_graph().has_edge(ref_v, v) \
                    or self.mm.get_graph().has_edge(v, ref_v) \
                    or (ref_v, v) in accepted_pairs \
                    or (v, ref_v) in accepted_pairs:
                # Batched race: candidate searches for the whole batch ran
                # before any insertion, so two vertices can each pick the
                # other (the ST ordering would have re-searched after the
                # first insert and gated the reverse pair out by its new
                # small topological distance). One closure per pair. The
                # accepted_pairs set covers the queued-optimizer case
                # where edge insertion is deferred past this drain
                # (Optimizer.queue_mode), so has_edge alone can't see the
                # first acceptance of a reciprocal pair.
                counters["loopcloser/rejected_duplicate"] += 1
                log.info("[LoopCloser] Loop closure %d -> %d dropped: "
                         "edge already exists", ref_v, v)
            elif self.check_icp_result(result,
                                       residual=float(residuals[i])):
                counters["loopcloser/accepted"] += 1
                accepted_pairs.add((ref_v, v))
                log.info("[LoopCloser] Loop closure accepted: %d -> %d",
                         ref_v, v)
                self.optimizer.add_new_data(ref_v, v,
                                            self.T_refkf_kf,
                                            np.asarray(result.cov))
            else:
                counters["loopcloser/rejected"] += 1
                log.info("[LoopCloser] Loop closure rejected for vertex %d",
                         v)

    def process_vertex(self, input_vertex: int) -> None:
        self.input_vertex = input_vertex

        cfg = self.config.icp
        if cfg.matcher == "grid":
            if not self.process_local_map_candidate():
                return
            # Grid indices build per-reference inside set_map; keep the
            # engine's split path for that matcher.
            input_T_refkf_kf = self._verification_init()
            self.icp_engine.set_map(self.candidate_local_map.cloud())
            result = jax.device_get(self.icp_engine(
                self.input_cloud, jnp.asarray(input_T_refkf_kf)))
            self.last_result = result
            self.T_refkf_kf = np.asarray(result.T)
            self._accept_or_reject(input_vertex,
                                   self.candidate_local_map, result,
                                   residual=None)
            return
        rec = self._dispatch_verification(input_vertex)
        if rec is not None:
            self._commit_verification(rec)

    def _verification_init(self) -> np.ndarray:
        """Initial guess: input keyframe pose in the candidate reference
        keyframe's frame (LoopCloser.hpp:95).
        Host numpy 4x4 rigid inverse + compose: the eager-device form
        would pay op-by-op dispatches and a device-to-host sync."""
        from .localizer import _rigid_inverse
        ref_kf = self.candidate_local_map.reference_keyframe()
        Tinv = _rigid_inverse(ref_kf.optimized_T_world_kf)
        return (Tinv @ np.asarray(self.input_T_world_kf, np.float64)
                ).astype(np.float32)

    def _dispatch_verification(self, input_vertex: int):
        """Candidate search + ONE verification dispatch; NO device sync.
        Returns the in-flight record (consumed by
        :meth:`_commit_verification`) or None when no candidate exists.
        The synchronous path is dispatch + immediate commit — identical
        numerics; the deferred path commits at the next scan's drain."""
        self.input_vertex = input_vertex
        if not self.process_local_map_candidate():
            return None
        input_T_refkf_kf = self._verification_init()

        # Verification ICP against the candidate map (LoopCloser.hpp:98):
        # ONE dispatch, and result + fresh residual ride ONE packed d2h
        # (the split set_map/engine/residual sequence paid three
        # dispatches and two syncs per spawned keyframe).
        cfg = self.config.icp
        from .ops import filters as F
        ref_cloud = self.candidate_local_map.cloud()
        ref_chain = cfg.reference_filters
        if cfg.error == "point_to_plane" and not any(
                isinstance(f, F.SurfaceNormal) for f in ref_chain):
            if "normals" not in ref_cloud.descriptors:
                ref_chain = ref_chain + (F.SurfaceNormal(),)
        packed, prepared_ref = _verify_one(
            self.input_cloud, ref_cloud,
            jnp.asarray(input_T_refkf_kf), cfg,
            cfg.reading_filters, ref_chain)
        try:
            # start the d2h now: by commit time (the next scan's drain in
            # deferred mode) the bytes are already host-side
            packed.copy_to_host_async()
        except (AttributeError, RuntimeError):
            pass
        rec = {"vertex": input_vertex, "lm": self.candidate_local_map,
               "cloud": self.input_cloud,
               "T_world_kf": self.input_T_world_kf,
               "packed": packed, "ref": prepared_ref}
        # hand the map object to the record; the next dispatch gets a
        # fresh one (deferred mode can hold several records in flight)
        self.candidate_local_map = LocalMap(
            self.config.candidate_local_map_size)
        return rec

    def _commit_verification(self, rec) -> None:
        """Fetch one dispatched verification and run acceptance
        (LoopCloser.hpp:308-340) + the optimizer feed."""
        from .localizer import _unpack_result_vec
        self.input_vertex = rec["vertex"]
        self.input_cloud = rec["cloud"]
        self.input_T_world_kf = rec["T_world_kf"]
        self.candidate_local_map = rec["lm"]
        result, residual = _unpack_result_vec(
            jax.device_get(rec["packed"]))
        self.icp_engine._reference = rec["ref"]
        self.icp_engine._index = None
        self.last_result = result
        self.T_refkf_kf = np.asarray(result.T)
        self._accept_or_reject(rec["vertex"], rec["lm"], result, residual)

    def _accept_or_reject(self, input_vertex: int, lm, result,
                          residual) -> None:
        from .utils import counters
        ref_v = lm.reference_vertex()
        g = self.mm.get_graph()
        if g.has_edge(ref_v, input_vertex) \
                or g.has_edge(input_vertex, ref_v):
            # Deferred-commit race: another closure inserted this pair
            # between dispatch and drain (the synchronous path can never
            # hit this — candidate search re-runs after every insert and
            # the new edge makes the pair topologically close).
            counters["loopcloser/rejected_duplicate"] += 1
            log.info("[LoopCloser] Loop closure %d -> %d dropped: "
                     "edge already exists", ref_v, input_vertex)
        elif self.check_icp_result(result, residual=residual):
            counters["loopcloser/accepted"] += 1
            log.info("[LoopCloser] Loop closure accepted: %d -> %d",
                     ref_v, input_vertex)
            self.optimizer.add_new_data(ref_v, input_vertex,
                                        self.T_refkf_kf,
                                        np.asarray(result.cov))
        else:
            counters["loopcloser/rejected"] += 1
            log.info("[LoopCloser] Loop closure rejected for vertex %d",
                     input_vertex)

    def process_local_map_candidate(self) -> bool:
        """``LoopCloser.hpp:113-136``."""
        graph = self.mm.get_graph()
        log.info("[LoopCloser] Looking for a loop closing candidate for "
                 "keyframe %d", self.input_vertex)
        if not self.find_local_map_candidate(self.input_vertex):
            return False
        self.input_cloud = graph.clouds[self.input_vertex]
        self.input_T_world_kf = graph.optimized_poses[self.input_vertex].copy()
        return True

    # -- candidate search (LoopCloser.hpp:193-305) -------------------------

    def find_local_map_candidate(self, input_v: int) -> bool:
        comp = self.find_candidate_composition(input_v)
        if comp is None:
            return False
        self.candidate_local_map.update_to_new_composition(
            self.mm.get_graph(), comp)
        return True

    def find_candidate_composition(self, input_v: int):
        """Host-only candidate search: returns the winning candidate
        composition or None (the device-side map build is the caller's)."""
        graph = self.mm.get_graph()
        if graph.n_vertices <= 1:
            return None
        cfg = self.config
        n, e = graph.n_vertices, graph.n_edges

        # Dijkstra #1 over the full graph: topological distances; geometric
        # distances are one vectorized norm (visitor at :211-215 collapsed).
        # Both stay on host: the graph SoA lives in host memory, and a
        # [n]-norm device dispatch would cost a round-trip per keyframe.
        topo, _ = dijkstra(n, graph.edge_from[:e], graph.edge_to[:e],
                           graph.edge_weight[:e], input_v)
        geom = np.linalg.norm(
            graph.optimized_poses[:n, :3, 3]
            - graph.optimized_poses[input_v, :3, 3], axis=-1)

        # Gate: geometrically close AND topologically far (:220-224), then
        # sort by geometric distance (:227-229).
        cand = np.nonzero((geom <= cfg.geom_dist_threshold)
                          & (topo > cfg.topo_dist_threshold))[0]
        cand = cand[np.argsort(geom[cand], kind="stable")]
        if len(cand) == 0:
            log.info("[LoopCloser] Candidate NOT found!")
            return None

        # Filtered graph: drop topologically-close vertices, loop edges,
        # and edges touching dropped vertices (:234-264).
        vertex_ok = topo > cfg.topo_dist_threshold
        edge_ok = graph.edge_type[:e] != LOOP_CONSTRAINT

        size = self.candidate_local_map.capacity()
        for candidate_v in cand:
            comp = candidate_composition(
                n, graph.edge_from[:e], graph.edge_to[:e],
                graph.edge_weight[:e], int(candidate_v), size,
                vertex_ok=vertex_ok, edge_ok=edge_ok)
            if comp is not None:
                log.info("[LoopCloser] Candidate found! -> %s", comp)
                return Composition(size, comp)
        log.info("[LoopCloser] Candidate NOT found!")
        return None

    # -- acceptance checks (LoopCloser.hpp:308-365) ------------------------

    @staticmethod
    def _validate_verification_profile(cfg) -> None:
        """Guard the convergence-checker dead zone:
        :meth:`check_icp_result` REJECTS on ``max_iter_reached``
        (``LoopCloser.hpp:317``), so a verification profile whose eps
        checker can never fire rejects 100% of closures silently. Raise
        on the structural case; warn when the checker has almost no room
        (e.g. the throughput-tuned flagship profile at mi=5/smooth=4,
        which in practice never eps-stops on non-coincident matches)."""
        from .ops.icp import eps_dead_zone, eps_margin
        reason = eps_dead_zone(cfg)
        if reason is not None:
            raise ValueError(
                f"LoopCloser ICP profile can never report convergence "
                f"({reason}); check_icp_result would reject every "
                f"closure. Raise max_iterations above smooth_length or "
                f"use a dedicated verification profile.")
        if eps_margin(cfg) <= 1:
            log.warning(
                "[LoopCloser] verification ICP profile has max_iterations="
                "%d with smooth_length=%d: the eps checker can only fire "
                "in the final iteration, so most registrations will report "
                "max_iter_reached=True and be REJECTED as closures. "
                "Throughput profiles (which ignore max_iter_reached) are "
                "not verification profiles.", cfg.max_iterations,
                max(1, cfg.smooth_length))

    def check_icp_result(self, result: ICPResult,
                         residual: Optional[float] = None) -> bool:
        if result.diverged is not None and bool(result.diverged):
            return False  # bound checker fired (see ICPConfig)
        if bool(result.max_iter_reached):        # :317
            return False
        if float(result.overlap) < self.config.overlap_threshold:  # :331
            return False
        if residual is None:  # batched path precomputes the whole fleet's
            residual = self.compute_residual_error()
        if residual > self.config.residual_error_threshold:        # :335
            return False
        return True

    def compute_residual_error(self) -> float:
        """Residual recompute with a fresh matching pipeline
        (``LoopCloser.hpp:343-365``): reading transformed by the loop
        transform, matched against the candidate map cloud."""
        reading = self.icp_engine.prepare_reading(self.input_cloud)
        reference = self.icp_engine.reference  # already prepared by set_map
        res = compute_residual(reading, reference,
                               jnp.asarray(self.T_refkf_kf),
                               self.config.icp)
        return float(res)

    # -- setters (LoopCloser.h:32-37 parity) -------------------------------

    def set_topological_distance_threshold(self, v: float) -> None:
        self.config = dataclasses.replace(self.config, topo_dist_threshold=v)

    def set_geometrical_distance_threshold(self, v: float) -> None:
        self.config = dataclasses.replace(self.config, geom_dist_threshold=v)

    def set_overlap_threshold(self, v: float) -> None:
        self.config = dataclasses.replace(self.config, overlap_threshold=v)

    def set_residual_error_threshold(self, v: float) -> None:
        self.config = dataclasses.replace(self.config,
                                          residual_error_threshold=v)

    def set_candidate_local_map_max_size(self, size: int) -> None:
        # NOTE: the reference hardcodes 3 here, ignoring its argument
        # (LoopCloser.hpp:53-56). We honor the intent, not the bug.
        self.candidate_local_map = LocalMap(size)

    def set_icp_config(self, path: str) -> None:
        """``LoopCloser.hpp:59-74`` analog."""
        from .config import load_icp_config
        icp = load_icp_config(path)
        self._validate_verification_profile(icp)
        self.config = dataclasses.replace(self.config, icp=icp)
        self.icp_engine = ICPEngine(icp)
