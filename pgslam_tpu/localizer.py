"""Localizer — front-end odometry: input filtering, scan-to-local-map ICP,
keyframe spawning and local-map composition management.

Faithful rebuild of the reference's decision logic
(``Localizer.h/hpp``): the numerics underneath (filters, ICP, overlap)
are jitted device code, but the control flow — overlap gating
(``Localizer.hpp:196-245``), neighbor-composition search
(``Localizer.hpp:393-483``), composition swap to the closest vertex
(``Localizer.hpp:214-221``), pose re-anchoring after composition/graph
changes (``Localizer.hpp:264-273``) — is reproduced step for step so
trajectories match the reference within pose tolerance.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import se3
from .cloud import Cloud, transform_cloud
from .graph.pose_graph import MapManager
from .graph.shortest_path import dijkstra
from .localmap import Composition, LocalMap
from .metrics import distance
from .ops import filters as F
from .ops.icp import (ICPConfig, ICPEngine, ICPResult, compute_overlap,
                      icp_core)

log = logging.getLogger("pgslam_tpu.localizer")

import functools


def _probe_overlap_impl(points, masks, descs, T_refkf_kf, slot_valid,
                        T_world_ref, reading: Cloud, T_world_robot,
                        desc_keys, ref_chain, cfg) -> jax.Array:
    """The whole ComputeOverlapWith replay (Localizer.hpp:282-348) as ONE
    device dispatch: build the candidate map cloud, move it to the world
    frame, apply reference filters, match + weigh, return the overlap."""
    from .localmap import _build_cloud_impl
    from .ops.icp import _compute_overlap_impl

    pts, mask, out_desc = _build_cloud_impl(
        points, masks, descs, T_refkf_kf, slot_valid, desc_keys)
    cloud = Cloud(points=pts, mask=mask, descriptors=out_desc)
    world = transform_cloud(jnp.asarray(T_world_ref), cloud)
    if ref_chain:
        world = F.apply_chain(ref_chain, world, jax.random.PRNGKey(0))
    return _compute_overlap_impl(reading, world, jnp.asarray(T_world_robot),
                                 cfg)


# (The single-composition probe goes through the split/cached
# _probe_build + ops.icp.compute_overlap pair below; _probe_overlap_impl
# remains the shared body for the multi-agent batched probe.)


def _probe_build_impl(points, masks, descs, T_refkf_kf, slot_valid,
                      T_world_ref, desc_keys, ref_chain) -> Cloud:
    """Candidate-map half of the overlap probe: build the composition
    cloud, move it to the world frame, apply the reference filter chain.

    Split from the per-scan overlap evaluation so the result can be
    cached keyed on (composition, member update_times): the probe fires
    nearly every scan in keyframe-dense runs and this half — stacking
    three keyframe clouds, the build kernel, VoxelGrid + normals — is
    nearly all of its cost, and it only changes when the composition or
    a member pose does."""
    from .localmap import _build_cloud_impl

    pts, mask, out_desc = _build_cloud_impl(
        points, masks, descs, T_refkf_kf, slot_valid, desc_keys)
    cloud = Cloud(points=pts, mask=mask, descriptors=out_desc)
    world = transform_cloud(jnp.asarray(T_world_ref), cloud)
    if ref_chain:
        world = F.apply_chain(ref_chain, world, jax.random.PRNGKey(0))
    return world


_probe_build = functools.partial(
    jax.jit, static_argnames=("desc_keys", "ref_chain"))(_probe_build_impl)


@functools.partial(jax.jit, static_argnames=("desc_keys", "ref_chain"))
def _probe_build_batched(points, masks, descs, Ts, slot_valid,
                         T_world_refs, desc_keys, ref_chain):
    """vmapped :func:`_probe_build` for a fleet's probe-cache misses in
    ONE dispatch, per-map slices cut inside the jit (a miss otherwise
    pays ~6 eager ops per agent). Slices every padded batch
    entry — callers take the first k — so the jit cache is keyed on the
    padded shape alone, not the per-step miss count."""
    worlds = jax.vmap(
        lambda p, m, d, t, s, twr: _probe_build_impl(
            p, m, d, t, s, twr, desc_keys, ref_chain)
    )(points, masks, descs, Ts, slot_valid, T_world_refs)
    cut = lambda i: jax.tree_util.tree_map(lambda x: x[i], worlds)
    return [cut(i) for i in range(points.shape[0])]


@functools.partial(jax.jit, static_argnames=("desc_keys", "ref_chain",
                                              "cfg"))
def _probe_overlap_batched(points, masks, descs, Ts, slot_valid,
                           T_world_refs, readings, T_world_robots,
                           desc_keys, ref_chain, cfg) -> jax.Array:
    """vmapped overlap probes: evaluate many agents' candidate
    compositions in one dispatch (build + filter + match in-graph;
    prefer :func:`_probe_overlap_from_batched` over cached maps)."""
    return jax.vmap(
        lambda p, m, d, t, s, twr, r, twb: _probe_overlap_impl(
            p, m, d, t, s, twr, r, twb, desc_keys, ref_chain, cfg)
    )(points, masks, descs, Ts, slot_valid, T_world_refs, readings,
      T_world_robots)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _probe_overlap_from_batched(readings, worlds, T_world_robots,
                                cfg) -> jax.Array:
    """vmapped overlap evaluation against PRE-BUILT candidate maps
    (each agent's :meth:`Localizer._cached_probe_map` output): the
    per-step stack + build + reference-filter work the full batched
    probe pays disappears on cache hits."""
    from .ops.icp import _compute_overlap_impl

    return jax.vmap(
        lambda r, w, t: _compute_overlap_impl(r, w, t, cfg)
    )(readings, worlds, T_world_robots)


def _prepare_input_impl(chain, capacity: int, cloud: Cloud, T_robot_sensor,
                        key) -> Cloud:
    """Input filters + compaction + sensor->robot transform as ONE device
    dispatch (eager per-op dispatch costs dominate on remote devices).
    int16 clouds are packed millimeter fixed-point (cloud.MM_SCALE) and
    dequantize here, in-graph — the h2d transfer stays at half the f32
    bytes."""
    from .cloud import dequantize_cloud
    cloud = dequantize_cloud(cloud)
    cloud = F.apply_chain(chain, cloud, key)
    cloud = F.compact(cloud, capacity)
    return transform_cloud(T_robot_sensor, cloud)


_prepare_input = functools.partial(
    jax.jit, static_argnames=("chain", "capacity"))(_prepare_input_impl)


@functools.partial(jax.jit, static_argnames=("chain", "capacity",
                                             "reading_chain"))
def _prepare_input_batched(chain, capacity: int, clouds: Cloud,
                           T_robot_sensors, seeds,
                           reading_chain=()):
    """vmapped input preparation for a fleet of agents (one dispatch).

    Also applies the reading filter chain (``reading_chain``) so the
    fleet pays ONE dispatch instead of one ``prepare_reading`` per agent,
    and returns per-agent slices of both the prepared input clouds and
    the readings CUT INSIDE THE JIT, instead of ``B × leaves`` eager
    slice dispatches.

    Returns ``(clouds [B,...], readings [B,...], slices)`` with
    ``slices[i] = (cloud_i, reading_i)``. ``seeds`` is a host int array
    [B] (per-agent scan counts); PRNG keys derive IN-GRAPH — per-agent
    ``jax.random.PRNGKey`` calls would each be a device op."""
    keys = jax.vmap(jax.random.PRNGKey)(seeds)
    prepped = jax.vmap(
        lambda c, t, k: _prepare_input_impl(chain, capacity, c, t, k)
    )(clouds, T_robot_sensors, keys)
    readings = prepped
    if reading_chain:
        key0 = jax.random.PRNGKey(0)
        readings = jax.vmap(
            lambda c: F.apply_chain(reading_chain, c, key0))(prepped)
    cut = lambda t, i: jax.tree_util.tree_map(lambda x: x[i], t)
    slices = [(cut(prepped, i), cut(readings, i))
              for i in range(clouds.points.shape[0])]
    return prepped, readings, slices


@functools.partial(jax.jit, static_argnames=("chain", "capacity", "cfg"))
def _prepare_register_stream(chain, capacity: int, cfg, raw: Cloud,
                             T_robot_sensors, seeds, reference: Cloud,
                             T0s):
    """Micro-batched single-robot scan path
    (``LocalizerConfig.micro_batch``): B buffered scans' input pipelines
    + reading chains + registrations against ONE persistent reference
    map in ONE device dispatch, so the per-dispatch and per-sync costs
    amortize B-fold. Returns per-scan
    ``(cloud, reading)`` slices and per-scan packed result vectors, all
    cut INSIDE the jit (eager row slices would pay the dispatch floor
    each)."""
    from .parallel.batched import batched_register
    prepped, readings, slices = _prepare_input_batched(
        chain, capacity, raw, T_robot_sensors, seeds,
        reading_chain=cfg.reading_filters)
    B = T0s.shape[0]
    refs = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (B,) + x.shape), reference)
    results = batched_register(readings, refs, T0s, cfg)
    packed = jax.vmap(_pack_result_vec)(results)
    pvecs = [packed[j] for j in range(B)]
    return slices, pvecs


def _prepare_and_register_impl(chain, capacity: int, cfg, raw: Cloud,
                               T_robot_sensor, key, reference: Cloud, T0,
                               index):
    """Input pipeline + reading filters + the FULL ICP loop as ONE device
    dispatch: the single-agent hot path (`process_data`) fuses
    everything between raw scan and ICP result; the split
    `prepare_scan`/`icp_core` pieces remain for the multi-agent batcher,
    which interleaves host work between them."""
    cloud = _prepare_input_impl(chain, capacity, raw, T_robot_sensor, key)
    reading = cloud
    if cfg.reading_filters:
        reading = F.apply_chain(cfg.reading_filters, reading,
                                jax.random.PRNGKey(0))
    result = icp_core(reading, reference, T0, cfg, index)
    return cloud, reading, result


def _pack_result_vec(result, ov=None) -> jax.Array:
    """Flatten an :class:`ICPResult` (+ optional probe overlap) into ONE
    [59] f32 vector IN-JIT. ``jax.device_get`` on the 8-leaf result
    pytree pays one transfer per leaf; one packed buffer is one
    transfer. NaN encodes the
    absent ``diverged``/``ov`` slots (both are presence-static)."""
    f32 = jnp.float32
    div = (jnp.asarray(jnp.nan, f32) if result.diverged is None
           else result.diverged.astype(f32))
    ove = (jnp.asarray(jnp.nan, f32) if ov is None else ov.astype(f32))
    tail = jnp.stack([result.iterations.astype(f32),
                      result.converged.astype(f32),
                      result.max_iter_reached.astype(f32),
                      result.overlap.astype(f32),
                      result.residual.astype(f32), div, ove])
    return jnp.concatenate([result.T.reshape(16).astype(f32),
                            result.cov.reshape(36).astype(f32), tail])


def _unpack_result_vec(vec) -> Tuple[ICPResult, Optional[float]]:
    """Host-side inverse of :func:`_pack_result_vec` (numpy leaves, same
    types a ``device_get`` of the struct produced)."""
    vec = np.asarray(vec)
    div = vec[57]
    ov = vec[58]
    result = ICPResult(
        T=vec[:16].reshape(4, 4),
        iterations=np.int32(vec[52]),
        converged=np.bool_(vec[53] != 0.0),
        max_iter_reached=np.bool_(vec[54] != 0.0),
        overlap=np.float32(vec[55]),
        residual=np.float32(vec[56]),
        cov=vec[16:52].reshape(6, 6),
        diverged=None if np.isnan(div) else np.bool_(div != 0.0))
    return result, (None if np.isnan(ov) else float(ov))


@functools.partial(jax.jit, static_argnames=("chain", "capacity", "cfg"))
def _prepare_and_register(chain, capacity: int, cfg, raw: Cloud,
                          T_robot_sensor, key, reference: Cloud, T0,
                          index):
    cloud, reading, result = _prepare_and_register_impl(
        chain, capacity, cfg, raw, T_robot_sensor, key, reference, T0,
        index)
    return cloud, reading, _pack_result_vec(result)


@functools.partial(jax.jit, static_argnames=("chain", "capacity", "cfg"))
def _prepare_register_probe(chain, capacity: int, cfg, raw: Cloud,
                            T_robot_sensor, key, reference: Cloud, T0,
                            index, probe_map: Cloud, T_world_refkf):
    """:func:`_prepare_and_register` plus the neighbor-composition
    overlap probe, all in ONE dispatch — so the single-threaded scan
    path pays exactly one device sync.

    The split sequence (sync result -> pick neighbor -> dispatch probe
    -> sync probe) paid two blocking readbacks per scan. Here the
    probe evaluates IN-GRAPH at the post-ICP pose
    ``T_world_refkf @ result.T`` against the cached candidate map
    (:meth:`Localizer._cached_probe_map`); the caller selects the
    candidate composition from the odometry-PREDICTED pose instead of
    the post-ICP one — a cm-level difference on a meters-scale
    nearest-keyframe choice (same batching trade the MT variant and the
    multi-agent prober already make)."""
    from .ops.icp import _compute_overlap_impl

    cloud, reading, result = _prepare_and_register_impl(
        chain, capacity, cfg, raw, T_robot_sensor, key, reference, T0,
        index)
    T_world_robot = T_world_refkf @ result.T
    ov = _compute_overlap_impl(reading, probe_map, T_world_robot, cfg)
    return cloud, reading, _pack_result_vec(result, ov)


def _orthonormalize(T: np.ndarray) -> np.ndarray:
    """Project the rotation block back onto SO(3) (host-side, cheap).

    Critical for long runs: ``se3.inverse`` assumes orthonormal rotations,
    and the re-anchoring identity ``T_refkf_robot = inv(kf) @ T_world``
    (Localizer.hpp:264-267) *squares* any accumulated scale error in fp32
    at every keyframe — exponential blow-up after a few dozen keyframes if
    rotations are never renormalized.
    """
    U, _, Vt = np.linalg.svd(T[:3, :3].astype(np.float64))
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R = (U * np.array([1.0, 1.0, -1.0])) @ Vt
    out = np.array(T, np.float32, copy=True)
    out[:3, :3] = R.astype(np.float32)
    return out


def _rigid_inverse(T: np.ndarray) -> np.ndarray:
    """fp64 inverse of a rigid 4x4 (R.T / -R.T t) on host.

    Every re-anchoring site composes through this instead of a device
    ``se3.inverse`` (eager op-by-op dispatch plus a sync, for a 4x4) or
    ``np.linalg.inv`` (whose
    general LU path does not preserve the rigid structure). fp64 because
    the compose sites feed ``_orthonormalize``'s scale-error discipline
    — see its docstring on the squaring landmine."""
    T = np.asarray(T, np.float64)
    R = T[:3, :3]
    Tinv = np.eye(4, dtype=np.float64)
    Tinv[:3, :3] = R.T
    Tinv[:3, 3] = -R.T @ T[:3, 3]
    return Tinv


@dataclasses.dataclass(frozen=True)
class LocalizerConfig:
    # Reference defaults: Localizer.hpp:25-28
    local_map_size: int = 3
    overlap_threshold: float = 0.8
    minimal_overlap: float = 0.5
    input_filters: Tuple = ()
    icp: ICPConfig = ICPConfig()
    # Fixed capacity of keyframe clouds after input filtering (compaction
    # target; fixed-shape discipline for the local-map builder).
    keyframe_cloud_capacity: int = 1024
    # Deferred-commit depth for the single-threaded scan path: with
    # sync_lag=k, scan t's registration is DISPATCHED immediately but its
    # result (and the keyframe/composition decision tree it feeds) is
    # consumed at scan t+k's call — so the per-scan device->host sync of
    # the packed result overlaps the next scan's transfer + registration
    # instead of serializing after it. This is the reference's own MT
    # semantics (LocalizerMT.hpp:122-134: the localizer registers against
    # a map that may be one decision stale and resyncs at the next drain)
    # applied to the ST path; decisions lag k scans, initial guesses are
    # odometry-extrapolated from the last committed pose, and
    # :meth:`Localizer.flush` commits the tail. 0 = classic per-scan sync.
    sync_lag: int = 0
    # Validation hook: route scans through the
    # deferred machinery even at sync_lag=0. With an empty pipeline the
    # deferred path reproduces the classic path BIT-IDENTICALLY by
    # construction (fresh dispatches use the classic initial-guess /
    # probe numerics and fresh commits the classic pose composition —
    # see _process_data_deferred/_commit), and the golden test
    # ``test_deferred_lag0_bitwise_matches_classic`` pins exactly that.
    force_deferred: bool = False
    # STREAMING mode: buffer scans and register
    # micro_batch of them against the current local map in ONE fused
    # dispatch (see _prepare_register_stream). Commit lag is up to
    # micro_batch + sync_lag scans — the same semantics contract as
    # sync_lag, stretched: all scans in a batch register against the
    # same map snapshot with odometry-extrapolated initial guesses, and
    # the keyframe/composition decisions run at commit (decisions after
    # a spawn within the batch are muted, exactly like sync_lag's
    # stale-composition discipline). The speculative neighbor-probe is
    # skipped in this mode (composition swaps to neighbor maps don't
    # fire; closest-vertex re-referencing and keyframe spawns still do)
    # — a forward-moving robot rarely swaps, and a revisit-heavy user
    # should run the per-scan path. 0/1 disables.
    micro_batch: int = 0


@dataclasses.dataclass
class _Inflight:
    """A dispatched-but-uncommitted scan (sync_lag > 0)."""
    packed: jax.Array          # [59] result vector, device-resident
    cloud: Cloud               # prepared input cloud (device)
    reading: Cloud             # filtered reading (device)
    refkf_vertex: int          # reference keyframe the result.T is
    # relative to. The commit composes with this vertex's CURRENT
    # optimized pose, not the pose recorded at dispatch: an optimizer
    # writeback landing between dispatch and commit must pull the live
    # pose exactly like the sync path's post-optimization re-anchor
    # (Localizer.hpp:270-273) — composing with the stale dispatch-time
    # pose silently discards every closure correction (measured: 2.4x
    # the sync path's drift on the 3-closure clover fixture).
    probe_comp: Optional["Composition"]
    odom_pose: np.ndarray      # this scan's odometry world pose
    comp_items: Tuple[int, ...]  # composition the registration ran against
    refkf_pose_at_dispatch: np.ndarray = None  # optimized_T_world_kf of
    # refkf_vertex when the scan was dispatched; a commit that finds it
    # bit-unchanged (and the composition unchanged) is FRESH — nothing
    # landed in between — and uses the classic pose composition so the
    # deferred path degrades to bit-identical classic behavior.


class Localizer:
    """Consumes odometry+cloud inputs, runs scan-to-local-map ICP, decides
    keyframe creation, manages the live local map (``Localizer.h:16-108``)."""

    def __init__(self, map_manager: MapManager,
                 config: LocalizerConfig = LocalizerConfig()):
        self.mm = map_manager
        self.config = config
        self.icp_engine = ICPEngine(config.icp)
        self.local_map = LocalMap(config.local_map_size)
        # Persistent across calls, mirroring next_local_map_composition_
        # (mutated in place at Localizer.hpp:211,217,240).
        self.next_composition = Composition(config.local_map_size)
        self.T_refkf_robot = np.eye(4, dtype=np.float32)
        self.T_world_robot = np.eye(4, dtype=np.float32)
        self.last_input_T_world_robot = np.eye(4, dtype=np.float32)
        self.count = 0
        self.input_cloud: Optional[Cloud] = None
        self.last_result: Optional[ICPResult] = None
        # Multi-agent mode: defer optimization-writeback resyncs to the
        # next scan (the MT variant's outdated-flag semantics,
        # LocalizerMT.hpp:122-134) so a fleet orchestrator can batch them.
        self.defer_graph_resync = False
        self._needs_resync = False
        # Overlap-probe candidate-map cache: {composition items ->
        # (member update_times, built+filtered world cloud)}. See
        # :func:`_probe_build` / :meth:`_cached_probe_map`.
        self._probe_cache: dict = {}
        # Deferred-commit state (config.sync_lag > 0): dispatched scans
        # whose results have not been consumed yet, oldest first, plus
        # the odometry pose of the last COMMITTED scan (the base for
        # world-frame initial-guess extrapolation across the gap).
        import collections
        self._inflight: "collections.deque[_Inflight]" = collections.deque()
        self._committed_odom = np.eye(4, dtype=np.float32)
        # Streaming-mode scan buffer (config.micro_batch > 1):
        # (odom_pose, T_robot_sensor, cloud, count) awaiting the fused
        # batch dispatch.
        self._microbuf: list = []
        # The current scan's prepared reading (set by process_data /
        # prepare_scan) — reused by the inline overlap probe instead of
        # re-running the reading filters.
        self._last_reading: Optional[Cloud] = None

    # -- configuration setters (Localizer.h:33-37 parity) ------------------

    def set_local_map_max_size(self, size: int) -> None:
        self.local_map = LocalMap(size)
        self.next_composition = Composition(size)

    def set_overlap_threshold(self, v: float) -> None:
        object.__setattr__(self, "config",
                           dataclasses.replace(self.config,
                                               overlap_threshold=v))

    def set_minimal_overlap_threshold(self, v: float) -> None:
        object.__setattr__(self, "config",
                           dataclasses.replace(self.config,
                                               minimal_overlap=v))

    def set_icp_config(self, path: str) -> None:
        """``Localizer.hpp:55-71`` analog: load a libpointmatcher-style
        ICP YAML. (No text buffering needed — configs are values here.)"""
        from .config import load_icp_config
        icp = load_icp_config(path)
        self.config = dataclasses.replace(self.config, icp=icp)
        self.icp_engine = ICPEngine(icp)
        if self.local_map.has_cloud():
            self.icp_engine.set_map(self.local_map.cloud())

    def set_input_filters_config(self, path: str) -> None:
        """``Localizer.hpp:74-78`` analog."""
        from .config import load_input_filters
        self.config = dataclasses.replace(
            self.config, input_filters=load_input_filters(path))

    # -- data entry (Localizer.hpp:81-135) ---------------------------------

    def add_new_data(self, timestamp, world_frame_id, T_world_robot,
                     T_robot_sensor, cloud: Cloud) -> None:
        del timestamp, world_frame_id
        self.process_data(np.asarray(T_world_robot, np.float32),
                          np.asarray(T_robot_sensor, np.float32), cloud)

    def process_data(self, input_T_world_robot: np.ndarray,
                     input_T_robot_sensor: np.ndarray,
                     input_cloud: Cloud) -> None:
        if not self.local_map.has_cloud():
            # First cloud: prepare_scan bootstraps the map and returns None.
            assert self.prepare_scan(input_T_world_robot,
                                     input_T_robot_sensor,
                                     input_cloud) is None
            # Base for deferred-mode initial-guess extrapolation.
            self._committed_odom = np.asarray(input_T_world_robot,
                                              np.float32)
            return
        if self.config.micro_batch > 1:
            return self._process_data_stream(
                np.asarray(input_T_world_robot, np.float32),
                np.asarray(input_T_robot_sensor, np.float32), input_cloud)
        if self.config.sync_lag > 0 or self.config.force_deferred:
            return self._process_data_deferred(
                np.asarray(input_T_world_robot, np.float32),
                np.asarray(input_T_robot_sensor, np.float32), input_cloud)
        # Hot path: same bookkeeping as prepare_scan, but input pipeline +
        # reading filters + ICP fuse into ONE dispatch.
        log.info("[Localizer] Processing cloud #%d", self.count)
        from .utils import counters
        counters["localizer/scans"] += 1
        key = jax.random.PRNGKey(self.count)
        self.count += 1
        input_dT_robot = (
            np.linalg.inv(np.asarray(self.last_input_T_world_robot,
                                     np.float64))
            @ np.asarray(input_T_world_robot, np.float64)).astype(np.float32)
        input_T_refkf_robot = self.T_refkf_robot @ input_dT_robot

        # Speculative neighbor-probe selection from the odometry-
        # predicted pose, so the probe can ride the registration
        # dispatch and the scan pays ONE device sync (see
        # _prepare_register_probe's docstring for the measured cost of
        # extra syncs and the semantics note).
        T_world_refkf = np.asarray(
            self.local_map.reference_keyframe().optimized_T_world_kf,
            np.float32)
        T_pred = T_world_refkf @ input_T_refkf_robot
        probe_comp = self.neighbor_probe_request(T_world_robot=T_pred)
        probe_map = (self._cached_probe_map(probe_comp)
                     if probe_comp is not None else None)

        args = (self.config.input_filters,
                self.config.keyframe_cloud_capacity,
                self.icp_engine.config, input_cloud,
                jnp.asarray(input_T_robot_sensor, jnp.float32), key,
                self.icp_engine.reference, jnp.asarray(input_T_refkf_robot),
                self.icp_engine._index)
        if probe_map is not None:
            cloud, reading, packed = _prepare_register_probe(
                *args, probe_map, jnp.asarray(T_world_refkf))
        else:
            cloud, reading, packed = _prepare_and_register(*args)
        # Deferred loop-closure verifications from the previous scan's
        # spawn drain here, behind this scan's in-flight dispatch.
        self.mm.drain_loop_closer()
        self.input_cloud = cloud
        self._last_reading = reading
        # The scan's single sync: ONE packed buffer carries the result
        # bundle + probe overlap (one transfer, not one per leaf).
        result, ov = _unpack_result_vec(jax.device_get(packed))
        result = self.begin_finish(result)
        self.decide_composition(
            result, neighbor_probe=(probe_comp,
                                    None if ov is None else float(ov)))
        self.apply_composition(build=True)
        self.last_input_T_world_robot = np.asarray(input_T_world_robot,
                                                   np.float32)
        self._committed_odom = self.last_input_T_world_robot

    # -- deferred-commit scan path (config.sync_lag > 0) --------------------

    def _process_data_deferred(self, input_T_world_robot: np.ndarray,
                               input_T_robot_sensor: np.ndarray,
                               input_cloud: Cloud) -> None:
        """The hot scan path with the per-scan device sync broken: scan
        t's registration+probe dispatch goes out immediately (with an
        odometry-extrapolated initial guess), and scan t-sync_lag's
        result is consumed while t's transfer+registration is in flight,
        so the packed-result d2h overlaps the next scan's work instead of
        serializing after it.

        Semantics note (mirrors the MT variant, LocalizerMT.hpp:122-134):
        keyframe/composition decisions lag ``sync_lag`` scans, so an
        in-flight scan may register against a map that is one decision
        stale; its committed world pose composes the relative result with
        the reference keyframe's CURRENT optimized pose
        (``_Inflight.refkf_vertex``), then re-anchors to the current
        reference keyframe."""
        log.info("[Localizer] Processing cloud #%d (deferred)", self.count)
        from .utils import counters
        counters["localizer/scans"] += 1
        key = jax.random.PRNGKey(self.count)
        self.count += 1

        if not self._inflight:
            # FRESH dispatch (every prior scan committed — always the
            # case at sync_lag=0/force_deferred, and right after a flush
            # at any lag): use the classic path's EXACT initial-guess and
            # probe-pose numerics. Mathematically this equals the
            # extrapolation below (with nothing in flight the committed
            # pose IS the refkf composition), and taking the identical
            # float ops makes the deferred machinery bit-identical to
            # the classic path whenever nothing is stale (pinned by the
            # lag-0 golden test).
            input_dT_robot = (
                np.linalg.inv(np.asarray(self.last_input_T_world_robot,
                                         np.float64))
                @ np.asarray(input_T_world_robot, np.float64)
            ).astype(np.float32)
            T0 = self.T_refkf_robot @ input_dT_robot
            T_world_refkf32 = np.asarray(
                self.local_map.reference_keyframe().optimized_T_world_kf,
                np.float32)
            T_pred32 = T_world_refkf32 @ T0
        else:
            # World-frame pose prediction: last committed pose composed
            # with the odometry increment since the last committed scan.
            # Pure odometry extrapolation across the in-flight gap — the
            # ICP correction of the uncommitted scans (typically sub-cm)
            # is the price of not syncing on them.
            T_pred_world = (
                np.asarray(self.T_world_robot, np.float64)
                @ np.linalg.inv(np.asarray(self._committed_odom,
                                           np.float64))
                @ np.asarray(input_T_world_robot, np.float64))
            T_world_refkf = np.asarray(
                self.local_map.reference_keyframe().optimized_T_world_kf,
                np.float64)
            Tinv = _rigid_inverse(T_world_refkf)
            T0 = _orthonormalize((Tinv @ T_pred_world).astype(np.float32))
            T_world_refkf32 = T_world_refkf.astype(np.float32)
            T_pred32 = T_pred_world.astype(np.float32)

        probe_comp = self.neighbor_probe_request(T_world_robot=T_pred32)
        probe_map = (self._cached_probe_map(probe_comp)
                     if probe_comp is not None else None)

        args = (self.config.input_filters,
                self.config.keyframe_cloud_capacity,
                self.icp_engine.config, input_cloud,
                jnp.asarray(input_T_robot_sensor, jnp.float32), key,
                self.icp_engine.reference, jnp.asarray(T0),
                self.icp_engine._index)
        if probe_map is not None:
            cloud, reading, packed = _prepare_register_probe(
                *args, probe_map, jnp.asarray(T_world_refkf32))
        else:
            cloud, reading, packed = _prepare_and_register(*args)
        try:
            # Start the d2h of the packed result NOW so it rides behind
            # the dispatch instead of waiting for the commit-time fetch,
            # and re-issue for the OLDEST in-flight scan — its compute
            # has finished by now, so the commit-time device_get finds
            # the bytes already host-side.
            packed.copy_to_host_async()
            if self._inflight:
                self._inflight[0].packed.copy_to_host_async()
        except (AttributeError, RuntimeError):
            pass
        self._inflight.append(_Inflight(
            packed=packed, cloud=cloud, reading=reading,
            refkf_vertex=self.local_map.reference_vertex(),
            probe_comp=probe_comp,
            odom_pose=np.asarray(input_T_world_robot, np.float32),
            comp_items=tuple(self.local_map.get_composition().as_list()),
            refkf_pose_at_dispatch=np.array(
                self.local_map.reference_keyframe().optimized_T_world_kf,
                np.float32, copy=True)))
        self.last_input_T_world_robot = np.asarray(input_T_world_robot,
                                                   np.float32)
        # Deferred loop-closure verifications dispatched by an earlier
        # commit's keyframe spawn drain HERE — after this scan's
        # registration dispatch went out, so their packed-result d2h
        # overlaps it instead of serializing inside the spawn event.
        self.mm.drain_loop_closer()
        while len(self._inflight) > self.config.sync_lag:
            self._commit(self._inflight.popleft())

    def _commit(self, inflight: _Inflight) -> None:
        """Consume one in-flight scan: fetch its packed result, update the
        pose state, and run the keyframe/composition decision tree
        (identical logic to the sync path, one sync_lag later)."""
        result, ov = _unpack_result_vec(jax.device_get(inflight.packed))
        self.last_result = result
        comp_unchanged = inflight.comp_items == tuple(
            self.local_map.get_composition().as_list())
        fresh = (
            comp_unchanged
            and inflight.refkf_vertex == self.local_map.reference_vertex()
            and inflight.refkf_pose_at_dispatch is not None
            and np.array_equal(
                inflight.refkf_pose_at_dispatch,
                np.asarray(self.local_map.reference_keyframe()
                           .optimized_T_world_kf, np.float32)))
        if fresh:
            # Nothing landed between dispatch and commit (no writeback,
            # no composition change): take the classic path's EXACT pose
            # composition so the deferred machinery is bit-identical to
            # classic whenever it is not actually stale (the lag-0
            # golden test pins per-scan equality).
            self.T_refkf_robot = _orthonormalize(np.asarray(result.T))
            self.T_world_robot = _orthonormalize(
                self.local_map.reference_keyframe().optimized_T_world_kf
                @ self.T_refkf_robot)
        else:
            # World pose: result.T is relative to the reference KEYFRAME
            # — compose with that vertex's CURRENT optimized pose so
            # closure writebacks that landed since dispatch pull the
            # live pose (see _Inflight.refkf_vertex).
            T_ref_now = np.asarray(
                self.mm.get_graph().optimized_poses[inflight.refkf_vertex],
                np.float64)
            self.T_world_robot = _orthonormalize(
                (T_ref_now @ np.asarray(result.T, np.float64))
                .astype(np.float32))
            # Re-anchor to the CURRENT reference keyframe (the
            # composition may have moved since dispatch — the accepted
            # sync_lag staleness).
            self.update_refkf_robot_pose()
        self.input_cloud = inflight.cloud
        self._last_reading = inflight.reading
        self._committed_odom = inflight.odom_pose
        if not comp_unchanged:
            # The composition changed between dispatch and commit (an
            # earlier commit spawned a keyframe or swapped the map), so
            # this scan's overlap was measured against the OLD map —
            # acting on it double-spawns keyframes 1 scan apart. Use the
            # scan for localization only; the next scan (registered
            # against the new map) resumes the decision tree. Mirrors
            # the MT variant's stale-snapshot discipline
            # (LocalizerMT.hpp:102-119: resync before committing).
            log.info("[Localizer] deferred commit against stale "
                     "composition — decision muted for this scan")
            return
        self.decide_composition(
            result, neighbor_probe=(inflight.probe_comp,
                                    None if ov is None else float(ov)))
        self.apply_composition(build=True)

    # -- streaming micro-batch path (config.micro_batch > 1) ---------------

    def _process_data_stream(self, input_T_world_robot: np.ndarray,
                             input_T_robot_sensor: np.ndarray,
                             input_cloud: Cloud) -> None:
        """Buffer the scan; dispatch when ``micro_batch`` scans are
        queued (ONE fused dispatch for the whole batch — see
        ``_prepare_register_stream``), then feed the deferred commit
        machinery. Commit lag: up to micro_batch + sync_lag scans."""
        log.info("[Localizer] Buffering cloud #%d (stream)", self.count)
        from .utils import counters
        counters["localizer/scans"] += 1
        self._microbuf.append((
            np.asarray(input_T_world_robot, np.float32),
            np.asarray(input_T_robot_sensor, np.float32),
            input_cloud, self.count))
        self.count += 1
        self.last_input_T_world_robot = np.asarray(input_T_world_robot,
                                                   np.float32)
        if len(self._microbuf) >= self.config.micro_batch:
            self._flush_microbatch()

    def _flush_microbatch(self) -> None:
        from .cloud import stack_clouds
        buf, self._microbuf = self._microbuf, []
        if not buf:
            return
        n = len(buf)
        B = self.config.micro_batch
        buf_p = buf + [buf[-1]] * (B - n)   # pad partial batch (flush)

        # Odometry-extrapolated initial guesses from the last COMMITTED
        # pose (every scan in the batch predicts against the same
        # reference keyframe snapshot — the accepted staleness).
        Tinv = _rigid_inverse(
            self.local_map.reference_keyframe().optimized_T_world_kf)
        base = (np.asarray(self.T_world_robot, np.float64)
                @ np.linalg.inv(np.asarray(self._committed_odom,
                                           np.float64)))
        T0s = np.stack([
            _orthonormalize((Tinv @ base
                             @ np.asarray(odomT, np.float64)
                             ).astype(np.float32))
            for odomT, _, _, _ in buf_p])
        raw = stack_clouds([c for _, _, c, _ in buf_p])
        T_rs = np.stack([t for _, t, _, _ in buf_p])
        seeds = np.asarray([cnt for _, _, _, cnt in buf_p], np.int32)

        slices, pvecs = _prepare_register_stream(
            self.config.input_filters,
            self.config.keyframe_cloud_capacity,
            self.icp_engine.config, raw, jnp.asarray(T_rs), seeds,
            self.icp_engine.reference, jnp.asarray(T0s))
        comp_items = tuple(self.local_map.get_composition().as_list())
        refkf_v = self.local_map.reference_vertex()
        refkf_pose = np.array(
            self.local_map.reference_keyframe().optimized_T_world_kf,
            np.float32, copy=True)
        for j in range(n):                   # real scans only, in order
            cloud_j, reading_j = slices[j]
            try:
                pvecs[j].copy_to_host_async()
            except (AttributeError, RuntimeError):
                pass
            self._inflight.append(_Inflight(
                packed=pvecs[j], cloud=cloud_j, reading=reading_j,
                refkf_vertex=refkf_v, probe_comp=None,
                odom_pose=buf[j][0], comp_items=comp_items,
                refkf_pose_at_dispatch=refkf_pose))
        self.mm.drain_loop_closer()
        while len(self._inflight) > self.config.sync_lag:
            self._commit(self._inflight.popleft())

    def flush(self) -> None:
        """Commit every in-flight scan (sync_lag / micro_batch modes) and
        drain any deferred loop-closure verifications. Call before
        reading localizer/graph state that must reflect ALL submitted
        scans — the facade's trajectory/error queries and end-of-stream
        handling do."""
        if self._microbuf:
            self._flush_microbatch()
        while self._inflight:
            self._commit(self._inflight.popleft())
            self.mm.drain_loop_closer()
        self.mm.drain_loop_closer()

    def prepare_scan(self, input_T_world_robot, input_T_robot_sensor,
                     input_cloud: Cloud, key=None, prepared: Cloud = None,
                     reading: Cloud = None):
        """Everything before the ICP dispatch. Returns (prepared reading,
        initial transform) or None if this was the first cloud (fully
        handled). Split out so a multi-agent batcher can fuse many agents'
        registrations into one device call. ``prepared`` short-circuits
        the input pipeline when the batcher already ran it; ``reading``
        additionally short-circuits the reading filter chain (the fleet
        prep applies it vmapped in the same dispatch)."""
        log.info("[Localizer] Processing cloud #%d", self.count)
        from .utils import counters
        counters["localizer/scans"] += 1
        self.count += 1
        if prepared is not None:
            cloud = prepared
        else:
            if key is None:
                # Lazy: PRNGKey construction is a device op; skip it
                # when the batcher already prepped.
                key = jax.random.PRNGKey(self.count - 1)
            # Input filters run in the sensor frame (observation directions
            # must point at the sensor, Localizer.hpp:100-103), then the
            # cloud moves to the robot frame (Localizer.hpp:106). Compact
            # to the fixed keyframe capacity so downstream shapes stay
            # static. One fused dispatch for the whole input pipeline.
            cloud = _prepare_input(self.config.input_filters,
                                   self.config.keyframe_cloud_capacity,
                                   input_cloud,
                                   jnp.asarray(input_T_robot_sensor,
                                               jnp.float32), key)
        self.input_cloud = cloud

        if not self.local_map.has_cloud():
            self.process_first_cloud(cloud, input_T_world_robot)
            self.last_input_T_world_robot = np.asarray(input_T_world_robot,
                                                       np.float32)
            return None

        # Delta-pose prediction from odometry (Localizer.hpp:119-123),
        # host-side (4x4 numpy).
        input_dT_robot = (
            np.linalg.inv(np.asarray(self.last_input_T_world_robot,
                                     np.float64))
            @ np.asarray(input_T_world_robot, np.float64)).astype(np.float32)
        input_T_refkf_robot = self.T_refkf_robot @ input_dT_robot
        if reading is None:
            reading = self.icp_engine.prepare_reading(cloud)
        self._last_reading = reading
        return reading, input_T_refkf_robot

    def finish_scan(self, result: ICPResult, input_T_world_robot) -> None:
        """Everything after the ICP dispatch: pose composition + the
        post-ICP decision tree."""
        result = self.begin_finish(result)
        self.update_after_icp(result)
        self.last_input_T_world_robot = np.asarray(input_T_world_robot,
                                                   np.float32)

    def begin_finish(self, result: ICPResult) -> ICPResult:
        """Pose composition from the ICP result (host-side state updates
        only). Returns the host-resident result. Split out so a
        multi-agent batcher can interleave its probe batching between the
        pose update and the decision tree."""
        # One transfer for the whole result bundle: the decision tree reads
        # several scalars and a separate sync per scalar costs a device
        # round-trip each on remote-attached accelerators.
        result = jax.device_get(result)
        self.last_result = result
        self.T_refkf_robot = _orthonormalize(np.asarray(result.T))
        self.T_world_robot = _orthonormalize(
            self.local_map.reference_keyframe().optimized_T_world_kf
            @ self.T_refkf_robot)
        return result

    def process_first_cloud(self, cloud: Cloud, T_world_robot) -> None:
        """``Localizer.hpp:138-152``."""
        v = self.mm.add_first_keyframe(cloud, T_world_robot)
        self.next_composition.clear()
        self.next_composition.push_back(v)
        self.local_map.update_to_new_composition(self.mm.get_graph(),
                                                 self.next_composition)
        self.icp_engine.set_map(self.local_map.cloud())
        self.T_refkf_robot = np.eye(4, dtype=np.float32)
        self.T_world_robot = np.asarray(T_world_robot, np.float32)

    # -- post-ICP decision tree (Localizer.hpp:179-261) --------------------

    def update_after_icp(self, result: ICPResult) -> None:
        self.decide_composition(result)
        self.apply_composition(build=True)

    def neighbor_probe_request(self, T_world_robot=None):
        """Phase 1 of is_better_composition: the neighbor composition that
        needs an overlap probe, or None (no neighbors / same composition —
        in which case is_better is False without any device work,
        Localizer.hpp:365-367). ``T_world_robot`` overrides the robot
        pose used for the closest-vertex ranking (the ST hot path passes
        the odometry-predicted pose so the probe can ride the
        registration dispatch)."""
        comp, found = self.find_neighbor_local_map_composition(
            T_world_robot=T_world_robot)
        if not found or self.local_map.has_same_composition(comp):
            return None
        return comp

    def decide_composition(self, result: ICPResult,
                           neighbor_probe=None) -> None:
        """The post-ICP decision tree (Localizer.hpp:179-245), with the
        overlap probe optionally precomputed (multi-agent batching).

        ``neighbor_probe``: None -> compute inline; otherwise a tuple
        (composition|None, probe_overlap|None) from
        :meth:`neighbor_probe_request` + a batched probe evaluation.
        """
        overlap = float(result.overlap)
        log.info("[Localizer] current overlap = %.4f", overlap)

        if neighbor_probe is None:
            comp = self.neighbor_probe_request()
            probe_ov = (self.compute_overlap_with(
                comp, reading=self._last_reading)
                if comp is not None else None)
        else:
            comp, probe_ov = neighbor_probe
        # is_better_composition semantics (Localizer.hpp:363-372).
        is_better = (comp is not None
                     and self.is_overlap_enough(probe_ov)
                     and probe_ov > overlap)

        if self.is_overlap_enough(overlap):
            if is_better:
                self.next_composition = comp
            else:
                # Re-reference the local map on the closest vertex
                # (Localizer.hpp:214-221).
                closest_v = self.local_map.find_closest_vertex(
                    self.T_world_robot)
                ref_v = self.local_map.reference_vertex()
                if closest_v != ref_v:
                    cur = self.local_map.get_composition()
                    items = cur.as_list()
                    i, j = items.index(closest_v), items.index(ref_v)
                    items[i], items[j] = items[j], items[i]
                    self.next_composition = Composition(cur.capacity, items)
        else:
            if is_better:
                self.next_composition = comp
            else:
                # Spawn a new keyframe (Localizer.hpp:234-240). NOTE: in the
                # single-threaded reference this call cascades synchronously
                # into LoopCloser and possibly the Optimizer before
                # returning (MapManager.hpp:96-100) — reproduced here.
                v = self.mm.add_new_keyframe(
                    self.local_map.reference_vertex(),
                    self.T_world_robot,
                    self.T_refkf_robot,
                    np.asarray(result.cov),
                    self.input_cloud)
                self.next_composition.push_back(v)
                log.info("[Localizer] next composition = %s",
                         self.next_composition)

    def apply_composition(self, build: bool = True) -> bool:
        """Rebuild the local map if the composition changed
        (Localizer.hpp:248-259). With ``build=False`` only the snapshots
        are refreshed (the multi-agent path batches the cloud builds);
        the caller must then run :meth:`finish_apply` after building.
        Returns whether the composition changed."""
        if self.local_map.has_same_composition(self.next_composition):
            return False
        old_ref = self.local_map.reference_vertex()
        self.local_map.update_to_new_composition(
            self.mm.get_graph(), self.next_composition, build=build)
        self._ref_changed = self.local_map.reference_vertex() != old_ref
        # Re-anchoring needs only poses — safe before the cloud build.
        if self._ref_changed:
            self.update_refkf_robot_pose()
        if build:
            self.finish_apply()
        return True

    def finish_apply(self) -> None:
        """Push the (re)built local-map cloud into the ICP engine."""
        self.icp_engine.set_map(self.local_map.cloud())

    def update_refkf_robot_pose(self) -> None:
        """``Localizer.hpp:264-267``. Pure host numpy: this is a 4x4
        rigid inverse + compose; an eager-device version (jnp
        ``se3.inverse`` + matmul + d2h sync) would pay op-by-op dispatch
        for a 4x4. fp64 compose, like
        every other re-anchoring site (see _orthonormalize's docstring on
        scale-error squaring)."""
        Tinv = _rigid_inverse(
            self.local_map.reference_keyframe().optimized_T_world_kf)
        self.T_refkf_robot = _orthonormalize(
            (Tinv @ np.asarray(self.T_world_robot, np.float64)
             ).astype(np.float32))

    def update_world_robot_pose(self) -> None:
        """``Localizer.hpp:270-273``."""
        self.T_world_robot = _orthonormalize(
            self.local_map.reference_keyframe().optimized_T_world_kf
            @ self.T_refkf_robot)

    # -- graph-update notification (Localizer.hpp:156-176) -----------------

    def update_from_graph(self) -> None:
        if self.defer_graph_resync:
            self._needs_resync = True
            return
        self.resync_from_graph()

    def resync_from_graph(self, build: bool = True) -> bool:
        """The actual post-optimization resync (Localizer.hpp:156-176).
        Returns whether the local map was rebuilt (with ``build=False``
        only snapshots refresh; caller batches the cloud builds)."""
        self._needs_resync = False
        if not self.local_map.has_cloud():
            return False
        graph = self.mm.get_graph()
        lm_outdated = self.local_map.is_outdated(graph)
        ref_outdated = self.local_map.is_reference_keyframe_outdated(graph)
        if lm_outdated:
            self.local_map.update_from_graph(graph, build=build)
            if build:
                self.icp_engine.set_map(self.local_map.cloud())
        if ref_outdated:
            self.update_world_robot_pose()
        return lm_outdated

    # -- overlap logic (Localizer.hpp:276-372) -----------------------------

    def is_overlap_enough(self, overlap: float) -> bool:
        if overlap < self.config.minimal_overlap:
            log.warning("[Localizer] overlap below minimal overlap! "
                        "(%.3f < %.3f)", overlap, self.config.minimal_overlap)
        if overlap < self.config.overlap_threshold:
            log.info("[Localizer] overlap below threshold! (%.3f < %.3f)",
                     overlap, self.config.overlap_threshold)
        return overlap >= self.config.overlap_threshold

    def compute_overlap_with(self, comp: Composition,
                             reading: Optional[Cloud] = None) -> float:
        """Partial-ICP overlap probe against an arbitrary composition
        (``Localizer.hpp:282-348``): build the candidate map in the world
        frame, apply the reference filter chain, match + weigh the
        current reading against it.

        The candidate-map half is cached across scans keyed on the
        composition + its members' graph update times (it only changes
        when a member pose moves), and ``reading`` lets the caller pass
        the scan's already-prepared reading (``process_data`` computes it
        inside the registration dispatch). The per-scan probe is then one
        small match dispatch instead of a full rebuild + refilter +
        reading prep."""
        from .ops.icp import compute_overlap
        cfg = self.config.icp
        world = self._cached_probe_map(comp)
        if reading is None:
            reading = self.icp_engine.prepare_reading(self.input_cloud)
        ov = compute_overlap(reading, world,
                             jnp.asarray(self.T_world_robot), cfg)
        return float(ov)

    def _cached_probe_map(self, comp: Composition) -> Cloud:
        """The probe's built + reference-filtered candidate map in the
        world frame, cached per (composition items, member update times).
        Keyframe cloud payloads are immutable after creation; poses (and
        hence the composed cloud) change only through graph writebacks,
        which bump ``update_times`` — so the pair is a sound cache key."""
        from .localmap import stack_composition
        from .utils import counters
        hit = self._probe_cache_get(comp)
        if hit is not None:
            return hit
        graph = self.mm.get_graph()
        points, masks, descs, Ts, slot_valid, desc_keys, T_world_ref = \
            stack_composition(graph, comp.as_list(), comp.capacity)
        world = _probe_build(points, masks, descs, Ts, slot_valid,
                             jnp.asarray(T_world_ref), desc_keys,
                             self.config.icp.reference_filters)
        self._probe_cache_put(comp, world)
        return world

    def _probe_cache_get(self, comp: Composition) -> Optional[Cloud]:
        """Cache lookup half of :meth:`_cached_probe_map` (the fleet
        batcher builds all misses in one dispatch)."""
        from .utils import counters
        graph = self.mm.get_graph()
        key = tuple(comp.as_list())
        times = tuple(int(graph.update_times[v]) for v in key)
        hit = self._probe_cache.get(key)
        if hit is not None and hit[0] == times:
            counters["localizer/probe_cache_hit"] += 1
            return hit[1]
        counters["localizer/probe_cache_miss"] += 1
        return None

    def _probe_cache_put(self, comp: Composition, world: Cloud) -> None:
        graph = self.mm.get_graph()
        key = tuple(comp.as_list())
        times = tuple(int(graph.update_times[v]) for v in key)
        if len(self._probe_cache) >= 8:     # bound device-memory footprint
            self._probe_cache.pop(next(iter(self._probe_cache)))
        self._probe_cache[key] = (times, world)

    def is_better_composition(self, current_overlap: float,
                              candidate: Composition) -> bool:
        """``Localizer.hpp:363-372``."""
        if self.local_map.has_same_composition(candidate):
            return False
        candidate_overlap = self.compute_overlap_with(candidate)
        return (self.is_overlap_enough(candidate_overlap)
                and candidate_overlap > current_overlap)

    # -- neighbor-composition search (Localizer.hpp:393-483) ---------------

    def find_neighbor_local_map_composition(
            self, T_world_robot=None) -> Tuple[Optional[Composition], bool]:
        graph = self.mm.get_graph()
        curr = self.local_map.get_composition().as_list()
        if T_world_robot is None:
            T_world_robot = self.T_world_robot

        # Vertices adjacent to the local map but not in it.
        adj = set()
        for v in curr:
            for a in graph.adjacent_vertices(v):
                if int(a) not in curr:
                    adj.add(int(a))
        if not adj:
            return None, False

        # Closest adjacent vertex to the robot (host numpy: tiny sets).
        adj = sorted(adj)
        robot_t = np.asarray(T_world_robot)[:3, 3]
        dists = np.linalg.norm(
            graph.optimized_poses[np.asarray(adj)][:, :3, 3] - robot_t,
            axis=1)
        closest_adj = adj[int(np.argmin(dists))]

        ext = curr + [closest_adj]

        # Topological distances from the closest adjacent vertex on the
        # subgraph induced by ext (filtered_graph, Localizer.hpp:432-451).
        vertex_ok = np.zeros(graph.n_vertices, bool)
        vertex_ok[np.asarray(ext)] = True
        e = graph.n_edges
        topo, _ = dijkstra(graph.n_vertices, graph.edge_from[:e],
                           graph.edge_to[:e], graph.edge_weight[:e],
                           closest_adj, vertex_ok=vertex_ok)

        # Sort ext by DECREASING topological distance
        # (Localizer.hpp:453-457: ascending sort through reverse iterators).
        ext.sort(key=lambda v: topo[v], reverse=True)

        # All but the last two, then the last two ordered so the vertex
        # closest to the robot lands at the back (= reference keyframe),
        # Localizer.hpp:459-480.
        comp = Composition(self.local_map.capacity())
        for v in ext[:-2]:
            comp.push_back(v)
        last, before_last = ext[-1], ext[-2]
        d_last = float(np.linalg.norm(
            graph.optimized_poses[last][:3, 3] - robot_t))
        d_before = float(np.linalg.norm(
            graph.optimized_poses[before_last][:3, 3] - robot_t))
        if d_before < d_last:
            comp.push_back(last)
            comp.push_back(before_last)
        else:
            comp.push_back(before_last)
            comp.push_back(last)
        return comp, True

    # -- map access (Localizer.hpp:375-390) --------------------------------

    def get_local_map(self) -> Tuple[Optional[Cloud], bool]:
        if self.local_map.has_cloud():
            return self.local_map.cloud(), True
        return None, False

    def get_local_map_in_world_frame(self) -> Tuple[Optional[Cloud], bool]:
        if self.local_map.has_cloud():
            return self.local_map.cloud_in_world_frame(), True
        return None, False
