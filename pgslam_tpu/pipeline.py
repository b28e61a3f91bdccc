"""Multi-threaded SLAM pipeline — the ``*MT`` variants.

Rebuild of ``PoseGraphSlamMT`` + ``{Localizer,LoopCloser,Optimizer,
MapManager}MT``: three worker threads (localize / loop-close / optimize)
around one mutex-guarded pose graph, with the reference's exact locking
discipline:

* Localizer: ICP runs **unlocked**; ``update_after_icp`` takes the graph
  lock and re-syncs from the graph before committing, because the graph
  may have moved while ICP ran (``LocalizerMT.hpp:108-119``). Optimizer
  notifications only set an ``outdated`` flag consumed at the top of the
  worker loop (``LocalizerMT.hpp:122-134``, ``:90-93``).
* LoopCloser: candidate search holds the lock; the verification ICP runs
  unlocked on snapshot data (``LoopCloserMT.hpp:71-75``).
* Optimizer: drains *all* pending loop constraints per batch
  (``OptimizerMT.hpp:59-62``) vs the single-item ST path; the LM solve
  itself runs unlocked between the two locked phases
  (``OptimizerMT.hpp:71-82``) — including the reference's documented
  design race (SURVEY.md §3.3), reproduced rather than "fixed".

Device work happens inside jitted calls which release the GIL, so Python
threads genuinely overlap host bookkeeping with device compute.
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from typing import Optional

import numpy as np

from .cloud import Cloud, make_cloud
from .graph.pose_graph import MapManager
from .localizer import Localizer, LocalizerConfig
from .loopcloser import LoopCloser, LoopCloserConfig
from .optimizer import Optimizer, OptimizerConfig
from .slam import SlamConfig

log = logging.getLogger("pgslam_tpu.pipeline")


class MapManagerMT(MapManager):
    """Adds exactly one thing: the graph lock (``MapManagerMT.h:17-25``)."""

    def __init__(self):
        super().__init__()
        self._graph_lock = threading.RLock()

    def get_graph_lock(self) -> threading.RLock:
        return self._graph_lock


class _Worker:
    """Shared worker-thread scaffolding (queue + condvar + stop flag)."""

    def __init__(self, name: str):
        self._name = name
        self._queue = deque()
        self._mutex = threading.Lock()
        self._cond = threading.Condition(self._mutex)
        self._stop = False
        self._busy = False
        self._thread: Optional[threading.Thread] = None

    def run(self) -> None:
        log.info("[%s] Starting main thread...", self._name)
        self._stop = False
        self._thread = threading.Thread(target=self._main, name=self._name,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        with self._mutex:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def _enqueue(self, item) -> None:
        with self._mutex:
            self._queue.append(item)
            self._cond.notify()

    def idle(self) -> bool:
        with self._mutex:
            return not self._queue and not self._busy

    def _main(self):  # pragma: no cover - overridden
        raise NotImplementedError


class LocalizerMT(Localizer, _Worker):
    """``LocalizerMT.h/hpp``."""

    def __init__(self, map_manager: MapManagerMT,
                 config: LocalizerConfig = LocalizerConfig()):
        if config.micro_batch > 1:
            # Streaming micro-batches buffer scans inside process_data;
            # the MT worker's wait_idle has no flush hook, so buffered
            # scans would strand silently between drains. The MT path
            # already overlaps work via its thread + the sync_lag /
            # deferred-resync machinery — use those here.
            raise ValueError(
                "LocalizerConfig.micro_batch is a single-threaded "
                "streaming mode; the MT pipeline would strand buffered "
                "scans. Use sync_lag (and deferred_verification) with "
                "PoseGraphSlamMT instead.")
        Localizer.__init__(self, map_manager, config)
        _Worker.__init__(self, "LocalizerMT")
        self._outdated = False

    # Data entry: enqueue only (LocalizerMT.hpp:27-40).
    def add_new_data(self, timestamp, world_frame_id, T_world_robot,
                     T_robot_sensor, cloud: Cloud) -> None:
        self._enqueue((timestamp, world_frame_id,
                       np.asarray(T_world_robot, np.float32),
                       np.asarray(T_robot_sensor, np.float32), cloud))

    def _main(self):
        while True:
            item = None
            outdated = False
            with self._mutex:
                while not self._queue and not self._stop and not self._outdated:
                    self._cond.wait()
                if self._stop:
                    break
                outdated, self._outdated = self._outdated, False
                if self._queue:
                    item = self._queue.popleft()
                    self._busy = True
            # Resync before processing — also keeps the pose fresh when
            # there is no data (LocalizerMT.hpp:84-93).
            if outdated:
                with self.mm.get_graph_lock():
                    Localizer.update_from_graph(self)
            if item is not None:
                try:
                    _, _, T_world_robot, T_robot_sensor, cloud = item
                    self.process_data(T_world_robot, T_robot_sensor, cloud)
                finally:
                    with self._mutex:
                        self._busy = False

    # Graph-touching virtual overrides (LocalizerMT.hpp:101-119).
    def process_first_cloud(self, cloud, T_world_robot) -> None:
        with self.mm.get_graph_lock():
            Localizer.process_first_cloud(self, cloud, T_world_robot)

    def update_after_icp(self, result) -> None:
        with self.mm.get_graph_lock():
            # The graph may have been updated while ICP ran unlocked.
            Localizer.update_from_graph(self)
            Localizer.update_after_icp(self, result)

    def update_from_graph(self) -> None:
        # Just flag; the worker loop performs the actual resync
        # (LocalizerMT.hpp:122-134).
        with self._mutex:
            self._outdated = True
            self._cond.notify()


class LoopCloserMT(LoopCloser, _Worker):
    """``LoopCloserMT.h/hpp``."""

    def __init__(self, map_manager: MapManagerMT, optimizer,
                 config: LoopCloserConfig = LoopCloserConfig()):
        LoopCloser.__init__(self, map_manager, optimizer, config)
        _Worker.__init__(self, "LoopCloserMT")

    def add_new_vertex(self, v: int) -> None:
        self._enqueue(int(v))

    def _main(self):
        while True:
            with self._mutex:
                while not self._queue and not self._stop:
                    self._cond.wait()
                if self._stop:
                    break
                v = self._queue.popleft()
                self._busy = True
            try:
                self.process_vertex(v)
            finally:
                with self._mutex:
                    self._busy = False

    def process_local_map_candidate(self) -> bool:
        # Candidate search + input snapshot under the lock; the
        # verification ICP in process_vertex runs unlocked
        # (LoopCloserMT.hpp:71-75).
        with self.mm.get_graph_lock():
            return LoopCloser.process_local_map_candidate(self)


class OptimizerMT(Optimizer, _Worker):
    """``OptimizerMT.h/hpp``."""

    def __init__(self, map_manager: MapManagerMT,
                 config: OptimizerConfig = OptimizerConfig()):
        Optimizer.__init__(self, map_manager, config)
        _Worker.__init__(self, "OptimizerMT")

    def add_new_data(self, from_v, to_v, T_from_to, cov_from_to) -> None:
        self._enqueue((int(from_v), int(to_v),
                       np.asarray(T_from_to, np.float32),
                       np.asarray(cov_from_to, np.float32)))

    def _main(self):
        while True:
            with self._mutex:
                while not self._queue and not self._stop:
                    self._cond.wait()
                if self._stop:
                    break
                # Drain ALL pending constraints into one batch
                # (OptimizerMT.hpp:59-62).
                self.data_buffer = list(self._queue)
                self._queue.clear()
                self._busy = True
            try:
                self.process_data()
            finally:
                with self._mutex:
                    self._busy = False

    def prepare_for_optimization(self):
        with self.mm.get_graph_lock():
            return Optimizer.prepare_for_optimization(self)

    def prepare_for_optimization_resident(self):
        # Same locking discipline as prepare_for_optimization: the delta
        # snapshot reads the graph; the fused solve that follows runs
        # unlocked (OptimizerMT.hpp:71-82).
        with self.mm.get_graph_lock():
            return Optimizer.prepare_for_optimization_resident(self)

    def update_after_optimization(self, new_poses) -> None:
        with self.mm.get_graph_lock():
            Optimizer.update_after_optimization(self, new_poses)


class PoseGraphSlamMT:
    """Multi-threaded facade (``PoseGraphSlamMT.h:18-30``)."""

    def __init__(self, config: SlamConfig = SlamConfig()):
        self.config = config
        self.map_manager = MapManagerMT()
        self.optimizer = OptimizerMT(self.map_manager, config.optimizer)
        self.loop_closer = LoopCloserMT(self.map_manager, self.optimizer,
                                        config.loop_closer)
        self.localizer = LocalizerMT(self.map_manager, config.localizer)
        self.map_manager.set_localizer(self.localizer)
        self.map_manager.set_loop_closer(self.loop_closer)
        self._workers = (self.localizer, self.loop_closer, self.optimizer)

    def run(self) -> None:
        """Start the three worker threads (``PoseGraphSlamMT.hpp:21-26``)."""
        for w in self._workers:
            w.run()

    Run = run

    def stop(self) -> None:
        """Dtor analog: flag stop, wake workers, join
        (``LocalizerMT.hpp:17-24`` pattern x3)."""
        for w in self._workers:
            w.stop()

    def __enter__(self):
        self.run()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def wait_idle(self, timeout: float = 60.0, poll: float = 0.02) -> bool:
        """Block until all queues drain and workers are idle (test helper;
        the reference has no equivalent — it relies on sleeps)."""
        import time
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(w.idle() for w in self._workers):
                # Double-check after a poll: a worker may be mid-handoff.
                time.sleep(poll)
                if all(w.idle() for w in self._workers):
                    return True
            time.sleep(poll)
        return False

    # -- data entry --------------------------------------------------------

    def add_data(self, timestamp, world_frame_id, T_world_robot,
                 T_robot_sensor, cloud) -> None:
        if not isinstance(cloud, Cloud):
            cloud = make_cloud(np.asarray(cloud),
                               capacity=self.config.sensor_cloud_capacity)
        self.localizer.add_new_data(timestamp, world_frame_id, T_world_robot,
                                    T_robot_sensor, cloud)

    AddData = add_data

    def flush(self) -> None:
        """Base-facade parity (deferred commits are an ST-path feature;
        the MT localizer's in-flight queue is always empty — its worker
        thread IS the deferred consumer)."""
        self.localizer.flush()

    # -- state access ------------------------------------------------------

    def get_graph(self):
        return self.map_manager.get_graph()

    def trajectory(self) -> np.ndarray:
        with self.map_manager.get_graph_lock():
            g = self.map_manager.get_graph()
            return g.optimized_poses[:g.n_vertices].copy()

    def write_graphviz(self, path: str) -> None:
        with self.map_manager.get_graph_lock():
            self.map_manager.write_graphviz(path)

    # Base-facade accessors (the reference MT facade inherits these from
    # PoseGraphSlamBase; mirror that surface). Reads of localizer state
    # are safe: the worker publishes them atomically under the graph lock.
    @property
    def T_world_robot(self) -> np.ndarray:
        return self.localizer.T_world_robot

    def get_local_map(self):
        return self.localizer.get_local_map()

    def get_local_map_in_world_frame(self):
        return self.localizer.get_local_map_in_world_frame()

    def global_map(self, max_points_per_keyframe: int = 0) -> np.ndarray:
        from .slam import PoseGraphSlam
        with self.map_manager.get_graph_lock():
            return PoseGraphSlam.global_map(self, max_points_per_keyframe)

    WriteGraphviz = write_graphviz
