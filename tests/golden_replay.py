"""Shared definition of the golden-replay sequence.

One canonical corridor-style loop sequence + SLAM config, used by
``scripts/make_golden_replay.py`` (records the single-threaded facade's
trajectory as the committed fixture ``tests/fixtures/golden_replay.npz``)
and by ``tests/test_golden_replay.py`` (asserts the ST path reproduces the
fixture bit-tight, and that the MT / batched-fleet / sharded paths
reproduce the same trajectory within tolerance).

This is the strongest reference-parity evidence available in this
environment: the C++ reference is not buildable here (no
libpointmatcher/GTSAM), so "same trajectories on replayed sequences"
(BASELINE.json north star) is pinned by cross-path agreement against one
recorded replay instead — see PARITY.md.
"""

import os

import numpy as np

from pgslam_tpu.datasets import loop_sequence
from pgslam_tpu.localizer import LocalizerConfig
from pgslam_tpu.loopcloser import LoopCloserConfig
from pgslam_tpu.ops import outlier as O
from pgslam_tpu.ops.icp import ICPConfig
from pgslam_tpu.slam import SlamConfig

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "golden_replay.npz")

N_SCANS = 70
SCAN_POINTS = 512


def golden_sequence():
    """Deterministic loop sequence with odometric drift and a loop-closure
    opportunity at the end. Seed is part of the fixture definition."""
    rng = np.random.default_rng(3)
    return loop_sequence(rng, n_scans=N_SCANS, scan_points=SCAN_POINTS,
                         radius=10.0, max_range=8.0, noise=0.002,
                         odom_drift=0.002)


def golden_config() -> SlamConfig:
    # trans/rot_eps are deliberately TIGHT (1e-3, vs the 5e-3 production
    # default for this scale): cross-path pose agreement is bounded by
    # the ICP convergence tolerance per scan (different execution paths
    # stop at different iterates inside the tolerance ball), and it
    # compounds by dead reckoning between keyframes — 5e-3 * 60 scans
    # would swamp the 0.10 m parity tolerance this fixture pins.
    icp = ICPConfig(error="point_to_point", max_iterations=40,
                    outlier=(O.TrimmedDist(0.85), O.MaxDist(0.5)),
                    trans_eps=1e-3, rot_eps=1e-3,
                    max_correction_trans=2.0, max_correction_rot=0.5)
    return SlamConfig(
        localizer=LocalizerConfig(icp=icp, keyframe_cloud_capacity=512,
                                  overlap_threshold=0.8),
        loop_closer=LoopCloserConfig(
            icp=icp, topo_dist_threshold=10.0, geom_dist_threshold=4.0,
            overlap_threshold=0.6, residual_error_threshold=5000.0),
        sensor_cloud_capacity=512)


def run_st_replay():
    """Run the single-threaded facade over the golden sequence; returns
    (per_scan_poses [n,4,4], trajectory [n_kf,4,4], n_loop_edges)."""
    per_scan, trajectory, stats = _replay(golden_sequence(),
                                          golden_config())
    return per_scan, trajectory, stats["n_loops"]


# ---- long fixture ---------------------------------------------------------
# 300 scans over a 3-petal clover: every petal return to the shared
# center is a distinct far-in-topology revisit, so ONE deterministic
# sequence pins >=3 accepted closures, >=3 post-optimization re-anchors,
# and multiple local-map composition swaps (a multi-lap ring cannot: lap
# 2 relocalizes against lap-1 keyframes and only the single wrap point
# ever closes). Prototype run: 50 keyframes, 3 closures, 11 reference
# swaps, final err 0.029 m.

FIXTURE_LONG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "fixtures", "golden_replay_long.npz")
N_SCANS_LONG = 300


def long_sequence():
    from pgslam_tpu.datasets import clover_sequence
    rng = np.random.default_rng(5)
    return clover_sequence(rng, n_scans=N_SCANS_LONG, scan_points=512,
                           petals=3, radius=8.0, noise=0.002,
                           odom_drift=0.002)


def _replay(seq, config, sync_lag: int = 0):
    """Drive the ST facade over ``seq``; returns (per_scan_poses,
    trajectory, stats) where stats counts the decision events the long
    fixture exists to pin (closures, optimizer runs, composition
    swaps)."""
    import dataclasses

    from pgslam_tpu.graph.pose_graph import LOOP_CONSTRAINT
    from pgslam_tpu.slam import PoseGraphSlam
    from pgslam_tpu.utils import counters

    if sync_lag:
        config = dataclasses.replace(
            config, localizer=dataclasses.replace(config.localizer,
                                                  sync_lag=sync_lag))
    scans, odom, _ = seq
    slam = PoseGraphSlam(config)
    T_rs = np.eye(4, dtype=np.float32)
    opt_runs0 = counters["optimizer/runs"]
    per_scan = []
    swaps = 0
    prev_comp = None
    for i, (scan, T_odom) in enumerate(zip(scans, odom)):
        slam.add_data(i, "world", T_odom, T_rs, scan)
        # NOTE: with sync_lag > 0 this pose trails by up to sync_lag
        # scans (deferred commits) — compare with a matching window.
        per_scan.append(slam.localizer.T_world_robot.copy())
        comp = tuple(
            slam.localizer.local_map.get_composition().as_list())
        if prev_comp is not None and comp != prev_comp \
                and set(comp) == set(prev_comp):
            swaps += 1
        prev_comp = comp
    slam.flush()
    if sync_lag or config.localizer.micro_batch > 1:
        per_scan[-1] = slam.localizer.T_world_robot.copy()
    g = slam.get_graph()
    stats = {
        "n_loops": int(np.sum(g.edge_type[:g.n_edges] == LOOP_CONSTRAINT)),
        "n_keyframes": int(g.n_vertices),
        "n_swaps": swaps,
        "opt_runs": int(counters["optimizer/runs"] - opt_runs0),
    }
    return np.stack(per_scan), slam.trajectory(), stats


def run_st_replay_long():
    return _replay(long_sequence(), golden_config())


# ---- 64k-scale fixture (slow tier) ----------------------------------------
# The production velodyne working set (2k/8k voxel, point-to-plane) over
# a short corridor drive: pins the 64k-scale decision path bit-tight on
# the CPU backend (the pallas matcher falls back to the identical exact
# brute kNN there).

FIXTURE_64K = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "fixtures", "golden_replay_64k.npz")
N_SCANS_64K = 16    # 10 scans never left overlap>=0.8 (zero spawns)


def sequence_64k():
    from pgslam_tpu.datasets import corridor_world, render_scan
    rng = np.random.default_rng(0)
    world = corridor_world(rng, n_points=200000, length=60.0, width=8.0,
                           height=5.0)
    poses, scans = [], []
    for i in range(N_SCANS_64K):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [2.0 + i * 1.0, 0.0, 1.8]
        poses.append(T)
        scans.append(render_scan(world, T, rng, 65536, max_range=30.0,
                                 noise=0.01))
    return scans, poses, poses


def config_64k():
    import os as _os
    import sys as _sys
    _sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "examples"))
    from velodyne_slam import velodyne_config
    return velodyne_config()


def run_st_replay_64k():
    return _replay(sequence_64k(), config_64k())
