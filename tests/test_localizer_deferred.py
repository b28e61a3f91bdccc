"""Deferred-commit (sync_lag > 0) single-threaded scan path.

The ST facade's per-scan packed-result sync serializes the live loop;
``LocalizerConfig.sync_lag`` breaks it by consuming scan t's result at
scan t+lag's call — the MT variant's outdated-flag semantics
(LocalizerMT.hpp:122-134) applied to the ST path. These tests pin the
semantics: same-quality trajectory, same keyframe structure (within the
one-scan decision shift), flush correctness, and exact parity while no
decision fires.
"""

import dataclasses

import numpy as np
import pytest

from pgslam_tpu.datasets import corridor_sequence
from pgslam_tpu.slam import PoseGraphSlam

from test_slam_e2e import small_config


def _deferred_config(lag):
    cfg = small_config()
    return dataclasses.replace(
        cfg, localizer=dataclasses.replace(cfg.localizer, sync_lag=lag))


def _run(config, scans, odom):
    slam = PoseGraphSlam(config)
    T_rs = np.eye(4, dtype=np.float32)
    for i, (scan, T_odom) in enumerate(zip(scans, odom)):
        slam.add_data(i, "world", T_odom, T_rs, scan)
    slam.flush()
    return slam


@pytest.fixture(scope="module")
def corridor():
    rng = np.random.default_rng(7)
    return corridor_sequence(rng, n_scans=25, scan_points=512, step=0.4,
                             noise=0.003, odom_noise=0.005, length=30.0)


@pytest.fixture(scope="module")
def runs(corridor):
    scans, odom, truth = corridor
    sync = _run(small_config(), scans, odom)
    lag1 = _run(_deferred_config(1), scans, odom)
    return sync, lag1, truth


def test_deferred_tracks_truth(runs):
    _, lag1, truth = runs
    err = np.linalg.norm(lag1.T_world_robot[:3, 3] - truth[-1][:3, 3])
    assert err < 0.25, f"final pose error {err}"


def test_deferred_matches_sync_trajectory(runs):
    """Deferred decisions lag one scan, so keyframes can shift by one
    scan position — but the recovered trajectory must agree with the
    sync path at the golden-replay tolerance used for the batched and
    sharded paths (±0.10 m)."""
    sync, lag1, _ = runs
    d = np.linalg.norm(sync.T_world_robot[:3, 3]
                       - lag1.T_world_robot[:3, 3])
    assert d < 0.10, f"sync vs deferred final pose differ by {d}"
    gs, gl = sync.get_graph(), lag1.get_graph()
    assert abs(gs.n_vertices - gl.n_vertices) <= 1
    n = min(gs.n_vertices, gl.n_vertices)
    # Keyframe POSITIONS may shift by up to one scan step when a spawn
    # decision lands one scan late; compare each deferred keyframe to its
    # nearest sync keyframe instead of index-to-index.
    ps = gs.optimized_poses[:gs.n_vertices, :3, 3]
    pl = gl.optimized_poses[:gl.n_vertices, :3, 3]
    for v in range(n):
        dmin = np.min(np.linalg.norm(ps - pl[v], axis=1))
        assert dmin < 0.55, f"keyframe {v} strays {dmin} from sync set"


def test_deferred_exact_parity_before_decisions(corridor):
    """Until the first keyframe/composition decision fires, the deferred
    path runs the IDENTICAL dispatch sequence (same seeds, same reference
    map) — poses must match the sync path to fp tolerance, not just the
    semantic window. 5 scans over 1.6 m never leave overlap>=0.8."""
    scans, odom, _ = corridor
    sync = _run(small_config(), scans[:5], odom[:5])
    lag1 = _run(_deferred_config(1), scans[:5], odom[:5])
    d = np.linalg.norm(sync.T_world_robot - lag1.T_world_robot)
    assert d < 2e-3, f"pre-decision parity broke: {d}"


def test_flush_is_idempotent_and_required(corridor):
    scans, odom, _ = corridor
    slam = PoseGraphSlam(_deferred_config(2))
    T_rs = np.eye(4, dtype=np.float32)
    for i in range(6):
        slam.localizer.process_data(odom[i].astype(np.float32), T_rs,
                                    _as_cloud(slam, scans[i]))
    # 2 scans still in flight; raw localizer state lags.
    assert len(slam.localizer._inflight) == 2
    slam.flush()
    assert len(slam.localizer._inflight) == 0
    T = slam.localizer.T_world_robot.copy()
    slam.flush()     # idempotent
    np.testing.assert_array_equal(T, slam.localizer.T_world_robot)


def _as_cloud(slam, scan):
    from pgslam_tpu.cloud import make_cloud
    return make_cloud(np.asarray(scan),
                      capacity=slam.config.sensor_cloud_capacity)


def test_facade_accessors_autoflush(corridor):
    scans, odom, _ = corridor
    slam = PoseGraphSlam(_deferred_config(3))
    T_rs = np.eye(4, dtype=np.float32)
    for i in range(8):
        slam.add_data(i, "world", odom[i], T_rs, scans[i])
    assert len(slam.localizer._inflight) > 0
    slam.trajectory()      # any accessor flushes
    assert len(slam.localizer._inflight) == 0


def test_lag2_still_tracks(corridor):
    scans, odom, truth = corridor
    lag2 = _run(_deferred_config(2), scans, odom)
    err = np.linalg.norm(lag2.T_world_robot[:3, 3] - truth[-1][:3, 3])
    assert err < 0.30, f"final pose error {err}"
