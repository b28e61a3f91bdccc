"""End-to-end SLAM integration tests on synthetic sequences
(BASELINE configs 2 and 3, scaled down for CI)."""

import numpy as np
import pytest

from pgslam_tpu.datasets import corridor_sequence, loop_sequence
from pgslam_tpu.localizer import LocalizerConfig
from pgslam_tpu.loopcloser import LoopCloserConfig
from pgslam_tpu.ops import outlier as O
from pgslam_tpu.ops.icp import ICPConfig
from pgslam_tpu.slam import PoseGraphSlam, SlamConfig


def small_config(sensor_cap=768, kf_cap=512):
    icp = ICPConfig(error="point_to_point", max_iterations=30,
                    outlier=(O.TrimmedDist(0.9), O.MaxDist(0.5)),
                    trans_eps=1e-3, rot_eps=1e-3,
                    max_correction_trans=2.0, max_correction_rot=0.5)
    return SlamConfig(
        localizer=LocalizerConfig(icp=icp, keyframe_cloud_capacity=kf_cap,
                                  overlap_threshold=0.8),
        loop_closer=LoopCloserConfig(
            icp=icp, topo_dist_threshold=6.0, geom_dist_threshold=3.0,
            overlap_threshold=0.7, residual_error_threshold=5000.0),
        sensor_cloud_capacity=sensor_cap,
    )


@pytest.fixture(scope="module")
def corridor_run():
    rng = np.random.default_rng(7)
    scans, odom, truth = corridor_sequence(
        rng, n_scans=25, scan_points=512, step=0.4, noise=0.003,
        odom_noise=0.005, length=30.0)
    slam = PoseGraphSlam(small_config())
    T_rs = np.eye(4, dtype=np.float32)
    for i, (scan, T_odom) in enumerate(zip(scans, odom)):
        slam.add_data(i, "world", T_odom, T_rs, scan)
    return slam, truth


def test_corridor_tracks_truth(corridor_run):
    slam, truth = corridor_run
    # Robot pose must track ground truth much better than raw odometry.
    T_est = slam.localizer.T_world_robot
    err = np.linalg.norm(T_est[:3, 3] - truth[-1][:3, 3])
    assert err < 0.25, f"final pose error {err}"


def test_corridor_spawns_keyframes(corridor_run):
    slam, _ = corridor_run
    g = slam.get_graph()
    # 25 scans over 9.6 m with a 0.8 overlap threshold: several keyframes.
    assert 2 <= g.n_vertices <= 25
    assert g.n_edges >= g.n_vertices - 1
    # odometry chain: consecutive ids
    assert list(g.edge_from[:g.n_vertices - 1]) == \
        list(range(g.n_vertices - 1))


def test_corridor_local_map_api(corridor_run):
    slam, _ = corridor_run
    cloud, ok = slam.get_local_map()
    assert ok and cloud is not None
    wcloud, ok2 = slam.get_local_map_in_world_frame()
    assert ok2 and int(wcloud.count()) == int(cloud.count())


def test_corridor_graphviz(corridor_run, tmp_path):
    slam, _ = corridor_run
    p = tmp_path / "graph.dot"
    slam.write_graphviz(str(p))
    assert p.read_text().startswith("graph G {")


def loop_config():
    """Configuration proven to close the ring loop (see
    scripts/loop_experiment.py; validated end-to-end on the 140-scan
    sequence: drift 0.505 m -> 0.027 m after one accepted closure)."""
    icp = ICPConfig(error="point_to_point", max_iterations=30,
                    outlier=(O.TrimmedDist(0.85), O.MaxDist(0.5)),
                    trans_eps=5e-3, rot_eps=5e-3,
                    max_correction_trans=2.0, max_correction_rot=0.5)
    return SlamConfig(
        localizer=LocalizerConfig(icp=icp, keyframe_cloud_capacity=1024,
                                  overlap_threshold=0.8),
        loop_closer=LoopCloserConfig(
            icp=icp, topo_dist_threshold=10.0, geom_dist_threshold=4.0,
            overlap_threshold=0.6, residual_error_threshold=5000.0),
        sensor_cloud_capacity=1024)


@pytest.mark.slow
def test_loop_closure_fires():
    rng = np.random.default_rng(3)
    scans, odom, truth = loop_sequence(
        rng, n_scans=140, scan_points=1024, radius=12.0, max_range=8.0,
        noise=0.002, odom_drift=0.002)
    slam = PoseGraphSlam(loop_config())
    T_rs = np.eye(4, dtype=np.float32)
    for i, (scan, T_odom) in enumerate(zip(scans, odom)):
        slam.add_data(i, "world", T_odom, T_rs, scan)
    g = slam.get_graph()
    from pgslam_tpu.graph.pose_graph import LOOP_CONSTRAINT
    n_loops = int(np.sum(g.edge_type[:g.n_edges] == LOOP_CONSTRAINT))
    assert n_loops >= 1, "expected at least one accepted loop closure"
    # After optimization the final pose should be near truth despite drift.
    T_est = slam.localizer.T_world_robot
    err = np.linalg.norm(T_est[:3, 3] - truth[-1][:3, 3])
    drift_err = np.linalg.norm(odom[-1][:3, 3] - truth[-1][:3, 3])
    assert err < 0.5 * drift_err, f"err {err} vs drift {drift_err}"


@pytest.mark.gpu
def test_loop_closure_fires_on_card(gpu):
    # The ring drive of test_loop_closure_fires through PoseGraphSlam on
    # the card, with the matcher kernel: closes the loop and beats drift.
    import dataclasses

    import jax
    rng = np.random.default_rng(3)
    scans, odom, truth = loop_sequence(
        rng, n_scans=140, scan_points=1024, radius=12.0, max_range=8.0,
        noise=0.002, odom_drift=0.002)
    cfg = loop_config()
    icp = dataclasses.replace(cfg.localizer.icp, matcher="pallas")
    cfg = dataclasses.replace(
        cfg, localizer=dataclasses.replace(cfg.localizer, icp=icp),
        loop_closer=dataclasses.replace(cfg.loop_closer, icp=icp))
    with jax.default_device(gpu):
        slam = PoseGraphSlam(cfg)
        T_rs = np.eye(4, dtype=np.float32)
        for i, (scan, T_odom) in enumerate(zip(scans, odom)):
            slam.add_data(i, "world", T_odom, T_rs, scan)
        g = slam.get_graph()
        from pgslam_tpu.graph.pose_graph import LOOP_CONSTRAINT
        n_loops = int(np.sum(g.edge_type[:g.n_edges] == LOOP_CONSTRAINT))
        err = np.linalg.norm(slam.T_world_robot[:3, 3] - truth[-1][:3, 3])
    drift_err = np.linalg.norm(odom[-1][:3, 3] - truth[-1][:3, 3])
    assert n_loops >= 1
    assert err < 0.5 * drift_err, f"err {err} vs drift {drift_err}"
