import numpy as np
import pytest

from pgslam_tpu.config import (load_slam_config, parse_filter_chain,
                               parse_icp_config, parse_outlier_chain)
from pgslam_tpu.ops import filters as F
from pgslam_tpu.ops import outlier as O

ICP_YAML = """
readingDataPointsFilters:
  - RandomSamplingDataPointsFilter: {prob: 0.5}
referenceDataPointsFilters:
  - SurfaceNormalDataPointsFilter: {knn: 10}
matcher:
  KDTreeMatcher: {knn: 1}
outlierFilters:
  - TrimmedDistOutlierFilter: {ratio: 0.8}
  - MaxDistOutlierFilter: {maxDist: 2.0}
errorMinimizer: PointToPlaneErrorMinimizer
transformationCheckers:
  - CounterTransformationChecker: {maxIterationCount: 25}
  - DifferentialTransformationChecker: {minDiffTransErr: 0.01,
                                        minDiffRotErr: 0.005}
"""


def test_parse_icp_yaml():
    cfg = parse_icp_config(ICP_YAML)
    assert cfg.error == "point_to_plane"
    assert cfg.max_iterations == 25
    assert cfg.trans_eps == 0.01 and cfg.rot_eps == 0.005
    assert cfg.outlier == (O.TrimmedDist(0.8), O.MaxDist(2.0))
    assert cfg.reading_filters == (F.RandomSampling(0.5),)
    assert cfg.reference_filters == (F.SurfaceNormal(knn=10),)
    # KDTreeMatcher maps to the exact-kNN matcher kernel (brute force
    # on the CPU backend).
    assert cfg.matcher == "pallas" and cfg.knn == 1
    # Frozen dataclass -> hashable -> usable as a jit static arg.
    hash(cfg)


def test_parse_grid_matcher():
    cfg = parse_icp_config("""
matcher:
  GridMatcher: {cellSize: 0.5, bucketCap: 16}
""")
    assert cfg.matcher == "grid"
    assert cfg.grid_cell_size == 0.5 and cfg.grid_bucket_cap == 16


def test_parse_chains_and_errors():
    chain = parse_filter_chain([
        "IdentityDataPointsFilter",
        {"MaxDistDataPointsFilter": {"maxDist": 30.0}},
        {"VoxelGridDataPointsFilter": {"vSizeX": 0.1}},
    ])
    assert chain == (F.Identity(), F.MaxDist(30.0), F.VoxelGrid(0.1))
    try:
        parse_outlier_chain([{"BogusFilter": {}}])
        assert False
    except ValueError as e:
        assert "BogusFilter" in str(e)


def test_load_slam_config(tmp_path):
    p = tmp_path / "slam.yaml"
    p.write_text("""
localizer:
  localMapSize: 4
  overlapThreshold: 0.75
  inputFilters:
    - MaxDistDataPointsFilter: {maxDist: 20.0}
  icp:
    errorMinimizer: PointToPointErrorMinimizer
loopCloser:
  topoDistThreshold: 5.0
sensorCloudCapacity: 4096
""")
    cfg = load_slam_config(str(p))
    assert cfg.localizer.local_map_size == 4
    assert cfg.localizer.overlap_threshold == 0.75
    assert cfg.localizer.icp.error == "point_to_point"
    assert cfg.loop_closer.topo_dist_threshold == 5.0
    assert cfg.sensor_cloud_capacity == 4096


def test_checkpoint_roundtrip(tmp_path, rng):
    from pgslam_tpu.cloud import make_cloud
    from pgslam_tpu.graph.pose_graph import MapManager, ODOM_CONSTRAINT
    from pgslam_tpu.io import load_checkpoint, save_checkpoint

    mm = MapManager()
    c0 = make_cloud(rng.normal(size=(10, 3)).astype(np.float32), capacity=16,
                    descriptors={"normals": np.ones((10, 3), np.float32)})
    mm.add_first_keyframe(c0, np.eye(4, dtype=np.float32))
    T1 = np.eye(4, dtype=np.float32)
    T1[0, 3] = 2.0
    mm.graph.add_vertex(make_cloud(rng.normal(size=(12, 3)), capacity=16),
                        T1, mm.now())
    mm.graph.add_edge(0, 1, T1, np.eye(6, dtype=np.float32) * 0.1,
                      ODOM_CONSTRAINT)

    path = tmp_path / "ckpt.npz"
    save_checkpoint(str(path), mm)

    mm2 = MapManager()
    load_checkpoint(str(path), mm2)
    g2 = mm2.get_graph()
    assert g2.n_vertices == 2 and g2.n_edges == 1
    assert mm2.fixed_vertex == 0
    np.testing.assert_allclose(g2.optimized_poses[1], T1)
    np.testing.assert_allclose(np.asarray(g2.clouds[0].points),
                               np.asarray(c0.points))
    assert "normals" in g2.clouds[0].descriptors
    np.testing.assert_allclose(g2.edge_cov[0], np.eye(6) * 0.1)
    # Resume works: clock advanced past saved stamps.
    assert mm2.now() > int(g2.update_times[:2].max())


def test_from_config_paths(tmp_path):
    """Reference ctor parity: three libpointmatcher YAML paths."""
    icp_p = tmp_path / "icp.yaml"
    icp_p.write_text("errorMinimizer: PointToPointErrorMinimizer\n"
                     "outlierFilters:\n"
                     "  - TrimmedDistOutlierFilter: {ratio: 0.8}\n")
    filt_p = tmp_path / "filters.yaml"
    filt_p.write_text("- MaxDistDataPointsFilter: {maxDist: 25.0}\n")
    loop_p = tmp_path / "loop_icp.yaml"
    loop_p.write_text("errorMinimizer: PointToPlaneErrorMinimizer\n")

    from pgslam_tpu.slam import PoseGraphSlam
    slam = PoseGraphSlam.from_config_paths(str(icp_p), str(filt_p),
                                           str(loop_p))
    assert slam.localizer.config.icp.error == "point_to_point"
    assert slam.localizer.config.input_filters == (F.MaxDist(25.0),)
    assert slam.loop_closer.config.icp.error == "point_to_plane"


def test_component_set_icp_config(tmp_path, rng):
    """Per-component SetIcpConfig parity (Localizer.hpp:55, LoopCloser.hpp:59)."""
    p = tmp_path / "icp.yaml"
    p.write_text("errorMinimizer: PointToPlaneErrorMinimizer\n")
    from pgslam_tpu.graph.pose_graph import MapManager
    from pgslam_tpu.localizer import Localizer
    from pgslam_tpu.loopcloser import LoopCloser
    from pgslam_tpu.optimizer import Optimizer
    mm = MapManager()
    opt = Optimizer(mm)
    lc = LoopCloser(mm, opt)
    loc = Localizer(mm)
    loc.set_icp_config(str(p))
    lc.set_icp_config(str(p))
    assert loc.config.icp.error == "point_to_plane"
    assert lc.config.icp.error == "point_to_plane"


def test_pm_cov_reorder_involutive(rng):
    from pgslam_tpu.optimizer import pm_cov_to_gtsam_cov
    c = rng.normal(size=(6, 6)).astype(np.float32)
    c = c @ c.T
    g = pm_cov_to_gtsam_cov(c)
    # block swap: translation block moves to the lower-right
    np.testing.assert_allclose(g[:3, :3], c[3:, 3:])
    np.testing.assert_allclose(g[3:, 3:], c[:3, :3])
    np.testing.assert_allclose(pm_cov_to_gtsam_cov(g), c)


def test_facade_set_icp_config_after_first_scan(tmp_path, rng):
    """Advisor r1 (medium): facade SetIcpConfig must delegate to the
    components so a live local map is re-installed into the rebuilt ICP
    engine — calling it between scans must not break add_data."""
    p = tmp_path / "icp.yaml"
    p.write_text("errorMinimizer: PointToPointErrorMinimizer\n"
                 "outlierFilters:\n"
                 "  - TrimmedDistOutlierFilter: {ratio: 0.9}\n")
    from pgslam_tpu.slam import PoseGraphSlam, SlamConfig
    from pgslam_tpu.localizer import LocalizerConfig

    slam = PoseGraphSlam(SlamConfig(
        localizer=LocalizerConfig(keyframe_cloud_capacity=256),
        sensor_cloud_capacity=256))
    pts = rng.uniform(-3, 3, size=(200, 3)).astype(np.float32)
    eye = np.eye(4, dtype=np.float32)
    slam.add_data(0, "world", eye, eye, pts)
    slam.set_icp_config(str(p))          # one-path convenience form
    assert slam.localizer.icp_engine._reference is not None
    T = eye.copy()
    T[0, 3] = 0.05
    slam.add_data(1, "world", T, eye, pts + np.array([0.05, 0, 0],
                                                     np.float32))
    assert np.isfinite(slam.T_world_robot).all()


def test_facade_set_icp_config_three_paths(tmp_path):
    """Reference signature parity (PoseGraphSlam.hpp:43-51): three YAML
    paths fan out to input filters / localizer ICP / loop-closer ICP."""
    filt_p = tmp_path / "filters.yaml"
    filt_p.write_text("- MaxDistDataPointsFilter: {maxDist: 30.0}\n")
    loc_p = tmp_path / "loc_icp.yaml"
    loc_p.write_text("errorMinimizer: PointToPointErrorMinimizer\n")
    loop_p = tmp_path / "loop_icp.yaml"
    loop_p.write_text("errorMinimizer: PointToPlaneErrorMinimizer\n")
    from pgslam_tpu.slam import PoseGraphSlam
    slam = PoseGraphSlam()
    slam.SetIcpConfig(str(filt_p), str(loc_p), str(loop_p))
    assert slam.localizer.config.input_filters == (F.MaxDist(30.0),)
    assert slam.localizer.config.icp.error == "point_to_point"
    assert slam.loop_closer.config.icp.error == "point_to_plane"
    with pytest.raises(TypeError):
        slam.set_icp_config(str(filt_p), str(loc_p))


def test_yaml_unset_optimizer_keys_use_dataclass_defaults(tmp_path):
    """Advisor r1 (low): YAML path and programmatic path must agree on
    defaults for unset optimizer keys."""
    from pgslam_tpu.config import load_slam_config
    from pgslam_tpu.optim.pgo import PGOConfig
    p = tmp_path / "slam.yaml"
    p.write_text("optimizer: {priorSigma: 1.0e-5}\n")
    cfg = load_slam_config(str(p))
    assert cfg.optimizer.pgo.cg_iterations == PGOConfig().cg_iterations
    assert cfg.optimizer.pgo.max_iterations == PGOConfig().max_iterations
    assert cfg.optimizer.pgo.prior_sigma == 1e-5


def test_trajectory_kitti_roundtrip(tmp_path):
    import jax
    import jax.numpy as jnp

    from pgslam_tpu import se3
    from pgslam_tpu.io import load_trajectory_kitti, save_trajectory_kitti

    rng = np.random.default_rng(3)
    tw = jnp.asarray(rng.normal(size=(7, 6)) * 0.5, jnp.float32)
    poses = np.asarray(jax.vmap(se3.exp)(tw))
    path = str(tmp_path / "traj.kitti")
    save_trajectory_kitti(path, poses)
    back = load_trajectory_kitti(path)
    np.testing.assert_allclose(back, poses, atol=1e-6)


def test_trajectory_tum_roundtrip(tmp_path):
    import jax
    import jax.numpy as jnp

    from pgslam_tpu import se3
    from pgslam_tpu.io import load_trajectory_tum, save_trajectory_tum

    rng = np.random.default_rng(4)
    tw = jnp.asarray(rng.normal(size=(9, 6)) * 0.8, jnp.float32)
    poses = np.asarray(jax.vmap(se3.exp)(tw))
    ts = np.linspace(100.0, 101.6, 9)
    path = str(tmp_path / "traj.tum")
    save_trajectory_tum(path, poses, ts)
    ts2, back = load_trajectory_tum(path)
    np.testing.assert_allclose(ts2, ts, atol=1e-6)
    # quaternion round-trip: rotation to ~1e-6, translation exact-ish
    np.testing.assert_allclose(back, poses, atol=1e-5)


def test_ply_roundtrip(tmp_path):
    from pgslam_tpu.cloud import make_cloud
    from pgslam_tpu.io import load_cloud_ply, save_cloud_ply

    rng = np.random.default_rng(5)
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    nrm = rng.normal(size=(100, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    mask = np.ones(128, bool)
    mask[100:] = False
    cloud = make_cloud(pts, capacity=128, descriptors={"normals": nrm})
    for binary in (True, False):
        path = str(tmp_path / f"c_{binary}.ply")
        save_cloud_ply(path, cloud, binary=binary)
        back = load_cloud_ply(path)
        assert int(back.count()) == 100
        np.testing.assert_allclose(np.asarray(back.points)[:100], pts,
                                   atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(back.descriptors["normals"])[:100], nrm, atol=1e-5)


def test_global_map_assembly():
    from pgslam_tpu import PoseGraphSlam, SlamConfig
    from pgslam_tpu.datasets import corridor_sequence

    rng = np.random.default_rng(6)
    scans, odom, _gt = corridor_sequence(rng, n_scans=8, scan_points=512)
    slam = PoseGraphSlam(SlamConfig())
    for t, (scan, T) in enumerate(zip(scans, odom)):
        slam.add_data(t, "world", T, np.eye(4), scan)
    gm = slam.global_map()
    n_kf = slam.get_graph().n_vertices
    assert gm.shape[1] == 3 and len(gm) >= 512 * n_kf
    assert np.isfinite(gm).all()
    capped = slam.global_map(max_points_per_keyframe=100)
    assert len(capped) < len(gm)
