"""Real-world-shaped validation: KITTI .bin format round-trip + ICP on a
harsh raycast scan pair (occlusion, density falloff, dynamic objects) —
capability parity with the reference's battle-tested libpointmatcher path."""

import numpy as np
import jax.numpy as jnp
import pytest

from pgslam_tpu import se3
from pgslam_tpu.cloud import make_cloud
from pgslam_tpu.datasets import (harsh_velodyne_pair, load_kitti_bin,
                                 save_kitti_bin)
from pgslam_tpu.ops import filters as F
from pgslam_tpu.ops import outlier as O
from pgslam_tpu.ops.icp import ICPConfig, ICPEngine


def test_kitti_bin_roundtrip(tmp_path, rng):
    pts = rng.uniform(-50, 50, (1000, 3)).astype(np.float32)
    refl = rng.uniform(0, 1, 1000).astype(np.float32)
    p = tmp_path / "000000.bin"
    save_kitti_bin(str(p), pts, refl)
    back = load_kitti_bin(str(p))
    np.testing.assert_array_equal(back, pts)
    assert load_kitti_bin(str(p), max_points=100).shape == (100, 3)


def test_icp_on_harsh_scan_pair(tmp_path):
    rng = np.random.default_rng(3)
    scan_a, scan_b, T_a_b = harsh_velodyne_pair(rng, n_points=16384)
    # Through the KITTI container format, as a real pipeline would.
    pa, pb = tmp_path / "a.bin", tmp_path / "b.bin"
    save_kitti_bin(str(pa), scan_a)
    save_kitti_bin(str(pb), scan_b)
    a = load_kitti_bin(str(pa))
    b = load_kitti_bin(str(pb))
    assert len(a) > 4000 and len(b) > 4000  # dropout left enough returns

    cap = 16384
    cfg = ICPConfig(
        error="point_to_plane",
        reading_filters=(F.VoxelGrid(voxel_size=0.6, hash_size=1 << 15),
                         F.Compact(2048)),
        reference_filters=(F.VoxelGrid(voxel_size=0.3, hash_size=1 << 16),
                           F.Compact(8192),
                           F.SurfaceNormal(knn=8, tile_query=2048)),
        # Trimmed harder than the clean-data configs: dynamic objects and
        # occlusion-fringe points must fall out of the minimization.
        outlier=(O.TrimmedDist(0.75), O.MaxDist(1.0)),
        max_iterations=30, trans_eps=1e-4, rot_eps=1e-4)
    engine = ICPEngine(cfg)
    engine.set_map(make_cloud(a, capacity=cap))
    res = engine(make_cloud(b, capacity=cap), jnp.asarray(np.eye(4,
                                                          dtype=np.float32)))
    # res.T maps scan-b into scan-a == T_a_b.
    err = np.asarray(se3.log(se3.inverse(res.T) @ jnp.asarray(T_a_b)))
    terr = np.linalg.norm(err[:3])
    rerr = np.linalg.norm(err[3:])
    assert bool(res.converged), "ICP did not converge on the harsh pair"
    assert terr < 0.05, f"translation error {terr:.3f} m"
    assert rerr < 0.01, f"rotation error {rerr:.4f} rad"
    assert float(res.overlap) > 0.5


def test_full_slam_over_native_loader():
    """FULL SLAM loop (facade, keyframes, local maps — not just ICP
    recovery) over the committed real-structured ``.bin`` fixtures,
    streamed through the native C++ async loader."""
    import os

    from pgslam_tpu.localizer import LocalizerConfig
    from pgslam_tpu.loopcloser import LoopCloserConfig
    from pgslam_tpu.slam import PoseGraphSlam, SlamConfig

    fdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "scans")
    try:
        from pgslam_tpu.native import ScanLoader
        loader = ScanLoader(fdir, with_reflectance=True)
    except ImportError:
        pytest.skip("native scan loader unavailable (no C++ toolchain)")
    poses = np.load(os.path.join(fdir, "poses.npz"))
    truth, odom = poses["truth"], poses["odom"]

    cap = 16384
    icp = ICPConfig(
        error="point_to_plane",
        reading_filters=(F.VoxelGrid(voxel_size=0.5, hash_size=1 << 15),
                         F.Compact(2048)),
        reference_filters=(F.VoxelGrid(voxel_size=0.25, hash_size=1 << 16),
                           F.Compact(8192),
                           F.SurfaceNormal(knn=8, tile_query=2048)),
        outlier=(O.TrimmedDist(0.85), O.MaxDist(1.0)),
        max_iterations=20, trans_eps=1e-3, rot_eps=1e-3,
        max_correction_trans=3.0, max_correction_rot=0.5)
    slam = PoseGraphSlam(SlamConfig(
        localizer=LocalizerConfig(icp=icp, keyframe_cloud_capacity=cap,
                                  overlap_threshold=0.9),
        loop_closer=LoopCloserConfig(icp=icp, topo_dist_threshold=30.0,
                                     geom_dist_threshold=10.0,
                                     overlap_threshold=0.6),
        sensor_cloud_capacity=cap))
    n = 0
    with loader:
        for i, (pts, refl) in enumerate(loader):
            assert pts.shape[1] == 3 and len(refl) == len(pts)
            slam.add_data(i, "world", odom[i], np.eye(4, dtype=np.float32),
                          pts)
            n += 1
    assert n == len(truth) >= 5
    err = np.linalg.norm(
        slam.localizer.T_world_robot[:3, 3] - truth[-1][:3, 3])
    assert err < 0.15, f"final pose error {err:.3f} m"
    assert slam.get_graph().n_vertices >= 2
