"""BASELINE config 4 demo: Velodyne-scale full SLAM loop.

Feeds 64k-point synthetic spins (or real KITTI .bin files if a directory
is given) through the full pipeline with the production voxel-working-set
ICP profile; on a GPU the exact-kNN matcher runs as the Pallas kernel.

    python examples/velodyne_slam.py [kitti_velodyne_dir] [n_scans]
"""
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from pgslam_tpu.datasets import load_kitti_bin, velodyne_like_scan
from pgslam_tpu.localizer import LocalizerConfig
from pgslam_tpu.loopcloser import LoopCloserConfig
from pgslam_tpu.ops import filters as F
from pgslam_tpu.ops import outlier as O
from pgslam_tpu.ops.icp import ICPConfig
from pgslam_tpu.slam import PoseGraphSlam, SlamConfig
from pgslam_tpu.utils import StageTimer
from pgslam_tpu.utils.compile_cache import enable_compile_cache


def velodyne_config(sync_lag: int = 0) -> SlamConfig:
    # Single-stream profile: coarse-to-fine registration of a 2k-point
    # voxel working set against an 8k-point voxelized local map, five
    # fine iterations.
    icp = ICPConfig(
        error="point_to_plane", matcher="pallas",
        reading_filters=(F.VoxelGrid(voxel_size=0.4, hash_size=1 << 17),
                         F.Compact(2048)),
        reference_filters=(F.VoxelGrid(voxel_size=0.2, hash_size=1 << 18),
                           F.Compact(8192),
                           F.SurfaceNormal(knn=8, tile_query=4096)),
        outlier=(O.TrimmedDist(0.9), O.MaxDist(1.0)),
        coarse_div=8, coarse_iterations=8,
        max_iterations=5, trans_eps=1e-4, rot_eps=1e-4,
        max_correction_trans=3.0, max_correction_rot=0.5)
    # sync_lag > 0 commits scan results that many scans late (MT-style
    # staleness, LocalizerConfig.sync_lag docstring) so the packed-result
    # d2h overlaps the next scans' transfers.
    # The LoopCloser gets a VERIFICATION-grade variant of the same
    # pipeline: mi=5 is a fixed-budget throughput profile whose eps
    # checker has one iteration of room, so check_icp_result
    # (LoopCloser.hpp:317 semantics) would reject ~every closure as
    # max_iter_reached (the dead-zone guard flags exactly this).
    # Verification runs once per keyframe, not per scan — iteration
    # budget is cheap there.
    verify_icp = dataclasses.replace(icp, max_iterations=24)
    # deferred_verification moves the spawn-time verification's packed
    # d2h behind the NEXT scan's window (same staleness class as
    # sync_lag; it is only enabled alongside it).
    return SlamConfig(
        localizer=LocalizerConfig(icp=icp, keyframe_cloud_capacity=65536,
                                  overlap_threshold=0.8,
                                  sync_lag=sync_lag),
        loop_closer=LoopCloserConfig(icp=verify_icp,
                                     topo_dist_threshold=30.0,
                                     geom_dist_threshold=10.0,
                                     overlap_threshold=0.6,
                                     deferred_verification=sync_lag > 0),
        sensor_cloud_capacity=65536)


def main():
    enable_compile_cache()
    src = sys.argv[1] if len(sys.argv) > 1 else None
    n_scans = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    rng = np.random.default_rng(0)

    if src and os.path.isdir(src):
        # Native async loader (C++ IO worker) when available; the numpy
        # reader otherwise.
        try:
            from pgslam_tpu.native import ScanLoader
            import itertools
            scans = list(itertools.islice(ScanLoader(src), n_scans))
            scans = [s[:65536] for s in scans]
            print(f"streamed {len(scans)} KITTI scans from {src} "
                  f"(native loader)")
        except ImportError:
            files = sorted(os.listdir(src))[:n_scans]
            scans = [load_kitti_bin(os.path.join(src, f), max_points=65536)
                     for f in files]
            print(f"loaded {len(scans)} KITTI scans from {src}")
    else:
        scans = [velodyne_like_scan(rng, 65536) for _ in range(n_scans)]
        print(f"generated {len(scans)} synthetic 64k-pt spins")

    slam = PoseGraphSlam(velodyne_config())
    timer = StageTimer()
    T = np.eye(4, dtype=np.float32)
    for i, scan in enumerate(scans):
        T = T.copy()
        T[0, 3] += 1.0   # crude forward odometry prior
        with timer.stage("add_data"):
            slam.add_data(i, "world", T, np.eye(4), scan)
        est = slam.localizer.T_world_robot
        print(f"scan {i}: pose=({est[0,3]:.2f},{est[1,3]:.2f},{est[2,3]:.2f})"
              f" keyframes={slam.get_graph().n_vertices}")
    print("timing:", timer.summary())
    slam.write_graphviz("velodyne_graph.dot")


if __name__ == "__main__":
    main()
