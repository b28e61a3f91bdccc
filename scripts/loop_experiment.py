"""Loop-closure experiment: full SLAM on the ring sequence.

Usage: python scripts/loop_experiment.py [n_scans] [scan_points]
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from pgslam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import logging
logging.basicConfig(level=logging.INFO, format="%(message)s")

import numpy as np

from pgslam_tpu.datasets import loop_sequence
from pgslam_tpu.slam import PoseGraphSlam, SlamConfig
from pgslam_tpu.localizer import LocalizerConfig
from pgslam_tpu.loopcloser import LoopCloserConfig
from pgslam_tpu.graph.pose_graph import LOOP_CONSTRAINT
from pgslam_tpu.ops import outlier as O
from pgslam_tpu.ops.icp import ICPConfig


def loop_config(sensor_cap=1024, kf_cap=1024):
    icp = ICPConfig(error="point_to_point", max_iterations=30,
                    outlier=(O.TrimmedDist(0.85), O.MaxDist(0.5)),
                    trans_eps=5e-3, rot_eps=5e-3,
                    max_correction_trans=2.0, max_correction_rot=0.5)
    return SlamConfig(
        localizer=LocalizerConfig(icp=icp, keyframe_cloud_capacity=kf_cap,
                                  overlap_threshold=0.8),
        loop_closer=LoopCloserConfig(icp=icp, topo_dist_threshold=10.0,
                                     geom_dist_threshold=4.0,
                                     overlap_threshold=0.6,
                                     residual_error_threshold=5000.0),
        sensor_cloud_capacity=sensor_cap)


def main():
    n_scans = int(sys.argv[1]) if len(sys.argv) > 1 else 140
    scan_points = int(sys.argv[2]) if len(sys.argv) > 2 else 1024
    noise = float(sys.argv[3]) if len(sys.argv) > 3 else 0.002
    odom_drift = float(sys.argv[4]) if len(sys.argv) > 4 else 0.002
    rng = np.random.default_rng(3)
    scans, odom, truth = loop_sequence(rng, n_scans=n_scans,
                                       scan_points=scan_points,
                                       radius=12.0, max_range=8.0,
                                       noise=noise, odom_drift=odom_drift)
    slam = PoseGraphSlam(loop_config())
    T_rs = np.eye(4, dtype=np.float32)
    for i, (scan, T_odom) in enumerate(zip(scans, odom)):
        slam.add_data(i, "world", T_odom, T_rs, scan)
        est = slam.localizer.T_world_robot
        print(f"scan {i}: err={np.linalg.norm(est[:3,3]-truth[i][:3,3]):7.3f}"
              f" z={est[2,3]:5.2f} kfs={slam.get_graph().n_vertices}",
              flush=True)
    g = slam.get_graph()
    n_loops = int(np.sum(g.edge_type[:g.n_edges] == LOOP_CONSTRAINT))
    err = np.linalg.norm(slam.localizer.T_world_robot[:3, 3]
                         - truth[-1][:3, 3])
    drift = np.linalg.norm(odom[-1][:3, 3] - truth[-1][:3, 3])
    print(f"LOOPS={n_loops} kfs={g.n_vertices} err={err:.3f} "
          f"drift={drift:.3f}")
    from pgslam_tpu.io import save_checkpoint
    save_checkpoint(os.path.join(tempfile.gettempdir(),
                                 "loop_exp_ckpt.npz"), slam.map_manager,
                    slam.localizer)


if __name__ == "__main__":
    main()
