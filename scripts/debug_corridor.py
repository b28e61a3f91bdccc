"""Per-scan tracking trace of the corridor sequence (runs on whatever
device JAX finds; JAX_PLATFORMS=cpu for the CPU).

    python scripts/debug_corridor.py
"""
import logging
import os
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "tests"))
logging.basicConfig(level=logging.INFO)

from pgslam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from pgslam_tpu.datasets import corridor_sequence
from pgslam_tpu.slam import PoseGraphSlam
from test_slam_e2e import small_config

rng = np.random.default_rng(7)
scans, odom, truth = corridor_sequence(
    rng, n_scans=25, scan_points=512, step=0.4, noise=0.003,
    odom_noise=0.005, length=30.0)
slam = PoseGraphSlam(small_config())
T_rs = np.eye(4, dtype=np.float32)
for i, (scan, T_odom) in enumerate(zip(scans, odom)):
    slam.add_data(i, "world", T_odom, T_rs, scan)
    est = slam.localizer.T_world_robot[:3, 3]
    tru = truth[i][:3, 3]
    od = odom[i][:3, 3]
    r = slam.localizer.last_result
    print(f"scan {i}: est={est.round(3)} true={tru.round(3)} "
          f"odo={od.round(3)} err={np.linalg.norm(est-tru):.3f} "
          f"overlap={float(r.overlap) if r else -1:.3f} "
          f"iters={int(r.iterations) if r else -1} "
          f"kfs={slam.get_graph().n_vertices}")
