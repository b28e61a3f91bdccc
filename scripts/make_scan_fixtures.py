"""Generate the committed real-structured scan fixtures: a short KITTI
``.bin`` sequence (raycast-rendered Velodyne-style scans with occlusion
and noise, written through ``datasets.save_kitti_bin``) plus its odometry,
consumed by ``tests/test_real_scan.py::test_full_slam_over_native_loader``
and by ``scripts/bench_configs.py`` config 4 through the native loader.

Environment note (PARITY.md): this container has zero egress, so no real
KITTI logs can be downloaded; these fixtures are raycast exports with
real-scan structure (ring pattern, range falloff, occlusion, per-point
noise) in the exact on-disk format (x,y,z,reflectance float32) a real
pipeline would read.

    python scripts/make_scan_fixtures.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

from pgslam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402

from pgslam_tpu.datasets import (corridor_world, render_scan,  # noqa: E402
                                 save_kitti_bin)

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "tests", "fixtures", "scans")
N_SCANS = 6
POINTS = 16384


def main():
    rng = np.random.default_rng(11)
    world = corridor_world(rng, n_points=120000, length=40.0, width=8.0,
                           height=5.0)
    os.makedirs(OUT, exist_ok=True)
    poses = []
    for i in range(N_SCANS):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [2.0 + i * 2.0, 0.0, 1.8]
        poses.append(T)
        scan = render_scan(world, T, rng, POINTS, max_range=25.0,
                           noise=0.01)
        refl = rng.uniform(0.0, 1.0, len(scan)).astype(np.float32)
        save_kitti_bin(os.path.join(OUT, f"{i:06d}.bin"), scan, refl)
    # odometry = ground truth + mild drift (the SLAM loop must correct it)
    odom = [poses[0].copy()]
    for i in range(1, N_SCANS):
        dT = np.linalg.inv(poses[i - 1]) @ poses[i]
        drift = np.eye(4, dtype=np.float32)
        drift[:3, 3] = rng.normal(0, 0.01, 3)
        odom.append((odom[-1] @ dT @ drift).astype(np.float32))
    np.savez(os.path.join(OUT, "poses.npz"), truth=np.stack(poses),
             odom=np.stack(odom))
    sz = sum(os.path.getsize(os.path.join(OUT, f)) for f in os.listdir(OUT))
    print(f"wrote {N_SCANS} x {POINTS}-pt .bin scans + poses.npz to {OUT} "
          f"({sz / 1e6:.2f} MB)")


if __name__ == "__main__":
    main()
