"""Drive the framework end-to-end through its public API surface.

This is the verify recipe: a user-style session — build a SLAM instance,
feed it a synthetic scan sequence, read back trajectory / local map /
graphviz — plus a few hostile probes.
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

# --- public API only ---
import pgslam_tpu
from pgslam_tpu.utils.compile_cache import enable_compile_cache
from pgslam_tpu import PoseGraphSlam, SlamConfig
from pgslam_tpu.localizer import LocalizerConfig
from pgslam_tpu.loopcloser import LoopCloserConfig
from pgslam_tpu.ops.icp import ICPConfig
from pgslam_tpu.ops import outlier as O
from pgslam_tpu.datasets import corridor_sequence

enable_compile_cache()
_TMP = tempfile.mkdtemp(prefix="verify_drive_")
print(f"pgslam_tpu {pgslam_tpu.__version__}")

icp = ICPConfig(error="point_to_point", max_iterations=30,
                outlier=(O.TrimmedDist(0.9), O.MaxDist(0.5)),
                trans_eps=1e-3, rot_eps=1e-3)
cfg = SlamConfig(
    localizer=LocalizerConfig(icp=icp, keyframe_cloud_capacity=512),
    loop_closer=LoopCloserConfig(icp=icp),
    sensor_cloud_capacity=768)

rng = np.random.default_rng(11)
scans, odom, truth = corridor_sequence(rng, n_scans=12, scan_points=512,
                                       step=0.4, noise=0.003,
                                       odom_noise=0.005, length=30.0)

slam = PoseGraphSlam(cfg)
for i, (scan, T_odom) in enumerate(zip(scans, odom)):
    slam.add_data(i, "world", T_odom, np.eye(4), scan)

err = np.linalg.norm(slam.T_world_robot[:3, 3] - truth[-1][:3, 3])
g = slam.get_graph()
print(f"final pose err = {err:.3f} m over "
      f"{np.linalg.norm(truth[-1][:3,3]-truth[0][:3,3]):.1f} m travel; "
      f"keyframes={g.n_vertices} edges={g.n_edges}")
assert err < 0.25, "tracking failed"

cloud, ok = slam.get_local_map()
print(f"local map: ok={ok} points={int(cloud.count())}/{cloud.capacity}")
slam.write_graphviz(os.path.join(_TMP, "verify_graph.dot"))
print("graphviz head:", open(os.path.join(_TMP, "verify_graph.dot")).read().splitlines()[:3])

traj = slam.trajectory()
print(f"trajectory shape {traj.shape}; kf0 at {traj[0][:3,3]}, "
      f"last kf at {traj[-1][:3,3]}")

print("PROBE deferred (sync_lag=2) facade:", end=" ")
import dataclasses
dcfg = dataclasses.replace(
    cfg, localizer=dataclasses.replace(cfg.localizer, sync_lag=2))
dslam = PoseGraphSlam(dcfg)
for i, (scan, T_odom) in enumerate(zip(scans, odom)):
    dslam.add_data(i, "world", T_odom, np.eye(4), scan)
derr = np.linalg.norm(dslam.T_world_robot[:3, 3] - truth[-1][:3, 3])
print(f"deferred err={derr:.3f} m (accessor auto-flush), "
      f"kfs={dslam.get_graph().n_vertices}")
assert derr < 0.25, "deferred tracking failed"

# --- probes ---
print("PROBE bad cloud shape:", end=" ")
try:
    slam.add_data(99, "world", np.eye(4), np.eye(4), np.zeros((10, 2)))
    print("NO ERROR (bad)")
except ValueError as e:
    print(f"ValueError: {e}")

print("PROBE oversize cloud:", end=" ")
try:
    slam.add_data(99, "world", np.eye(4), np.eye(4),
                  np.zeros((100000, 3), np.float32))
    print("NO ERROR (bad)")
except ValueError as e:
    print(f"ValueError: {e}")

print("PROBE MT facade:", end=" ")
from pgslam_tpu import PoseGraphSlamMT
mt = PoseGraphSlamMT(cfg)
with mt:
    for i, (scan, T_odom) in enumerate(zip(scans[:6], odom[:6])):
        mt.add_data(i, "world", T_odom, np.eye(4), scan)
    assert mt.wait_idle(timeout=300)
    mt_err = np.linalg.norm(
        mt.localizer.T_world_robot[:3, 3] - truth[5][:3, 3])
print(f"MT err after 6 scans = {mt_err:.3f} m, "
      f"kfs={mt.get_graph().n_vertices}")
assert mt_err < 0.25

print("PROBE stop() twice:", end=" ")
mt.stop()
print("ok")

# --- grid matcher end-to-end (the 64k-scale fast path, small shapes) ---
print("PROBE grid-matcher ICP:", end=" ")
import jax.numpy as jnp
from pgslam_tpu import se3
from pgslam_tpu.cloud import make_cloud
from pgslam_tpu.ops.icp import icp

grng = np.random.default_rng(5)
gpts = grng.uniform(0, 8, size=(600, 3)).astype(np.float32)
gref = make_cloud(gpts, capacity=640)
g_true = se3.exp(jnp.asarray([0.2, -0.1, 0.05, 0.02, 0.0, 0.03], jnp.float32))
gread = make_cloud(
    np.asarray(se3.apply(se3.inverse(g_true), jnp.asarray(gpts))),
    capacity=640)
gcfg = ICPConfig(matcher="grid", grid_cell_size=1.0, grid_bucket_cap=16,
                 max_iterations=40,
                 outlier=(O.TrimmedDist(0.95), O.MaxDist(1.0)))
gres = icp(gread, gref, se3.identity(), gcfg)
gerr = float(np.linalg.norm(np.asarray(se3.log(se3.inverse(gres.T) @ g_true))))
print(f"recovered err={gerr:.2e}")
assert gerr < 5e-3

# --- YAML config surface ---
print("PROBE YAML config:", end=" ")
import tempfile
from pgslam_tpu.config import load_icp_config
with tempfile.NamedTemporaryFile("w", suffix=".yaml", delete=False) as fh:
    fh.write("errorMinimizer: PointToPlaneErrorMinimizer\n"
             "outlierFilters:\n"
             "  - TrimmedDistOutlierFilter: {ratio: 0.8}\n")
    yaml_path = fh.name
ycfg = load_icp_config(yaml_path)
assert ycfg.error == "point_to_plane"
print("ok")

# --- checkpoint round-trip through the facade state ---
print("PROBE checkpoint:", end=" ")
from pgslam_tpu.io import load_checkpoint, save_checkpoint
save_checkpoint(os.path.join(_TMP, "verify_ckpt.npz"), slam.map_manager, slam.localizer)
slam2 = PoseGraphSlam(cfg)
load_checkpoint(os.path.join(_TMP, "verify_ckpt.npz"), slam2.map_manager, slam2.localizer)
assert slam2.get_graph().n_vertices == slam.get_graph().n_vertices
np.testing.assert_allclose(slam2.localizer.T_world_robot,
                           slam.localizer.T_world_robot)
print(f"restored {slam2.get_graph().n_vertices} keyframes ok")

# --- multichip dryrun (8 virtual devices) ---
print("PROBE dryrun_multichip(8):", end=" ")
import __graft_entry__ as ge
ge.dryrun_multichip(8)

print("ALL VERIFY CHECKS PASSED")
