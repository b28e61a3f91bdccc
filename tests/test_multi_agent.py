"""Multi-agent SLAM: N agents, one shared pose graph, fused ICP dispatch."""

import numpy as np
import pytest

from pgslam_tpu.datasets import corridor_sequence
from pgslam_tpu.parallel.multi_agent import MultiAgentSlam

from test_slam_e2e import small_config


def test_two_agents_share_graph():
    rng = np.random.default_rng(7)
    scans, odom, truth = corridor_sequence(
        rng, n_scans=12, scan_points=512, step=0.4, noise=0.003,
        odom_noise=0.005, length=30.0)
    # Agent 1 runs the corridor; agent 2 runs it shifted +1 scan.
    B = 2
    slam = MultiAgentSlam(small_config(), n_agents=B)
    T_rs = np.eye(4, dtype=np.float32)
    for i in range(10):
        Ts = np.stack([odom[i], odom[i + 1]])
        clouds = [scans[i], scans[i + 1]]
        slam.add_data_batch(i, "world", Ts, T_rs, clouds)

    poses = slam.poses()
    assert poses.shape == (B, 4, 4)
    err0 = np.linalg.norm(poses[0][:3, 3] - truth[9][:3, 3])
    err1 = np.linalg.norm(poses[1][:3, 3] - truth[10][:3, 3])
    assert err0 < 0.25, f"agent 0 err {err0}"
    assert err1 < 0.25, f"agent 1 err {err1}"

    g = slam.get_graph()
    # Both agents contributed keyframes to the shared graph.
    assert g.n_vertices >= 3
    assert slam.map_manager.get_fixed_vertex() == 0
    # Trajectory export covers all keyframes.
    assert slam.trajectory().shape == (g.n_vertices, 4, 4)


def test_prewarm_then_run_matches_cold():
    """Bring-up trace pre-warm must be a pure
    warm-up: identical trajectories to a cold fleet, and no leakage of
    its throwaway graphs into the real one."""
    rng = np.random.default_rng(7)
    scans, odom, truth = corridor_sequence(
        rng, n_scans=10, scan_points=512, step=0.4, noise=0.003,
        odom_noise=0.005, length=30.0)
    T_rs = np.eye(4, dtype=np.float32)

    def run(prewarm):
        slam = MultiAgentSlam(small_config(), n_agents=2)
        if prewarm:
            slam.prewarm()
        for i in range(9):
            Ts = np.stack([odom[i], odom[i + 1]])
            slam.add_data_batch(i, "world", Ts, T_rs,
                                [scans[i], scans[i + 1]])
        return slam.poses(), slam.get_graph().n_vertices

    cold_poses, cold_nv = run(False)
    warm_poses, warm_nv = run(True)
    np.testing.assert_array_equal(cold_poses, warm_poses)
    assert cold_nv == warm_nv


def test_agents_with_first_scans_only():
    rng = np.random.default_rng(1)
    scans, odom, _ = corridor_sequence(rng, n_scans=3, scan_points=512,
                                       length=30.0)
    slam = MultiAgentSlam(small_config(), n_agents=3)
    Ts = np.stack([odom[0]] * 3)
    slam.add_data_batch(0, "world", Ts, np.eye(4), [scans[0]] * 3)
    # Every agent bootstrapped its own first keyframe; one shared anchor.
    assert slam.get_graph().n_vertices == 3
    assert slam.map_manager.get_fixed_vertex() == 0


@pytest.mark.slow
def test_multi_agent_on_tp_mesh():
    """Fleet SLAM on the (dp, tp) mesh: the FULL registration runs through
    parallel/sharded_icp.py (dp over agents, tp over reference points)
    with identical front-end semantics (the tp ring serves real SLAM,
    not a synthetic step)."""
    from pgslam_tpu.parallel.multichip import make_mesh

    rng = np.random.default_rng(7)
    scans, odom, truth = corridor_sequence(
        rng, n_scans=12, scan_points=512, step=0.4, noise=0.003,
        odom_noise=0.005, length=30.0)
    B = 4
    mesh = make_mesh(8, tp=2)  # dp=4 agents x tp=2 point shards
    slam = MultiAgentSlam(small_config(), n_agents=B, mesh=mesh)
    slam_ref = MultiAgentSlam(small_config(), n_agents=B)  # single-device
    T_rs = np.eye(4, dtype=np.float32)
    for i in range(8):
        Ts = np.stack([odom[i + b] for b in range(B)])
        clouds = [scans[i + b] for b in range(B)]
        slam.add_data_batch(i, "world", Ts, T_rs, clouds)
        slam_ref.add_data_batch(i, "world", Ts, T_rs, clouds)

    poses = slam.poses()
    ref_poses = slam_ref.poses()
    for b in range(B):
        err = np.linalg.norm(poses[b][:3, 3] - truth[7 + b][:3, 3])
        assert err < 0.25, f"agent {b} err {err}"
        # mesh path tracks the single-device fleet closely
        dev = np.linalg.norm(poses[b][:3, 3] - ref_poses[b][:3, 3])
        assert dev < 0.05, f"agent {b} mesh-vs-plain deviation {dev}"
    g = slam.get_graph()
    assert g.n_vertices == slam_ref.get_graph().n_vertices


@pytest.mark.slow
def test_batched_reciprocal_loop_closures_dont_crash():
    """Two vertices in one verification batch can each pick the other as
    candidate (searches run before either insert); the second, reverse
    closure must be dropped, not raise a duplicate-edge error."""
    rng = np.random.default_rng(7)
    scans, odom, truth = corridor_sequence(
        rng, n_scans=32, scan_points=512, step=0.25, noise=0.003,
        odom_noise=0.005, length=60.0)
    B = 16
    slam = MultiAgentSlam(small_config(), n_agents=B)
    T_rs = np.eye(4, dtype=np.float32)
    for i in range(28):
        Ts = np.stack([odom[i + b % 3] for b in range(B)])
        clouds = [scans[i + b % 3] for b in range(B)]
        slam.add_data_batch(i, "world", Ts, T_rs, clouds)
    g = slam.get_graph()
    # No duplicate (u, v)/(v, u) pairs survived.
    pairs = set()
    for e in range(g.n_edges):
        key = (min(g.edge_from[e], g.edge_to[e]),
               max(g.edge_from[e], g.edge_to[e]))
        assert key not in pairs, f"duplicate edge {key}"
        pairs.add(key)
    from pgslam_tpu.utils import counters
    assert counters["loopcloser/rejected_duplicate"] >= 1
