"""Golden-replay parity: every execution path must
reproduce the committed single-threaded-facade trajectory.

The fixture (tests/fixtures/golden_replay.npz, written by
scripts/make_golden_replay.py on the CPU backend) pins the ST facade's
per-scan poses over one loop sequence with an accepted loop closure.
This file asserts:

* ST facade  -> bit-tight against the fixture (deterministic replay);
* MT facade  -> same trajectory within tolerance (threaded pipeline);
* batched fleet (MultiAgentSlam, shared graph) -> each agent tracks the
  golden trajectory within tolerance;
* sharded fleet (dp x tp mesh through parallel/sharded_icp.py) -> same.

Reference tie-in: the north star asks for "same trajectories within pose
tolerance on replayed scan sequences" vs the C++ reference; the reference
is not buildable here, so cross-path agreement against one recorded
replay is the strongest available substitute (PARITY.md).
"""

import numpy as np
import pytest

from golden_replay import (FIXTURE, FIXTURE_64K, FIXTURE_LONG, N_SCANS,
                           _replay, golden_config, golden_sequence,
                           long_sequence, run_st_replay,
                           run_st_replay_64k, run_st_replay_long)


@pytest.fixture(scope="module")
def golden():
    data = np.load(FIXTURE)
    return {"per_scan": data["per_scan_poses"],
            "trajectory": data["trajectory"],
            "n_loops": int(data["n_loop_edges"])}


def _pose_errs(poses, golden_poses, window: int = 0):
    """Per-scan translation deviation. ``window=1`` compares against the
    nearest golden pose within +-1 scan: deferred-resync paths (the
    fleet, mirroring the reference's MT outdated-flag) apply the
    loop-closure writeback one scan later than ST, a bounded transient
    that is a timing difference, not a trajectory difference."""
    d = np.linalg.norm(poses[:, None, :3, 3]
                       - golden_poses[None, :, :3, 3], axis=-1)
    n = len(poses)
    ix = np.arange(n)
    errs = d[ix, ix]
    for w in range(1, window + 1):
        errs[w:] = np.minimum(errs[w:], d[ix[w:], ix[:-w]])
        errs[:-w] = np.minimum(errs[:-w], d[ix[:-w], ix[w:]])
    return errs


def test_st_facade_matches_golden(golden):
    per_scan, trajectory, n_loops = run_st_replay()
    # Same backend + same jitted code path: deterministic replay.
    np.testing.assert_allclose(per_scan, golden["per_scan"], atol=1e-5)
    assert trajectory.shape == golden["trajectory"].shape
    np.testing.assert_allclose(trajectory, golden["trajectory"], atol=1e-5)
    assert n_loops == golden["n_loops"] >= 1


@pytest.mark.slow
def test_mt_batched_sharded_match_golden(golden):
    """The three parallel paths replay the same sequence and must land on
    the golden trajectory within tolerance (not bitwise: the MT pipeline
    overlaps optimization with localization, and fleet paths share one
    graph across agents / use the sharded matcher's iteration schedule)."""
    from pgslam_tpu.parallel.multi_agent import MultiAgentSlam
    from pgslam_tpu.parallel.multichip import make_mesh
    from pgslam_tpu.pipeline import PoseGraphSlamMT

    scans, odom, _ = golden_sequence()
    T_rs = np.eye(4, dtype=np.float32)
    tol = 0.10  # m; drift at the pre-closure end of the fixture is ~3x this

    # --- MT facade ---
    slam = PoseGraphSlamMT(golden_config())
    with slam:
        for i, (scan, T_odom) in enumerate(zip(scans, odom)):
            slam.add_data(i, "world", T_odom, T_rs, scan)
        assert slam.wait_idle(timeout=600.0)
        mt_final = slam.localizer.T_world_robot.copy()
    err_mt = np.linalg.norm(mt_final[:3, 3]
                            - golden["per_scan"][-1][:3, 3])
    assert err_mt < tol, f"MT final-pose deviation {err_mt}"

    # --- batched path (B=1 through MultiAgentSlam). Loop-closure
    # verification is forced synchronous here so the execution-path
    # comparison is apples-to-apples with ST: the fleet's default queued
    # verification lands closures LATER (exactly like the reference's
    # LoopCloserMT), which shifts when the correction hits the live
    # pose — a semantics difference, not a numerics one. ---
    def run_fleet(n_agents, mesh=None, sync_closures=False):
        fleet = MultiAgentSlam(golden_config(), n_agents=n_agents,
                               mesh=mesh)
        if sync_closures:
            fleet.loop_closer.queue_mode = False
            for loc in fleet.localizers:
                # ST semantics: apply optimization writebacks immediately
                # instead of at the next batch step (the deferred flag is
                # the reference's LocalizerMT outdated-flag analog).
                loc.defer_graph_resync = False
        per_scan = []
        for i in range(N_SCANS):
            Ts = np.stack([odom[i]] * n_agents)
            fleet.add_data_batch(i, "world", Ts, T_rs,
                                 [scans[i]] * n_agents)
            per_scan.append(fleet.poses().copy())
        return np.stack(per_scan)                       # [n, B, 4, 4]

    batched = run_fleet(1, sync_closures=True)
    errs = _pose_errs(batched[:, 0], golden["per_scan"], window=1)
    assert errs.max() < tol, f"batched path max dev {errs.max()}"

    # --- sharded path (B=1 on a dp=1 x tp=8 mesh: the FULL sharded
    # registration of parallel/sharded_icp.py over the point axis) ---
    sharded = run_fleet(1, mesh=make_mesh(8, tp=8), sync_closures=True)
    errs = _pose_errs(sharded[:, 0], golden["per_scan"], window=1)
    assert errs.max() < tol, f"sharded path max dev {errs.max()}"

    # --- 2-agent shared-graph fleet with the production queued
    # closures: duplicate keyframes change local-map compositions and
    # closures land asynchronously (by design), so the pin is the
    # closure-corrected FINAL pose.
    fleet2 = run_fleet(2)
    for b in range(2):
        err = np.linalg.norm(fleet2[-1, b][:3, 3]
                             - golden["per_scan"][-1][:3, 3])
        assert err < tol, f"fleet agent {b} final-pose dev {err}"


@pytest.mark.slow
def test_mt_per_scan_matches_golden(golden):
    """MT facade pinned PER SCAN (not just the final pose). The pipeline is driven lockstep (wait_idle after
    every scan) so worker scheduling cannot reorder work; the ±1-scan
    window stays because the MT localizer applies optimization
    writebacks via the deferred outdated-flag (LocalizerMT.hpp:122-134)
    — one scan later than ST around each closure, by design."""
    from pgslam_tpu.pipeline import PoseGraphSlamMT

    scans, odom, _ = golden_sequence()
    T_rs = np.eye(4, dtype=np.float32)
    per_scan = []
    slam = PoseGraphSlamMT(golden_config())
    with slam:
        for i, (scan, T_odom) in enumerate(zip(scans, odom)):
            slam.add_data(i, "world", T_odom, T_rs, scan)
            assert slam.wait_idle(timeout=120.0)
            per_scan.append(slam.localizer.T_world_robot.copy())
    errs = _pose_errs(np.stack(per_scan), golden["per_scan"], window=1)
    assert errs.max() < 0.10, f"MT per-scan max dev {errs.max()}"


def _truth_errs(per_scan, truth, lag=0):
    """Per-scan translation error vs ground truth. ``lag``: in deferred
    mode the pose REPORTED after add_data(i) is the committed pose of
    scan i-lag (sync_lag semantics) — compare against the lag-shifted
    truth index, exactly like the MT variant's outdated-flag staleness.
    Unshifted comparison reads a constant ~lag*step band that says
    nothing about tracking quality."""
    t = np.stack(truth)
    idx = np.maximum(np.arange(len(per_scan)) - lag, 0)
    if lag:
        # _replay overwrites per_scan[-1] with the post-flush committed
        # pose (golden_replay.py), which is lag-0 by construction.
        idx[-1] = len(per_scan) - 1
    return np.linalg.norm(per_scan[:, :3, 3] - t[idx, :3, 3], axis=1)


def test_deferred_lag0_bitwise_matches_classic(golden):
    """The deferred machinery run at lag 0
    (``force_deferred`` with ``sync_lag=0`` — dispatch + immediate
    commit, empty pipeline throughout) must be BIT-IDENTICAL to the
    classic per-scan-sync path, per scan. Fresh dispatches take the
    classic initial-guess/probe numerics and fresh commits the classic
    pose composition, so any divergence here is a real code-path split
    the envelope pins of the lag>=1 tests cannot see. The comparison is
    a same-session classic replay (assert_array_equal, zero tolerance),
    not the stored fixture — the fixture pin carries a 1e-5 tolerance
    for cross-version float drift, which would mask exactly the small
    splits this test exists to catch."""
    import dataclasses

    from golden_replay import _replay

    classic_per_scan, classic_traj, classic_stats = _replay(
        golden_sequence(), golden_config())
    cfg = golden_config()
    cfg = dataclasses.replace(
        cfg, localizer=dataclasses.replace(cfg.localizer,
                                           force_deferred=True))
    per_scan, trajectory, stats = _replay(golden_sequence(), cfg)
    np.testing.assert_array_equal(per_scan, classic_per_scan)
    np.testing.assert_array_equal(trajectory, classic_traj)
    assert stats == classic_stats
    assert stats["n_loops"] == golden["n_loops"]


def test_deferred_verification_matches_golden(golden):
    """LoopCloser.deferred_verification: the
    spawn-time verification dispatch commits one scan later (riding the
    next scan's window). Same staleness class as the MT variant's
    unlocked verification — the closure lands one scan later, so the pin
    is the event count + the corrected final pose, not bitwise scans."""
    import dataclasses

    from golden_replay import _replay

    scans, odom, truth = golden_sequence()
    cfg = golden_config()
    cfg = dataclasses.replace(
        cfg, loop_closer=dataclasses.replace(cfg.loop_closer,
                                             deferred_verification=True))
    per_scan, trajectory, stats = _replay((scans, odom, truth), cfg)
    assert stats["n_loops"] == golden["n_loops"] >= 1
    d_final = np.linalg.norm(per_scan[-1][:3, 3]
                             - golden["per_scan"][-1][:3, 3])
    assert d_final < 0.10, f"deferred-verification final dev {d_final}"
    # Pose-level pins are the sync_lag envelope style: the closure lands
    # one scan later, which shifts the decision cascade (keyframe poses,
    # drift path) like the MT variant — tracking quality vs TRUTH stays
    # in golden's envelope and the corrected final pose re-converges.
    gold_te = _truth_errs(golden["per_scan"], truth)
    te = _truth_errs(per_scan, truth)
    assert te.max() < max(0.30, 1.5 * gold_te.max()), \
        f"truth-err {te.max()} vs golden {gold_te.max()}"


def test_streaming_micro_batch_matches_golden(golden):
    """LocalizerConfig.micro_batch (the streaming mode): scans register
    in fused micro-batches with a commit lag of up to micro_batch scans. Decisions quantize to batch
    boundaries, so the pins are the sync_lag envelope style: closures
    fire, tracking quality vs truth stays within golden's envelope
    scaled by the longer dead-reckoning segments, and the corrected
    final pose re-converges."""
    import dataclasses

    from golden_replay import _replay

    scans, odom, truth = golden_sequence()
    cfg = golden_config()
    cfg = dataclasses.replace(
        cfg, localizer=dataclasses.replace(cfg.localizer, micro_batch=4))
    per_scan, trajectory, stats = _replay((scans, odom, truth), cfg)
    assert stats["n_loops"] >= 1
    d_final = np.linalg.norm(per_scan[-1][:3, 3]
                             - np.stack(truth)[-1][:3, 3])
    assert d_final < 0.15, f"streaming final err vs truth {d_final}"
    # The pose reported after add_data(i) trails by a VARIABLE 1..B
    # scans (batch-boundary quantized), so compare against the best
    # truth index in the trailing window — a constant-lag comparison
    # reads the batch phase, not tracking quality.
    t = np.stack(truth)
    gold_te = _truth_errs(golden["per_scan"], truth)
    te = []
    for i in range(len(per_scan) - 1):
        lo = max(0, i - 4)
        te.append(np.linalg.norm(per_scan[i][:3, 3]
                                 - t[lo:i + 1, :3, 3], axis=1).min())
    te = np.asarray(te)
    assert te.max() < max(0.5, 2.5 * gold_te.max()), \
        f"streaming truth-err {te.max()} vs golden {gold_te.max()}"


@pytest.mark.slow
def test_deferred_matches_golden(golden):
    """The deferred-commit ST path (sync_lag, r4) replays the golden
    sequence. Deferred DECISIONS shift by up to sync_lag(+1 muted) scans,
    so keyframes land at slightly different poses and dead-reckoning
    drift between closures accumulates along a genuinely different (but
    equally valid) path — per-scan equality with golden is not the
    semantics (measured: mid-run dev grows to ~0.35 m and collapses at
    the closure, exactly like drift). The honest pins: tracking quality
    vs TRUTH matches golden's envelope, the closure fires, and the
    corrected final pose re-converges to golden.

    The mid-run envelope widens with lag: decisions quantize to
    lag+1-scan boundaries (an event commit mutes the still-in-flight
    scans dispatched against the old map), so a keyframe spawn can fire
    up to lag+1 scans after golden's and the pre-closure dead-reckoning
    segment stretches accordingly (measured on this corridor: peak
    truth-err 0.48 golden / 0.90 lag-2, collapsing at the closure)."""
    scans, odom, truth = golden_sequence()
    gold_truth_errs = _truth_errs(golden["per_scan"], truth)
    for lag, mult in ((1, 1.5), (2, 2.0)):
        per_scan, trajectory, stats = _replay(
            (scans, odom, truth), golden_config(), sync_lag=lag)
        te = _truth_errs(per_scan, truth, lag=lag)
        assert te.max() < max(0.30, mult * gold_truth_errs.max()), \
            f"lag={lag} truth-err {te.max()} vs golden {gold_truth_errs.max()}"
        d_final = np.linalg.norm(per_scan[-1][:3, 3]
                                 - golden["per_scan"][-1][:3, 3])
        assert d_final < 0.10, f"lag={lag} final dev {d_final}"
        assert stats["n_loops"] >= 1


# ---- long fixture (300 scans, >=3 closures) ------------------------------

@pytest.fixture(scope="module")
def golden_long():
    data = np.load(FIXTURE_LONG)
    return {k: data[k] for k in data.files}


@pytest.mark.slow
def test_st_long_matches_golden(golden_long):
    per_scan, trajectory, stats = run_st_replay_long()
    np.testing.assert_allclose(per_scan, golden_long["per_scan_poses"],
                               atol=1e-5)
    np.testing.assert_allclose(trajectory, golden_long["trajectory"],
                               atol=1e-5)
    # The events this fixture exists to pin (guards config drift that
    # would silently make it trivial):
    assert stats["n_loops"] == int(golden_long["n_loop_edges"]) >= 3
    assert stats["opt_runs"] == int(golden_long["opt_runs"]) >= 3
    assert stats["n_swaps"] == int(golden_long["n_swaps"]) >= 1
    assert stats["n_keyframes"] == int(golden_long["n_keyframes"])


@pytest.mark.slow
def test_mt_long_per_scan_matches_golden(golden_long):
    """MT per-scan pins over the LONG fixture: three closure events,
    multiple composition swaps and re-anchors (lockstep drive; ±1
    window for the deferred outdated-flag resync). Tolerance 0.30: the
    MT path's closure corrections land one scan later, which shifts
    keyframe poses slightly and makes between-closure dead reckoning
    accumulate along its own path (measured max dev 0.215 over 300
    scans, re-converging after every closure); the final corrected pose
    is pinned tight."""
    from pgslam_tpu.graph.pose_graph import LOOP_CONSTRAINT
    from pgslam_tpu.pipeline import PoseGraphSlamMT

    scans, odom, _ = long_sequence()
    T_rs = np.eye(4, dtype=np.float32)
    per_scan = []
    slam = PoseGraphSlamMT(golden_config())
    with slam:
        for i, (scan, T_odom) in enumerate(zip(scans, odom)):
            slam.add_data(i, "world", T_odom, T_rs, scan)
            assert slam.wait_idle(timeout=120.0)
            per_scan.append(slam.localizer.T_world_robot.copy())
        g = slam.get_graph()
        n_loops = int(np.sum(g.edge_type[:g.n_edges] == LOOP_CONSTRAINT))
    errs = _pose_errs(np.stack(per_scan),
                      golden_long["per_scan_poses"], window=1)
    assert errs.max() < 0.30, f"MT long per-scan max dev {errs.max()}"
    d_final = np.linalg.norm(per_scan[-1][:3, 3]
                             - golden_long["per_scan_poses"][-1][:3, 3])
    assert d_final < 0.10, f"MT long final dev {d_final}"
    assert n_loops >= 3


@pytest.mark.slow
def test_deferred_long_matches_golden(golden_long):
    """Deferred-commit over the long fixture: decisions shift by up to
    sync_lag+1 scans, so between-closure drift diverges from golden by
    design (measured: grows to ~0.6 m along each 50 m petal, collapses
    to ~0.03-0.06 m at each closure). Pins: same event counts, same
    tracking quality vs truth, re-converged final pose."""
    scans, odom, truth = long_sequence()
    per_scan, _, stats = _replay((scans, odom, truth), golden_config(),
                                 sync_lag=2)
    gold_te = _truth_errs(golden_long["per_scan_poses"], truth)
    te = _truth_errs(per_scan, truth, lag=2)
    assert te.max() < max(0.8, 1.5 * gold_te.max()), \
        f"deferred long truth-err {te.max()} vs golden {gold_te.max()}"
    d_final = np.linalg.norm(
        per_scan[-1][:3, 3] - golden_long["per_scan_poses"][-1][:3, 3])
    assert d_final < 0.10, f"deferred long final dev {d_final}"
    assert stats["n_loops"] >= 3
    assert stats["opt_runs"] >= 3


# ---- 64k-scale fixture (slow tier) -----------------------------------------

@pytest.mark.slow
def test_st_64k_matches_golden():
    data = np.load(FIXTURE_64K)
    per_scan, trajectory, stats = run_st_replay_64k()
    np.testing.assert_allclose(per_scan, data["per_scan_poses"],
                               atol=1e-5)
    np.testing.assert_allclose(trajectory, data["trajectory"], atol=1e-5)
    assert stats["n_keyframes"] == int(data["n_keyframes"])
