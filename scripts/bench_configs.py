"""Run all five BASELINE.json benchmark configs and emit one JSON line
per config (plus a summary file, bench_configs.json in the temporary
directory).

    python scripts/bench_configs.py          # all five
    python scripts/bench_configs.py 2,5      # a selection

Runs on whatever device JAX finds (JAX_PLATFORMS=cpu for the CPU).
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# tests/ on the path for the shared small_config fixture (configs 2 & 5
# both import it; keep this module-level so single-config runs work too)
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))

import numpy as np
import jax
import jax.numpy as jnp

from pgslam_tpu.utils.compile_cache import enable_compile_cache

RESULTS = []

# Accuracy gates: each config asserts a tolerance so
# an accuracy regression can NOT ship silently inside a green round. The
# run exits non-zero on any breach; the JSON records pass/fail per config.
GATES = {
    "1_single_icp_pair_1k": ("transform_err", 1e-4),
    "2_sequential_odometry_200": ("final_err_m", 0.3),
    "3_loop_closure_500": ("closure_err_m", 0.01),
    "4_velodyne_full_slam_64k": ("final_err_m", 0.3),
    "5_multi_agent_16": ("max_agent_err_m", 0.3),
}


def emit(name, **kv):
    rec = {"config": name, **kv}
    gate = GATES.get(name)
    if gate is not None and gate[0] in rec:
        key, tol = gate
        rec["gate"] = f"{key} < {tol}"
        rec["passed"] = bool(rec[key] < tol)
    elif "error" in rec:
        rec["passed"] = False
    RESULTS.append(rec)
    print(json.dumps(rec), flush=True)


def config1_single_pair():
    """Two 1k-pt synthetic clouds, known SE(3) offset, point-to-point."""
    from pgslam_tpu import se3
    from pgslam_tpu.cloud import make_cloud
    from pgslam_tpu.ops import outlier as O
    from pgslam_tpu.ops.icp import ICPConfig, ICPEngine

    rng = np.random.default_rng(0)
    pts = rng.uniform(-5, 5, (1000, 3)).astype(np.float32)
    pts[:, 2] = np.sign(pts[:, 2]) * 2 + rng.normal(size=1000) * 0.3
    ref = make_cloud(pts, capacity=1024)
    offset = se3.exp(jnp.asarray([0.3, -0.2, 0.1, 0.05, -0.03, 0.08],
                                 jnp.float32))
    reading = make_cloud(
        np.asarray(se3.apply(se3.inverse(offset), jnp.asarray(pts))),
        capacity=1024)
    cfg = ICPConfig(error="point_to_point", max_iterations=30,
                    outlier=(O.TrimmedDist(0.95), O.MaxDist(1.0)))
    eng = ICPEngine(cfg)
    eng.set_map(ref)
    res = eng(reading, se3.identity())
    jax.block_until_ready(res.T)
    err = float(np.linalg.norm(
        np.asarray(se3.log(se3.inverse(res.T) @ offset))))
    t0 = time.perf_counter()
    reps = 50
    for _ in range(reps):
        res = eng(reading, se3.identity())
    jax.block_until_ready(res.T)
    dt = (time.perf_counter() - t0) / reps
    emit("1_single_icp_pair_1k", ms_per_registration=round(dt * 1e3, 3),
         registrations_per_sec=round(1 / dt, 1), transform_err=round(err, 6),
         iterations=int(res.iterations))


def config2_corridor():
    """200-scan corridor, scan-to-keyframe ICP chain, no loop closures."""
    from pgslam_tpu.datasets import corridor_sequence
    from pgslam_tpu.slam import PoseGraphSlam
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
    from test_slam_e2e import small_config

    import dataclasses

    rng = np.random.default_rng(7)
    scans, odom, truth = corridor_sequence(
        rng, n_scans=200, scan_points=512, step=0.25, noise=0.003,
        odom_noise=0.005, length=60.0)
    # sync_lag=2: the live-loop deferred-commit path, same semantics
    # note as config 4 — the per-scan packed-result d2h rides behind
    # later scans' dispatches instead of a sync every scan.
    cfg2 = small_config()
    cfg2 = dataclasses.replace(
        cfg2, localizer=dataclasses.replace(cfg2.localizer, sync_lag=2),
        # spawn-time loop-closure verification commits at the next
        # scan's drain (no closures fire on this corridor, but the
        # config mirrors the deployable deferred profile)
        loop_closer=dataclasses.replace(cfg2.loop_closer,
                                        deferred_verification=True))
    slam = PoseGraphSlam(cfg2)
    T_rs = np.eye(4, dtype=np.float32)
    # warm up compiles (incl. composition growth) on the first scans
    for i in range(12):
        slam.add_data(i, "world", odom[i], T_rs, scans[i])
    slam.flush()
    # Double-buffered ingest: scan t+1 transfers while scan t computes.
    from pgslam_tpu.utils.prefetch import prefetch_clouds
    cap = cfg2.sensor_cloud_capacity
    t0 = time.perf_counter()
    n = 0
    for i, cloud in enumerate(prefetch_clouds(scans[12:], capacity=cap),
                              start=12):
        slam.add_data(i, "world", odom[i], T_rs, cloud)
        n += 1
    slam.flush()
    dt = time.perf_counter() - t0
    err = float(np.linalg.norm(
        slam.localizer.T_world_robot[:3, 3] - truth[-1][:3, 3]))
    emit("2_sequential_odometry_200", scans_per_sec=round(n / dt, 2),
         final_err_m=round(err, 3), sync_lag=2,
         keyframes=int(slam.get_graph().n_vertices))


def config3_loop_500():
    """500-pose loop: candidate gating math + pose-graph relaxation."""
    from pgslam_tpu import se3
    from pgslam_tpu.graph.shortest_path import dijkstra
    from pgslam_tpu.metrics import distance
    from pgslam_tpu.optim.pgo import PGOConfig, optimize_pose_graph

    V = 500
    rng = np.random.default_rng(1)
    ang = 2 * np.pi * np.arange(V) / V
    R = np.asarray(se3.exp_so3(jnp.asarray(
        np.stack([np.zeros(V), np.zeros(V), ang], -1), jnp.float32)))
    t = np.stack([20 * np.cos(ang), 20 * np.sin(ang), np.zeros(V)], -1)
    true = np.asarray(se3.make(jnp.asarray(R), jnp.asarray(
        t.astype(np.float32))))
    drift = np.asarray(jax.vmap(se3.exp)(jnp.asarray(
        np.cumsum(rng.normal(size=(V, 6)) * 0.002, 0), jnp.float32)))
    init = np.einsum("vij,vjk->vik", true, drift).astype(np.float32)
    ef = np.arange(V - 1, dtype=np.int32)
    et = np.arange(1, V, dtype=np.int32)
    Ts = np.einsum("eij,ejk->eik", np.linalg.inv(init[ef]),
                   init[et]).astype(np.float32)
    # Candidate search, production path (loopcloser.py semantics): host
    # Dijkstra + host numpy geometric gating + per-candidate filtered
    # record-3-and-stop searches. No device round-trips.
    from pgslam_tpu.graph.shortest_path import candidate_composition
    w = np.linalg.norm(Ts[:, :3, 3], axis=1).astype(np.float32)
    t0 = time.perf_counter()
    topo, _ = dijkstra(V, ef, et, w, V - 1)
    geom = np.linalg.norm(init[:, :3, 3] - init[V - 1, :3, 3], axis=1)
    cand = np.nonzero((geom <= 5.0) & (topo > 30.0))[0]
    cand = cand[np.argsort(geom[cand], kind="stable")]
    vertex_ok = topo > 30.0
    edge_ok = np.ones(len(ef), bool)
    comps = [candidate_composition(V, ef, et, w, int(c), 3,
                                   vertex_ok=vertex_ok, edge_ok=edge_ok)
             for c in cand]
    t_search = time.perf_counter() - t0
    del comps
    # Loop edge from last to the best candidate + relaxation.
    c = int(cand[np.argmin(geom[cand])]) if len(cand) else 0
    T_loop = np.linalg.inv(true[V - 1]) @ true[c]
    ef2 = np.concatenate([ef, [V - 1]]).astype(np.int32)
    et2 = np.concatenate([et, [c]]).astype(np.int32)
    Ts2 = np.concatenate([Ts, T_loop[None]]).astype(np.float32)
    covs = np.tile((np.eye(6, dtype=np.float32) * 0.01), (V, 1, 1))
    args = (jnp.asarray(init), jnp.ones(V, bool), jnp.asarray(ef2),
            jnp.asarray(et2), jnp.asarray(Ts2), jnp.asarray(covs),
            jnp.ones(V, bool), jnp.int32(0))
    cfg = PGOConfig(max_iterations=4, cg_iterations=30, cg_tol=1e-3)
    out, stats = optimize_pose_graph(*args, config=cfg)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    reps = 10
    for _ in range(reps):
        out, stats = optimize_pose_graph(*args, config=cfg)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    closure_err = float(np.linalg.norm(
        np.asarray(out)[V - 1][:3, 3] - true[V - 1][:3, 3]))
    emit("3_loop_closure_500", candidates_found=int(len(cand)),
         candidate_search_ms=round(t_search * 1e3, 2),
         optimize_ms=round(dt * 1e3, 2),
         final_cost=float(np.asarray(stats["final_cost"])),
         closure_err_m=round(closure_err, 4))


def config4_velodyne():
    """64k-pt scans, point-to-plane, full SLAM loop with map updates."""
    from pgslam_tpu.datasets import velodyne_like_scan
    from pgslam_tpu.slam import PoseGraphSlam
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "examples"))
    from velodyne_slam import velodyne_config

    from pgslam_tpu.datasets import corridor_world, render_scan

    rng = np.random.default_rng(0)
    world = corridor_world(rng, n_points=200000, length=60.0, width=8.0,
                           height=5.0)

    def pose_at(x):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [x, 0.0, 1.8]
        return T

    # 56 scans: the first 30 are warm-up. A short warm-up leaves
    # first-trace compiles INSIDE the window — each local-map
    # composition SIZE (1..capacity keyframes) traces its own jitted
    # map build, and the corridor spawns a
    # keyframe every ~4 scans, so composition growth only settles after
    # ~4*capacity scans. The timed window still contains every
    # steady-state cost (registrations, keyframe spawns, probe-map
    # rebuilds, set_map) — just not one-time traces.
    poses = [pose_at(2.0 + i * 1.0) for i in range(56)]
    scans = [render_scan(world, T, rng, 65536, max_range=30.0, noise=0.01)
             for T in poses]
    # Stage the spins as KITTI .bin files and stream them back through the
    # native C++ async loader — the deployable disk -> host -> device path
    # (config 4 consumes .bin via native/scan_loader).
    import tempfile

    from pgslam_tpu.datasets import save_kitti_bin
    bin_dir = tempfile.mkdtemp(prefix="velodyne_bin_")
    for i, s in enumerate(scans):
        save_kitti_bin(os.path.join(bin_dir, f"{i:06d}.bin"), s)
    native = True
    try:
        from pgslam_tpu.native import ScanLoader
        # quantize_mm: the loader's IO thread packs each spin to int16
        # millimeters (KITTI-native grid, 0.5 mm round-off), HALVING the
        # per-scan h2d bytes; the jitted ingest dequantizes in-graph.
        loader = iter(ScanLoader(bin_dir, prefetch_depth=2,
                                 quantize_mm=True))
    except ImportError:
        native = False
        loader = iter(scans)
    # sync_lag=2: the deferred-commit live loop — scan results commit
    # two scans late so the packed-result d2h overlaps in-flight
    # transfers instead of serializing.
    slam = PoseGraphSlam(velodyne_config(sync_lag=2))
    # Warm through composition growth to the local-map capacity (see the
    # poses comment): keyframe spawns, every composition size, and the
    # loop-closer first-traces are all one-time costs, not per-scan ones.
    n_warm = 30
    for i in range(n_warm):
        slam.add_data(i, "world", poses[i], np.eye(4), next(loader))
    slam.flush()
    # Triple overlap: native disk reads ahead of host staging ahead of
    # the device registrations; decision commits trail two scans.
    from pgslam_tpu.utils.prefetch import prefetch_clouds
    t0 = time.perf_counter()
    n = 0
    for i, cloud in enumerate(prefetch_clouds(loader, capacity=65536),
                              start=n_warm):
        slam.add_data(i, "world", poses[i], np.eye(4), cloud)
        n += 1
    slam.flush()   # all n scans' results + decisions land in-window
    dt = (time.perf_counter() - t0) / n
    err = float(np.linalg.norm(
        slam.localizer.T_world_robot[:3, 3] - poses[len(scans) - 1][:3, 3]))
    emit("4_velodyne_full_slam_64k", ms_per_scan=round(dt * 1e3, 1),
         scans_per_sec=round(1 / dt, 2), final_err_m=round(err, 3),
         keyframes=int(slam.get_graph().n_vertices),
         native_bin_loader=native, sync_lag=2)


def config5_multi_agent():
    """16 agents sharing one pose graph, fused vmapped registration."""
    from pgslam_tpu.datasets import corridor_sequence
    from pgslam_tpu.parallel.multi_agent import MultiAgentSlam
    from test_slam_e2e import small_config

    rng = np.random.default_rng(7)
    scans, odom, truth = corridor_sequence(
        rng, n_scans=72, scan_points=512, step=0.25, noise=0.003,
        odom_noise=0.005, length=60.0)
    B = 16
    slam = MultiAgentSlam(small_config(), n_agents=B)
    T_rs = np.eye(4, dtype=np.float32)

    def step(i):
        Ts = np.stack([odom[i + b % 3] for b in range(B)])
        clouds = [scans[i + b % 3] for b in range(B)]
        slam.add_data_batch(i, "world", Ts, T_rs, clouds)

    # Bring-up trace pre-warm: the first closure drain's verification +
    # optimize traces (HOST tracing the compile cache cannot cover) move
    # out of the serving window into bring-up, where deployment pays
    # them once.
    t_pw = time.perf_counter()
    slam.prewarm()
    prewarm_s = time.perf_counter() - t_pw
    step(0)
    step(1)   # warm
    # 60-step horizon: the first loop-closure drain + optimize pay
    # one-time host traces (seconds each on this core); a 28-step
    # window measured mostly those. The mean still INCLUDES them —
    # warm_ms reports the amortized steady state separately.
    per_step = []
    t0 = time.perf_counter()
    for i in range(2, 62):
        ts = time.perf_counter()
        step(i)
        per_step.append(time.perf_counter() - ts)
    dt = (time.perf_counter() - t0) / len(per_step)
    warm = per_step[len(per_step) // 2:]
    errs = [np.linalg.norm(slam.localizers[b].T_world_robot[:3, 3]
                           - truth[61 + b % 3][:3, 3]) for b in range(B)]
    emit("5_multi_agent_16", ms_per_batch_step=round(dt * 1e3, 1),
         agent_scans_per_sec=round(B / dt, 1),
         warm_ms_per_batch_step=round(float(np.mean(warm)) * 1e3, 1),
         warm_agent_scans_per_sec=round(B / float(np.mean(warm)), 1),
         max_agent_err_m=round(float(np.max(errs)), 3),
         prewarm_s=round(prewarm_s, 1),
         keyframes=int(slam.get_graph().n_vertices))


def main():
    enable_compile_cache()
    print(f"# backend: {jax.devices()}", file=sys.stderr, flush=True)
    configs = (config1_single_pair, config2_corridor, config3_loop_500,
               config4_velodyne, config5_multi_agent)
    if len(sys.argv) > 1:   # e.g. "5" or "2,5" — rerun selected configs
        want = {int(x) for x in sys.argv[1].split(",")}
        configs = tuple(f for i, f in enumerate(configs, 1) if i in want)
    for fn in configs:
        try:
            t0 = time.perf_counter()
            fn()
            print(f"# {fn.__name__} took {time.perf_counter()-t0:.1f}s",
                  file=sys.stderr, flush=True)
        except Exception as e:
            emit(fn.__name__, error=str(e)[:200])
    import tempfile
    with open(os.path.join(tempfile.gettempdir(), "bench_configs.json"),
              "w") as fh:
        json.dump(RESULTS, fh, indent=1)
    failed = [r["config"] for r in RESULTS if not r.get("passed", True)]
    if failed:
        print(f"# ACCURACY GATE FAILED: {failed}", file=sys.stderr,
              flush=True)
        sys.exit(1)
    print("# all accuracy gates passed", file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
