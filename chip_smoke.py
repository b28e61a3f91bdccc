#!/usr/bin/env python3
"""Smoke run of the SLAM main path on NVIDIA GPUs, through the entry
points a user calls, with every accuracy gate checked.

    python chip_smoke.py               # one card: slam, fleet, knn, pgo
    python chip_smoke.py --four-cards  # four cards: the sharded path only

Each phase prints what it ran, its accuracy gate and informational
times; a failed gate raises, and the script exits non-zero. Before the
last line it prints the card's name and power limit (nvidia-smi); the
last line is one JSON object naming the device as JAX reports it.
Without a GPU it exits non-zero before any phase runs. Everything runs
in this one process, which holds the card(s).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def gate(ok: bool, what: str) -> None:
    log(f"    gate {'ok  ' if ok else 'FAIL'} {what}")
    if not ok:
        raise AssertionError(what)


def require_gpus(count: int):
    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu" or len(devices) < count:
        sys.exit(f"chip_smoke: needs {count} GPU(s); JAX found {devices}")
    return devices


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def median_ms(fn, n: int = 20) -> float:
    import jax
    jax.block_until_ready(fn())
    jax.block_until_ready(fn())
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def fallback_counts() -> dict:
    from pgslam_tpu.utils import counters
    return {k: v for k, v in counters.items() if "fallback" in k}


# --------------------------------------------------------------------------
# Phase 1: single-robot SLAM on a ring drive (PoseGraphSlam, then MT)
# --------------------------------------------------------------------------

def slam_config(capacity: int):
    """The velodyne profile (examples/velodyne_slam.py: point-to-plane,
    0.4/0.2 m voxel working sets, exact-kNN matcher kernel) at
    ``capacity`` points per scan and keyframe, adapted to the ring drive
    of tests/test_slam_e2e.py (loop_config):

    * localizer ICP: that drive's outlier filters (trimmed 0.85, max
      distance 0.5 m) and iteration budget (30 iterations, eps 5e-3, no
      coarse stage) in place of the throughput profile's (0.9 / 1.0 m,
      5 iterations after an 8-iteration coarse stage), which slides
      along the 4 m-wide ring corridor;
    * loop closer: topological 10, geometric 4 m, overlap 0.6, residual
      5000; its verification ICP is the velodyne one unchanged."""
    sys.path.insert(0, os.path.join(REPO, "examples"))
    from velodyne_slam import velodyne_config
    from pgslam_tpu.ops import outlier as O
    cfg = velodyne_config()
    icp = dataclasses.replace(
        cfg.localizer.icp, outlier=(O.TrimmedDist(0.85), O.MaxDist(0.5)),
        max_iterations=30, coarse_div=0, trans_eps=5e-3, rot_eps=5e-3)
    return dataclasses.replace(
        cfg,
        localizer=dataclasses.replace(cfg.localizer, icp=icp,
                                      keyframe_cloud_capacity=capacity),
        loop_closer=dataclasses.replace(
            cfg.loop_closer, topo_dist_threshold=10.0,
            geom_dist_threshold=4.0, overlap_threshold=0.6,
            residual_error_threshold=5000.0),
        sensor_cloud_capacity=capacity)


def phase_slam(n_points: int = 65536, n_scans: int = 140,
               world_points: int = 300_000, mt_scans: int = 40) -> None:
    from pgslam_tpu import PoseGraphSlam, PoseGraphSlamMT
    from pgslam_tpu.datasets import loop_sequence
    from pgslam_tpu.graph.pose_graph import LOOP_CONSTRAINT
    from pgslam_tpu.utils import counters

    log(f"[slam] ring drive: loop_sequence seed 3, {n_scans} scans x "
        f"{n_points} points, world {world_points} points; velodyne "
        f"profile (ring-drive outliers and budget), matcher=pallas, "
        f"capacity {n_points}")
    t0 = time.perf_counter()
    scans, odom, truth = loop_sequence(
        np.random.default_rng(3), n_scans=n_scans, scan_points=n_points,
        radius=12.0, max_range=8.0, noise=0.002, odom_drift=0.002,
        world_points=world_points)
    log(f"    rendered in {time.perf_counter() - t0:.1f} s")
    cfg = slam_config(n_points)
    T_rs = np.eye(4, dtype=np.float32)

    runs0 = counters["optimizer/runs"]
    slam = PoseGraphSlam(cfg)
    t0 = time.perf_counter()
    for i, (scan, T_odom) in enumerate(zip(scans, odom)):
        slam.add_data(i, "world", T_odom, T_rs, scan)
    wall = time.perf_counter() - t0
    g = slam.get_graph()
    n_loops = int(np.sum(g.edge_type[:g.n_edges] == LOOP_CONSTRAINT))
    err = float(np.linalg.norm(slam.T_world_robot[:3, 3]
                               - truth[-1][:3, 3]))
    drift = float(np.linalg.norm(odom[-1][:3, 3] - truth[-1][:3, 3]))
    runs = counters["optimizer/runs"] - runs0
    mirror = slam.optimizer._mirror
    log(f"    {n_scans} scans in {wall:.1f} s incl. compiles; "
        f"{g.n_vertices} keyframes, {n_loops} loop closures, "
        f"{int(runs)} optimizes; final error {err:.3f} m vs odometry "
        f"drift {drift:.3f} m")
    gate(n_loops >= 1, f"accepted loop closures {n_loops} >= 1")
    gate(runs >= 1 and mirror is not None and mirror._st is not None
         and not fallback_counts().get("optimizer/resident_fallbacks"),
         f"optimizes through the resident path {int(runs)} >= 1")
    gate(err < 0.5 * drift,
         f"final error {err:.3f} m < 0.5 x drift {drift:.3f} m")

    log(f"[slam] PoseGraphSlamMT: first {mt_scans} scans, wait_idle")
    mt = PoseGraphSlamMT(cfg)
    mt.run()
    try:
        t0 = time.perf_counter()
        for i in range(mt_scans):
            mt.add_data(i, "world", odom[i], T_rs, scans[i])
        idle = mt.wait_idle(timeout=600.0)
        wall = time.perf_counter() - t0
    finally:
        mt.stop()
    err_mt = float(np.linalg.norm(mt.T_world_robot[:3, 3]
                                  - truth[mt_scans - 1][:3, 3]))
    log(f"    {mt_scans} scans in {wall:.1f} s; "
        f"{mt.get_graph().n_vertices} keyframes; error {err_mt:.3f} m")
    gate(idle, "MT workers drained")
    gate(err_mt < 0.3, f"MT tracking error {err_mt:.3f} m < 0.3 m")


# --------------------------------------------------------------------------
# Phase 2: the 16-agent fleet (MultiAgentSlam)
# --------------------------------------------------------------------------

def fleet_config(matcher: str = "pallas"):
    """BASELINE config 5 shapes (scripts/bench_configs.py): 512-point
    corridor scans, sensor capacity 768, keyframe capacity 512, exact-kNN
    ``matcher`` (the kernel by default) under vmap."""
    from pgslam_tpu.localizer import LocalizerConfig
    from pgslam_tpu.loopcloser import LoopCloserConfig
    from pgslam_tpu.ops import outlier as O
    from pgslam_tpu.ops.icp import ICPConfig
    from pgslam_tpu.slam import SlamConfig
    icp = ICPConfig(error="point_to_point", matcher=matcher,
                    max_iterations=30,
                    outlier=(O.TrimmedDist(0.9), O.MaxDist(0.5)),
                    trans_eps=1e-3, rot_eps=1e-3,
                    max_correction_trans=2.0, max_correction_rot=0.5)
    return SlamConfig(
        localizer=LocalizerConfig(icp=icp, keyframe_cloud_capacity=512,
                                  overlap_threshold=0.8),
        loop_closer=LoopCloserConfig(
            icp=icp, topo_dist_threshold=6.0, geom_dist_threshold=3.0,
            overlap_threshold=0.7, residual_error_threshold=5000.0),
        sensor_cloud_capacity=768)


def run_fleet(matcher: str = "pallas", n_agents: int = 16,
              n_steps: int = 24):
    """Drive ``MultiAgentSlam`` over a corridor (corridor_sequence seed
    7, agents staggered by up to 2 scans). Returns the per-step wall
    times in seconds, each agent's final translation error, the number
    of verified loop-closure candidates and the keyframe count."""
    from pgslam_tpu import MultiAgentSlam
    from pgslam_tpu.datasets import corridor_sequence
    from pgslam_tpu.utils import counters

    scans, odom, truth = corridor_sequence(
        np.random.default_rng(7), n_scans=72, scan_points=512, step=0.25,
        noise=0.003, odom_noise=0.005, length=60.0)
    slam = MultiAgentSlam(fleet_config(matcher), n_agents=n_agents)
    T_rs = np.eye(4, dtype=np.float32)
    keys = ("loopcloser/accepted", "loopcloser/rejected",
            "loopcloser/rejected_duplicate")
    verified0 = sum(counters[k] for k in keys)
    t0 = time.perf_counter()
    slam.prewarm()
    log(f"    prewarm {time.perf_counter() - t0:.1f} s")
    steps = []
    for i in range(n_steps):
        ts = time.perf_counter()
        slam.add_data_batch(
            i, "world", np.stack([odom[i + b % 3] for b in range(n_agents)]),
            T_rs, [scans[i + b % 3] for b in range(n_agents)])
        steps.append(time.perf_counter() - ts)
    verified = int(sum(counters[k] for k in keys) - verified0)
    last = n_steps - 1
    errs = [float(np.linalg.norm(slam.localizers[b].T_world_robot[:3, 3]
                                 - truth[last + b % 3][:3, 3]))
            for b in range(n_agents)]
    return steps, errs, verified, slam.get_graph().n_vertices


def phase_fleet(n_agents: int = 16, n_steps: int = 24) -> None:
    log(f"[fleet] MultiAgentSlam, {n_agents} agents, {n_steps} steps, "
        f"corridor_sequence seed 7 (512-point scans)")
    steps, errs, verified, n_kf = run_fleet("pallas", n_agents, n_steps)
    log(f"    median step {np.median(steps[n_steps // 2:]) * 1e3:.1f} ms "
        f"(second half), {n_kf} keyframes, {verified} verified candidates")
    gate(verified >= 1, f"loop-closure verifications drained {verified}"
         " >= 1")
    gate(max(errs) < 0.3, f"max agent error {max(errs):.3f} m < 0.3 m")


# --------------------------------------------------------------------------
# Phase 3: the matcher kernel against brute force and float64
# --------------------------------------------------------------------------

def nn_float64(q: np.ndarray, r: np.ndarray, rmask: np.ndarray,
               chunk: int = 256):
    """Nearest valid reference (squared distance, id) in float64."""
    r64 = r.astype(np.float64)
    d_all, i_all = [], []
    for s in range(0, len(q), chunk):
        d = ((q[s:s + chunk, None, :].astype(np.float64)
              - r64[None]) ** 2).sum(-1)
        d[:, ~rmask] = np.inf
        i = d.argmin(axis=1)
        d_all.append(d[np.arange(len(i)), i])
        i_all.append(i)
    return np.concatenate(d_all), np.concatenate(i_all)


def d2_float64(q: np.ndarray, r: np.ndarray, ids: np.ndarray) -> np.ndarray:
    return ((q.astype(np.float64) - r[ids].astype(np.float64)) ** 2).sum(-1)


def phase_knn(sizes=((2048, 65536), (65536, 65536)),
              n_sub: int = 4096) -> None:
    import jax
    import jax.numpy as jnp
    from pgslam_tpu.ops.knn import knn_brute_force
    from pgslam_tpu.ops.knn_pallas import nn_pallas

    for nq, nr in sizes:
        rng = np.random.default_rng(11)
        # A 100 m box of map points, 1% masked; readings lie near the
        # map with 5 cm noise, as an ICP reading does after its first
        # iterations.
        r = rng.uniform(-50, 50, (nr, 3)).astype(np.float32)
        rm = rng.random(nr) > 0.01
        q = (r[rng.integers(0, nr, nq)]
             + rng.normal(0, 0.05, (nq, 3))).astype(np.float32)
        qd, rd = jnp.asarray(q), jnp.asarray(r)
        qmd, rmd = jnp.ones(nq, bool), jnp.asarray(rm)
        tile_q = 8192 if nq > 8192 else 0
        log(f"[knn] kernel vs knn_brute_force(HIGHEST) at {nq} x {nr}")

        def kernel():
            return nn_pallas(qd, qmd, rd, rmd)

        def brute():
            return knn_brute_force(qd, qmd, rd, rmd, tile_query=tile_q,
                                   precision=jax.lax.Precision.HIGHEST)

        k, b = jax.device_get(kernel()), jax.device_get(brute())
        ki, bi = np.asarray(k.ids)[:, 0], np.asarray(b.ids)[:, 0]
        kd = np.asarray(k.dists2)[:, 0]
        agree = float(np.mean(ki == bi))
        diff = np.nonzero(ki != bi)[0]
        # Where the two differ, float64 decides: the kernel's neighbour
        # must be as near as brute force's to 1e-6 relative (a tie) or
        # nearer (brute force's |q|^2 - 2 q.r + |r|^2 cancels at 50 m).
        worse = 0
        if len(diff):
            dk = d2_float64(q[diff], r, ki[diff])
            db = d2_float64(q[diff], r, bi[diff])
            worse = int(np.sum(dk > db * (1 + 1e-6)))
        sub = rng.choice(nq, min(n_sub, nq), replace=False)
        d64, i64 = nn_float64(q[sub], r, rm)
        tie = d2_float64(q[sub], r, ki[sub]) <= d64 * (1 + 1e-6)
        rel = float(np.max(np.abs(kd[sub] / d64 - 1.0)))
        t_k, t_b = median_ms(kernel), median_ms(brute)
        log(f"    ids agree {agree:.6f} ({len(diff)} differ, {worse} of "
            f"them with the kernel's neighbour farther); float64 ids "
            f"{np.mean(ki[sub] == i64):.6f}; max rel dist err {rel:.2e}")
        log(f"    median of 20: kernel {t_k:.3f} ms, brute {t_b:.3f} ms")
        gate(agree >= 0.9999, f"ids agree with brute force {agree:.6f} "
             ">= 0.9999")
        gate(worse == 0, f"differing ids are ties or kernel-nearer "
             f"({worse} worse)")
        gate(bool(tie.all()), "ids match float64 up to 1e-6 ties on "
             f"{len(sub)} queries")
        gate(rel <= 1e-5, f"distances within 1e-5 of float64 ({rel:.2e})")


# --------------------------------------------------------------------------
# Phase 4: pose-graph optimization
# --------------------------------------------------------------------------

def pose_graph(V: int, meas_noise: float, seed: int = 0, lap: int = 64):
    """A robot driving laps of a 64 m ring (1 m per pose, slowly
    climbing): an odometry chain plus V/16 loop closures, each between a
    pose and the same place on a later lap. Measurements carry
    ``meas_noise`` m / ``meas_noise / 10`` rad of noise (with none, the
    optimum is the truth); the initial guess perturbs every pose but the
    anchor by 5 cm / 5 mrad, as a re-optimization after new constraints
    starts near the previous solution."""
    import jax.numpy as jnp
    from pgslam_tpu import se3

    def exp(tw):
        return np.asarray(se3.exp(jnp.asarray(tw, jnp.float32)), np.float64)

    rng = np.random.default_rng(seed)
    k = np.arange(V)
    ang = 2 * np.pi * k / lap
    truth = np.tile(np.eye(4), (V, 1, 1))
    c, s = np.cos(ang + np.pi / 2), np.sin(ang + np.pi / 2)
    truth[:, 0, 0], truth[:, 0, 1] = c, -s
    truth[:, 1, 0], truth[:, 1, 1] = s, c
    truth[:, 0, 3] = lap / (2 * np.pi) * np.cos(ang)
    truth[:, 1, 3] = lap / (2 * np.pi) * np.sin(ang)
    truth[:, 2, 3] = 0.5 * k / lap + 0.2 * np.sin(0.37 * k)
    first = rng.integers(0, V - lap, V // 16)
    laps = 1 + (rng.random(V // 16) * ((V - 1 - first) // lap)).astype(int)
    pairs = [(i, i + 1) for i in range(V - 1)]
    pairs += [(int(i), int(i + lap * n)) for i, n in zip(first, laps)]
    E = len(pairs)
    ef = np.asarray([p[0] for p in pairs], np.int32)
    et = np.asarray([p[1] for p in pairs], np.int32)
    scale = np.array([1.0] * 3 + [0.1] * 3)
    eT = (np.linalg.inv(truth[ef]) @ truth[et]
          @ exp(rng.normal(0, meas_noise, (E, 6)) * scale))
    init = truth @ exp(rng.normal(0, 0.05, (V, 6)) * scale)
    init[0] = truth[0]
    args = (init.astype(np.float32), np.ones(V, bool), ef, et,
            eT.astype(np.float32),
            np.tile(np.eye(6, dtype=np.float32) * 0.01, (E, 1, 1)),
            np.ones(E, bool), np.int32(0))
    return args, truth


def phase_pgo(sizes=(1024, 16384), compare_cpu: bool = True) -> None:
    import jax
    from pgslam_tpu.optim.pgo import PGOConfig, optimize_pose_graph

    cfg = PGOConfig()
    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    for V in sizes:
        compare = compare_cpu and V <= 1024
        # Noisy measurements give the CPU comparison a cost well above
        # fp32 round-off; exact ones make the truth the optimum.
        args, truth = pose_graph(V, meas_noise=0.002 if compare else 0.0)
        log(f"[pgo] optimize_pose_graph, {V} poses, "
            f"{len(args[2])} edges (chain + V/16 lap-revisit loops)")
        dev_args = jax.device_put(args, gpu)
        out, st = jax.device_get(optimize_pose_graph(*dev_args, config=cfg))
        iters = int(st["iterations"])
        t = median_ms(lambda: optimize_pose_graph(*dev_args, config=cfg),
                      n=5)
        err0 = np.linalg.norm(args[0][:, :3, 3] - truth[:, :3, 3], axis=1)
        err = np.linalg.norm(out[:, :3, 3] - truth[:, :3, 3], axis=1)
        log(f"    {iters} LM iterations, {t:.1f} ms per call "
            f"({t / max(iters, 1):.2f} ms per iteration); cost "
            f"{float(st['initial_cost']):.4e} -> "
            f"{float(st['final_cost']):.4e}; translation error vs truth "
            f"rms {np.sqrt(np.mean(err ** 2)):.4f} m, max {err.max():.4f} m"
            f" (initial rms {np.sqrt(np.mean(err0 ** 2)):.2f} m)")
        if compare:
            cpu_args = jax.device_put(args, cpu)
            out_c, st_c = jax.device_get(
                optimize_pose_graph(*cpu_args, config=cfg))
            dc = abs(float(st["final_cost"]) - float(st_c["final_cost"]))
            rel = dc / max(abs(float(st_c["final_cost"])), 1e-30)
            dmax = float(np.max(np.linalg.norm(
                out[:, :3, 3] - out_c[:, :3, 3], axis=1)))
            # Both run at HIGHEST precision; summation order and the
            # inexact CG differ between the two backends.
            gate(rel <= 1e-3, f"final cost within 1e-3 of the CPU run "
                 f"({rel:.2e})")
            gate(dmax < 0.01, f"max translation difference to the CPU run "
                 f"{dmax * 100:.3f} cm < 1 cm")
        else:
            # Error against the truth, locally (consecutive relative
            # poses) and globally.
            def rel(P):
                P = np.asarray(P, np.float64)
                return (np.linalg.inv(P[:-1]) @ P[1:])[:, :3, 3]
            loc = float(np.sqrt(np.mean(np.sum(
                (rel(out) - rel(truth)) ** 2, axis=1))))
            loc0 = float(np.sqrt(np.mean(np.sum(
                (rel(args[0]) - rel(truth)) ** 2, axis=1))))
            rms = float(np.sqrt(np.mean(err ** 2)))
            rms0 = float(np.sqrt(np.mean(err0 ** 2)))
            gate(loc < 1e-3, f"rms relative-pose translation error vs truth "
                 f"{loc * 1e3:.3f} mm < 1 mm (initial {loc0 * 1e3:.1f} mm)")
            gate(rms < 0.01, f"rms translation error vs truth {rms:.4f} m "
                 f"< 0.01 m (initial {rms0:.4f} m)")
            mem = optimize_pose_graph.lower(
                *dev_args, config=cfg).compile().memory_analysis()
            log(f"    memory_analysis: {mem}")


# --------------------------------------------------------------------------
# Four cards: the sharded registration and the multi-device SLAM step
# --------------------------------------------------------------------------

def phase_four_cards(n_points: int = 2048, n_ref: int = 65536,
                     n_agents: int = 8) -> None:
    import jax
    from pgslam_tpu.cloud import Cloud
    from pgslam_tpu.parallel.batched import batched_register
    from pgslam_tpu.parallel.multichip import make_mesh
    from pgslam_tpu.parallel.sharded_icp import make_sharded_register
    sys.path.insert(0, REPO)
    from __graft_entry__ import multichip_trajectory

    for tp in (1, 2):
        mesh = make_mesh(4, tp=tp)
        dp = mesh.shape["dp"]
        log(f"[four-cards] mesh dp={dp} tp={tp}: multichip_slam_step, "
            f"{n_agents} agents, {n_points}-point readings, {n_ref}-point "
            f"reference sharded over tp")
        t0 = time.perf_counter()
        errs, args, cfg = multichip_trajectory(
            mesh, n_points=n_points, n_ref=n_ref, n_agents=n_agents)
        log(f"    10-scan trajectory in {time.perf_counter() - t0:.1f} s; "
            f"max final-pose error {max(errs) * 100:.2f} cm")
        gate(max(errs) < 0.05, f"final-pose error {max(errs):.4f} m < 0.05 m")
        # Compare the sharded registration with the single-card vmapped
        # one on the first scan's inputs.
        r_pts, r_mask, f_pts, f_mask, f_nrm, T0 = args[:6]
        reading = Cloud(points=r_pts, mask=r_mask, descriptors={})
        reference = Cloud(points=f_pts, mask=f_mask,
                          descriptors={"normals": f_nrm})
        sharded = make_sharded_register(mesh, cfg)(reading, reference, T0)
        one = jax.devices()[0]
        single = batched_register(
            jax.device_put(reading, one), jax.device_put(reference, one),
            jax.device_put(T0, one), cfg)
        dT = float(np.max(np.abs(np.asarray(sharded.T)
                                 - np.asarray(single.T))))
        gate(dT <= 1e-4, f"sharded vs single-card transforms {dT:.2e} "
             "<= 1e-4")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the four-card sharded phase")
    opts = parser.parse_args()
    count = 4 if opts.four_cards else 1
    devices = require_gpus(count)

    sys.path.insert(0, REPO)
    from pgslam_tpu.utils.compile_cache import enable_compile_cache
    log(f"compile cache: {enable_compile_cache()}")
    log(f"devices: {devices[:count]}")
    t_all = time.perf_counter()
    phases = ((phase_four_cards,) if opts.four_cards
              else (phase_slam, phase_fleet, phase_knn, phase_pgo))
    for phase in phases:
        t0 = time.perf_counter()
        phase()
        log(f"    ({phase.__name__} took {time.perf_counter() - t0:.1f} s)")
    fallbacks = fallback_counts()
    gate(not any(fallbacks.values()), f"no fallbacks taken {fallbacks}")
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    log(card_info())
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": count}}), flush=True)


if __name__ == "__main__":
    main()
