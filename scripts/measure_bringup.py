"""Bring-up measurements on the GPU: what the XLA paths and the matcher
kernel cost at the shapes the SLAM loop uses.

    python scripts/measure_bringup.py [--out DIR] [slam40] [batched] [pgo]
                                      [fleet]

* ``slam40``  — the first 40 scans of chip_smoke's ring drive (65,536
  points per scan) through ``PoseGraphSlam``, with ``matcher="pallas"``
  and ``"brute"``, in turns (pallas, brute, brute, pallas), after one
  warm-up run of each; ms per scan.
* ``batched`` — ``batched_register`` at B=128 (bench.py's batched ICP
  profile: 1,024-point readings against 8,192-point prepared maps) with
  the matcher kernel and with brute force, in turns, median of 10 calls
  each; then a profiler trace of 3 calls of each: device busy time, the
  matcher kernel's share, and the gaps between launches.
* ``pgo``     — ``optimize_pose_graph`` at 1,024 and 16,384 poses under
  ``assembly="auto"`` (segment_sum) and ``"incidence"``: ms per call and
  per LM iteration.
* ``fleet``   — chip_smoke's 16-agent ``MultiAgentSlam`` drive (24 steps)
  with ``matcher="pallas"`` and ``"brute"``, in turns after one warm-up
  run of each: median step time over the second half, and the agents'
  errors; then the matcher alone under ``vmap`` at the fleet's shapes
  (16 x 768 readings and 16 x 512 keyframes against 3-keyframe local
  maps of 1,536 points), kernel against brute force, median of 20 (on
  the GPU only).

Prints one line per measurement and writes them as JSON to
``DIR/bringup.json`` (default ``<repo>/bringup_out``); traces go to
``DIR/trace/``.
"""

import dataclasses
import glob
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pgslam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

OUT = os.path.join(REPO, "bringup_out")
RESULTS = {}


def emit(name, **kv):
    RESULTS[name] = kv
    print(json.dumps({"measure": name, **kv}), flush=True)


def median_ms(fn, n):
    jax.block_until_ready(fn())
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3, [t * 1e3 for t in times]


def slam40(n_scans=40, n_points=65536):
    import chip_smoke
    from pgslam_tpu import PoseGraphSlam
    from pgslam_tpu.datasets import loop_sequence
    scans, odom, truth = loop_sequence(
        np.random.default_rng(3), n_scans=n_scans, scan_points=n_points,
        radius=12.0, max_range=8.0, noise=0.002, odom_drift=0.002,
        world_points=300_000)
    base = chip_smoke.slam_config(n_points)

    def config(matcher):
        def with_matcher(icp):
            return dataclasses.replace(icp, matcher=matcher)
        return dataclasses.replace(
            base,
            localizer=dataclasses.replace(
                base.localizer, icp=with_matcher(base.localizer.icp)),
            loop_closer=dataclasses.replace(
                base.loop_closer, icp=with_matcher(base.loop_closer.icp)))

    def run(matcher):
        slam = PoseGraphSlam(config(matcher))
        T_rs = np.eye(4, dtype=np.float32)
        t0 = time.perf_counter()
        for i in range(n_scans):
            slam.add_data(i, "world", odom[i], T_rs, scans[i])
        dt = (time.perf_counter() - t0) / n_scans * 1e3
        err = float(np.linalg.norm(slam.T_world_robot[:3, 3]
                                   - truth[n_scans - 1][:3, 3]))
        return dt, err

    for m in ("pallas", "brute"):
        dt, err = run(m)
        emit(f"slam40_warmup_{m}", ms_per_scan=dt, final_err_m=err)
    for i, m in enumerate(("pallas", "brute", "brute", "pallas")):
        dt, err = run(m)
        emit(f"slam40_{m}_{i}", ms_per_scan=dt, final_err_m=err)


def trace_summary(logdir, kernel_name="nn_pallas"):
    """Device busy time, matcher kernel time and the gaps between
    launches, from the GPU plane of an xplane trace."""
    path = sorted(glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    prof = jax.profiler.ProfileData.from_file(path)
    events = []
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU:0"):
            continue
        for line in plane.lines:
            for ev in line.events:
                events.append((ev.start_ns, ev.end_ns, ev.name, line.name))
    if not events:
        return {"planes": [p.name for p in prof.planes]}
    # Keep the kernel lines (streams), not the per-op annotation lines.
    lines = {}
    for e in events:
        lines.setdefault(e[3], []).append(e)
    kernel_lines = [ln for ln in lines if "Stream" in ln] or list(lines)
    evs = sorted(e for ln in kernel_lines for e in lines[ln])
    busy, gaps, cur_s, cur_e = 0, [], evs[0][0], evs[0][1]
    for s, e, _, _ in evs[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append(s - cur_e)
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = evs[-1][1] - evs[0][0]
    kern = sum(e - s for s, e, n, _ in evs if kernel_name in n)
    by_name = {}
    for s, e, n, _ in evs:
        by_name[n] = by_name.get(n, 0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    gaps = np.asarray(gaps, np.float64)
    return {"window_ms": window / 1e6, "busy_ms": busy / 1e6,
            "idle_share": 1 - busy / window, "kernel_ms": kern / 1e6,
            "kernel_share_of_busy": kern / max(busy, 1),
            "n_launches": len(evs), "n_gaps": int(len(gaps)),
            "gap_total_ms": float(gaps.sum() / 1e6),
            "gap_median_us": float(np.median(gaps) / 1e3) if len(gaps)
            else 0.0,
            "lines": kernel_lines,
            "top_ops_ms": [(n[:80], t / 1e6) for n, t in top]}


def batched(B=128, n_points=65536):
    import bench
    from pgslam_tpu.cloud import make_cloud, stack_clouds
    from pgslam_tpu.datasets import render_scan
    from pgslam_tpu.ops.icp import ICPEngine
    from pgslam_tpu.parallel.batched import batched_register

    cfg = bench.batched_icp_config()
    world = bench._render_world()
    rng = np.random.default_rng(0)
    scan = bench.FIXTURE_PARAMS["scan"]
    eng = ICPEngine(cfg)
    refs = stack_clouds([eng.prepare_reference(make_cloud(
        render_scan(world, bench._agent_pose(b), rng, n_points, **scan),
        capacity=n_points)) for b in range(B)])
    offs = bench._np_se3_exp(rng.normal(size=(B, 6))
                             * bench.FIXTURE_PARAMS["twist_scales"])
    reads = []
    for b in range(B):
        raw = render_scan(world, bench._agent_pose(b), rng, n_points,
                          **scan)
        inv = np.linalg.inv(offs[b])
        rr = (raw @ inv[:3, :3].T + inv[:3, 3])[::n_points // 1024]
        reads.append(make_cloud(rr.astype(np.float32), capacity=1024))
    readings = stack_clouds(reads)
    T0 = jnp.tile(jnp.eye(4, dtype=jnp.float32), (B, 1, 1))

    cfg_brute = dataclasses.replace(cfg, matcher="brute")
    for matcher, c in (("pallas", cfg), ("brute", cfg_brute),
                       ("brute", cfg_brute), ("pallas", cfg)):
        def call(c=c):
            return batched_register(readings, refs, T0, c)

        res = jax.device_get(call())
        err = np.linalg.norm(np.asarray(res.T)[:, :3, 3] - offs[:, :3, 3],
                             axis=1)
        ms, all_ms = median_ms(call, 10)
        emit(f"batched_B{B}_{matcher}", ms_per_call=ms,
             regs_per_s=B / ms * 1e3, calls_ms=all_ms,
             iterations_max=int(np.max(res.iterations)),
             err_m_q50=float(np.median(err)), err_m_max=float(err.max()))
    for matcher, c in (("pallas", cfg), ("brute", cfg_brute)):
        logdir = os.path.join(OUT, "trace", f"batched_B{B}_{matcher}")
        with jax.profiler.trace(logdir):
            for _ in range(3):
                jax.block_until_ready(batched_register(readings, refs, T0,
                                                       c))
        emit(f"batched_B{B}_{matcher}_trace", **trace_summary(logdir))


def pgo(sizes=(1024, 16384)):
    import chip_smoke
    from pgslam_tpu.optim.pgo import PGOConfig, optimize_pose_graph
    for V in sizes:
        args, _ = chip_smoke.pose_graph(V, meas_noise=0.0)
        dev = jax.device_put(args)
        for assembly in ("auto", "incidence"):
            cfg = PGOConfig(assembly=assembly)
            _, st = jax.device_get(optimize_pose_graph(*dev, config=cfg))
            ms, all_ms = median_ms(
                lambda: optimize_pose_graph(*dev, config=cfg), 5)
            it = int(st["iterations"])
            emit(f"pgo_V{V}_{assembly}", ms_per_call=ms,
                 lm_iterations=it, ms_per_iteration=ms / max(it, 1),
                 calls_ms=all_ms, final_cost=float(st["final_cost"]))


def fleet(n_agents=16, n_steps=24):
    import chip_smoke
    from pgslam_tpu.ops.knn import knn_brute_force
    from pgslam_tpu.ops.knn_pallas import nn_pallas, use_kernel
    for i, m in enumerate(("pallas", "brute", "pallas", "brute", "brute",
                           "pallas")):
        steps, errs, verified, n_kf = chip_smoke.run_fleet(m, n_agents,
                                                           n_steps)
        tag = f"warmup_{m}" if i < 2 else f"{m}_{i - 2}"
        emit(f"fleet_{tag}",
             ms_per_step_q50=float(np.median(steps[n_steps // 2:])) * 1e3,
             steps_ms=[t * 1e3 for t in steps], err_m_max=max(errs),
             verified=verified, keyframes=n_kf)
    if not use_kernel(jax.default_backend()):
        return
    rng = np.random.default_rng(0)
    for nq, nr in ((768, 1536), (512, 1536)):
        r = rng.uniform(-10, 10, (n_agents, nr, 3)).astype(np.float32)
        q = (r[:, :nq] + rng.normal(0, 0.05, (n_agents, nq, 3))).astype(
            np.float32)
        qd, rd = jnp.asarray(q), jnp.asarray(r)
        qm = jnp.ones((n_agents, nq), bool)
        rm = jnp.ones((n_agents, nr), bool)
        kern = jax.jit(jax.vmap(nn_pallas))
        brute = jax.jit(jax.vmap(knn_brute_force))
        for name, f in (("pallas", kern), ("brute", brute),
                        ("brute", brute), ("pallas", kern)):
            ms, _ = median_ms(lambda f=f: f(qd, qm, rd, rm), 20)
            emit(f"fleet_knn_B{n_agents}_{nq}x{nr}_{name}", ms=ms)


def main():
    global OUT
    args = sys.argv[1:]
    if args[:1] == ["--out"]:
        OUT, args = os.path.abspath(args[1]), args[2:]
    enable_compile_cache()
    os.makedirs(OUT, exist_ok=True)
    d = jax.devices()[0]
    print(f"device: {d.platform} {d.device_kind} x{len(jax.devices())}",
          flush=True)
    want = args or ["slam40", "batched", "pgo", "fleet"]
    for name in want:
        {"slam40": slam40, "batched": batched, "pgo": pgo,
         "fleet": fleet}[name]()
    with open(os.path.join(OUT, "bringup.json"), "w") as fh:
        json.dump({"device": d.device_kind, "results": RESULTS}, fh,
                  indent=1)


if __name__ == "__main__":
    main()
