"""Pre-generate bench.py's fixture cache (stage A + stage B) on the CPU
backend, so the next bench run on the card starts directly at the timed
phases instead of spending its budget on 1,100+ raycast renders +
one-time reference prep.

Run:  JAX_PLATFORMS=cpu python scripts/make_bench_cache.py

Stage B (the prepared per-agent reference working sets) is computed with
the same jitted prep chain the bench uses; CPU-vs-GPU float differences
are sub-mm and irrelevant at the benchmark's 0.2 m accuracy gate (the
references are fixtures — production rebuilds maps per keyframe on
device).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

from pgslam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402

import bench  # noqa: E402


def main():
    assert not bench.SMOKE, "run without PGSLAM_BENCH_SMOKE"
    print(f"backend: {jax.devices()}", flush=True)

    if os.path.exists(bench._STAGE_A_PATH):
        print(f"stage A already present: {bench._STAGE_A_PATH}")
        fixA = bench._load_npz(bench._STAGE_A_PATH, bench._STAGE_A_KEYS)
    else:
        t0 = time.perf_counter()
        fixA = bench.generate_stage_a()
        print(f"stage A rendered in {time.perf_counter()-t0:.1f} s")
        bench._save_npz(bench._STAGE_A_PATH, fixA)
    assert fixA is not None

    if os.path.exists(bench._STAGE_B_PATH):
        print(f"stage B already present: {bench._STAGE_B_PATH}")
        return
    from pgslam_tpu.cloud import make_cloud, stack_clouds
    from pgslam_tpu.datasets import render_scan
    from pgslam_tpu.ops.icp import ICPEngine

    eng_b = ICPEngine(bench.batched_icp_config())
    world = bench._render_world()
    t0 = time.perf_counter()
    prepped = []
    s0 = bench.FIXTURE_PARAMS["seeds"]["map0"]
    for b in range(bench.BATCH):
        raw = render_scan(world, bench._agent_pose(b),
                          np.random.default_rng(s0 + b), bench.NPTS,
                          **bench.FIXTURE_PARAMS["scan"])
        prepped.append(eng_b.prepare_reference(
            make_cloud(raw, capacity=bench.NPTS)))
        if b % 16 == 0:
            print(f"  prepped map {b}/{bench.BATCH} "
                  f"({time.perf_counter()-t0:.1f} s)", flush=True)
    refs = stack_clouds(prepped)
    jax.block_until_ready(refs.points)
    print(f"stage B prepped in {time.perf_counter()-t0:.1f} s")
    pay = {"points": np.asarray(refs.points), "mask": np.asarray(refs.mask)}
    pay.update({f"desc_{k}": np.asarray(v)
                for k, v in refs.descriptors.items()})
    bench._save_npz(bench._STAGE_B_PATH, pay)


if __name__ == "__main__":
    main()
