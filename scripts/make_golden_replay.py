"""Record the golden-replay fixture: the single-threaded facade's
trajectory over the canonical loop sequence (tests/golden_replay.py).

Run on the CPU backend (same backend the test tier uses):
    python scripts/make_golden_replay.py
Writes tests/fixtures/golden_replay.npz. Commit the result.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))

import jax

jax.config.update("jax_platforms", "cpu")

from pgslam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402

from golden_replay import (FIXTURE, FIXTURE_64K, FIXTURE_LONG,  # noqa: E402
                           run_st_replay, run_st_replay_64k,
                           run_st_replay_long)


def _write(path, per_scan, trajectory, stats):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, per_scan_poses=per_scan,
                        trajectory=trajectory,
                        n_loop_edges=np.int32(stats["n_loops"]),
                        n_keyframes=np.int32(stats["n_keyframes"]),
                        n_swaps=np.int32(stats["n_swaps"]),
                        opt_runs=np.int32(stats["opt_runs"]))
    print(f"wrote {path}: {per_scan.shape[0]} scans, "
          f"{trajectory.shape[0]} keyframes, {stats['n_loops']} loop "
          f"edges, {stats['n_swaps']} swaps, {stats['opt_runs']} "
          f"optimizer runs")


def main():
    assert jax.default_backend() == "cpu", jax.devices()
    which = set(sys.argv[1:]) or {"short", "long", "64k"}
    if "short" in which:
        per_scan, trajectory, n_loops = run_st_replay()
        os.makedirs(os.path.dirname(FIXTURE), exist_ok=True)
        np.savez_compressed(FIXTURE, per_scan_poses=per_scan,
                            trajectory=trajectory,
                            n_loop_edges=np.int32(n_loops))
        print(f"wrote {FIXTURE}: {per_scan.shape[0]} scans, "
              f"{trajectory.shape[0]} keyframes, {n_loops} loop edges")
    if "long" in which:
        _write(FIXTURE_LONG, *run_st_replay_long())
    if "64k" in which:
        _write(FIXTURE_64K, *run_st_replay_64k())


if __name__ == "__main__":
    main()
