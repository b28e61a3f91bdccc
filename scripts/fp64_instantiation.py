"""Double-precision instantiation drive: se3 + ICP + PGO in fp64.

The reference is templated over the scalar type and its only test
instantiates BOTH `PoseGraphSlam<float>` and `PoseGraphSlam<double>`
(src/pgslam/PoseGraphSlam.h:67-68, tests/instantiation.cpp:4-20 in the
reference). This framework is fp32-first on the device path (PARITY.md "Precision"), but the core
numerics (se3, exact-matcher ICP, XLA-path PGO) are dtype-generic: this
script instantiates them in fp64 on the CPU backend and checks they
converge to fp64-level accuracy. Run standalone or via
tests/test_fp64_instantiation.py (subprocess: jax_enable_x64 is a
process-global flag and must not leak into the fp32 test process).

Prints one `FP64-OK <metric>=<value>` line per check; exits non-zero on
any tolerance breach.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["JAX_ENABLE_X64"] = "1"

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from pgslam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp
import numpy as np

from pgslam_tpu import se3
from pgslam_tpu.cloud import make_cloud
from pgslam_tpu.optim.pgo import PGOConfig, optimize_pose_graph
from pgslam_tpu.ops import outlier as O
from pgslam_tpu.ops.icp import ICPConfig, icp


def check(name, value, tol):
    ok = value < tol
    print(f"{'FP64-OK' if ok else 'FP64-FAIL'} {name}={value:.3e} "
          f"(tol {tol:.0e})", flush=True)
    return ok


def main():
    rng = np.random.default_rng(7)
    ok = True

    # --- se3 exp/log round-trip at fp64 resolution -------------------
    xi = jnp.asarray(rng.normal(size=(64, 6)) * 0.5, dtype=jnp.float64)
    T = jax.vmap(se3.exp)(xi)
    assert T.dtype == jnp.float64, T.dtype
    back = jax.vmap(se3.log)(T)
    ok &= check("se3_roundtrip_err", float(jnp.abs(back - xi).max()), 1e-12)

    # --- exact-matcher point-to-point ICP, fp64 clouds ---------------
    pts = rng.normal(size=(256, 3)) * np.array([5.0, 5.0, 1.0])
    T_gt = np.asarray(se3.exp(jnp.asarray(
        [0.05, -0.03, 0.01, 0.005, -0.002, 0.01], dtype=jnp.float64)))
    moved = pts @ T_gt[:3, :3].T + T_gt[:3, 3]
    c_read = make_cloud(pts, capacity=256, dtype=jnp.float64)
    c_ref = make_cloud(moved, capacity=256, dtype=jnp.float64)
    res = icp(c_read, c_ref, jnp.eye(4, dtype=jnp.float64),
              ICPConfig(error="point_to_point", matcher="exact",
                        outlier=(O.TrimmedDist(0.9),), max_iterations=20))
    assert res.T.dtype == jnp.float64, res.T.dtype
    icp_err = float(jnp.linalg.norm(
        se3.log(se3.inverse(res.T) @ jnp.asarray(T_gt))))
    ok &= check("icp_exact_recovery_err", icp_err, 1e-10)

    # --- pose-graph LM on a noisy ring, fp64 -------------------------
    V = 16
    angles = np.linspace(0, 2 * np.pi, V, endpoint=False)
    gt = np.tile(np.eye(4), (V, 1, 1))
    gt[:, 0, 3] = np.cos(angles) * 5.0
    gt[:, 1, 3] = np.sin(angles) * 5.0
    init = gt.copy()
    init[1:, :3, 3] += rng.normal(size=(V - 1, 3)) * 0.1
    ei = np.arange(V, dtype=np.int32)
    ej = ((np.arange(V) + 1) % V).astype(np.int32)
    rel = np.stack([np.linalg.inv(gt[i]) @ gt[j] for i, j in zip(ei, ej)])
    cov = np.tile(np.eye(6) * 1e-4, (V, 1, 1))
    out, stats = optimize_pose_graph(
        jnp.asarray(init), jnp.ones(V, bool), jnp.asarray(ei),
        jnp.asarray(ej), jnp.asarray(rel), jnp.asarray(cov),
        jnp.ones(V, bool), jnp.asarray(0, jnp.int32),
        config=PGOConfig(max_iterations=10))
    assert out.dtype == jnp.float64, out.dtype
    ok &= check("pgo_final_cost", float(stats["final_cost"]), 1e-15)
    ok &= check("pgo_pose_err_vs_gt", float(np.abs(np.asarray(out) - gt).max()),
                1e-9)

    print("FP64 INSTANTIATION " + ("PASSED" if ok else "FAILED"), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
