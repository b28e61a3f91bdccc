"""Double-precision instantiation, mirroring the reference's dual
`PoseGraphSlam<float>` / `PoseGraphSlam<double>` instantiation test
(reference tests/instantiation.cpp:4-20).

jax_enable_x64 is process-global, so the fp64 drive runs in a fresh
subprocess (scripts/fp64_instantiation.py) to keep this test process
fp32 — the same isolation the reference gets for free from C++
templates."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_fp64_instantiation():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "fp64_instantiation.py")],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, (
        f"fp64 instantiation failed:\n{proc.stdout}\n{proc.stderr}")
    assert "FP64 INSTANTIATION PASSED" in proc.stdout, proc.stdout
