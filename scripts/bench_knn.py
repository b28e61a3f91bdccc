"""Micro-benchmark + correctness check of the matcher paths on the
current backend. On the GPU it times the Pallas kernel too; on the CPU
the kernel is skipped (it runs there only in the interpreter).

    python scripts/bench_knn.py
"""
import os
import sys
import time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from pgslam_tpu.ops.knn import knn_brute_force
from pgslam_tpu.ops.knn_pallas import nn_pallas, use_kernel
from pgslam_tpu.ops.gridknn import build_grid_index, grid_knn
from pgslam_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()
print("backend:", jax.devices())
KERNEL = use_kernel(jax.default_backend())
rng = np.random.default_rng(0)


def timeit(fn, *args, reps=10):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps, out


# correctness at small size
q = jnp.asarray(rng.uniform(0, 10, (2048, 3)).astype(np.float32))
r = jnp.asarray(rng.uniform(0, 10, (4096, 3)).astype(np.float32))
qm = jnp.ones(2048, bool)
rm = jnp.asarray(np.arange(4096) % 7 != 0)   # some masked refs
b = knn_brute_force(q, qm, r, rm, k=1)
p = nn_pallas(q, qm, r, rm, interpret=not KERNEL)
ids_match = np.mean(np.asarray(b.ids[:, 0]) == np.asarray(p.ids[:, 0]))
d_close = np.allclose(np.asarray(b.dists2), np.asarray(p.dists2),
                      rtol=1e-3, atol=1e-4)
print(f"pallas vs brute: ids match {ids_match:.4f}, dists close {d_close}")
assert ids_match > 0.999, "pallas kernel disagrees with brute force"

# masked query check
qm2 = qm.at[5].set(False)
p2 = nn_pallas(q, qm2, r, rm, interpret=not KERNEL)
assert not np.isfinite(np.asarray(p2.dists2)[5, 0])

for nq, nr in [(16384, 16384), (65536, 65536), (65536, 196608)]:
    Q = jnp.asarray(rng.uniform(0, 50, (nq, 3)).astype(np.float32))
    R = jnp.asarray(rng.uniform(0, 50, (nr, 3)).astype(np.float32))
    QM = jnp.ones(nq, bool)
    RM = jnp.ones(nr, bool)
    if KERNEL:
        dt, _ = timeit(lambda: nn_pallas(Q, QM, R, RM))
        print(f"pallas  {nq}x{nr}: {dt*1e3:8.2f} ms")
    if nq <= 16384:
        dt, _ = timeit(lambda: knn_brute_force(Q, QM, R, RM, k=1,
                                               tile_ref=2048))
        print(f"brute   {nq}x{nr}: {dt*1e3:8.2f} ms")
    idx = build_grid_index(R, RM, cell_size=1.0, bucket_cap=8)
    jax.block_until_ready(idx.table)
    dt, _ = timeit(lambda: grid_knn(Q, QM, idx, k=1))
    print(f"grid    {nq}x{nr}: {dt*1e3:8.2f} ms")
