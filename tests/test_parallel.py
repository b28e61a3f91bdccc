"""Multi-device tests on the 8-device virtual CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pgslam_tpu import se3
from pgslam_tpu.cloud import make_cloud, stack_clouds
from pgslam_tpu.ops import outlier as O
from pgslam_tpu.ops.icp import ICPConfig
from pgslam_tpu.parallel.batched import batched_register, shard_batch
from pgslam_tpu.parallel.multichip import make_mesh, sharded_icp_step


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_batched_register_recovers(rng):
    B, N = 4, 256
    cfg = ICPConfig(max_iterations=30,
                    outlier=(O.TrimmedDist(0.95), O.MaxDist(1.0)))
    refs, readings, times = [], [], []
    twists = rng.normal(size=(B, 6)).astype(np.float32) * 0.05
    for b in range(B):
        pts = rng.uniform(-3, 3, size=(N, 3)).astype(np.float32)
        pts[:, 2] = np.sign(pts[:, 2])  # two planes + jitter for constraint
        pts = pts + rng.normal(size=(N, 3)).astype(np.float32) * 0.05
        refs.append(make_cloud(pts, capacity=N))
        T = se3.exp(jnp.asarray(twists[b]))
        readings.append(make_cloud(
            np.asarray(se3.apply(se3.inverse(T), jnp.asarray(pts))),
            capacity=N))
    readings = stack_clouds(readings)
    refs = stack_clouds(refs)
    T0 = jnp.tile(jnp.eye(4), (B, 1, 1))
    res = batched_register(readings, refs, T0, cfg)
    assert res.T.shape == (B, 4, 4)
    for b in range(B):
        err = np.asarray(se3.log(se3.inverse(res.T[b])
                                 @ se3.exp(jnp.asarray(twists[b]))))
        assert np.linalg.norm(err) < 5e-2, f"agent {b}: {err}"


def test_batched_register_sharded(rng):
    devs = np.empty(8, dtype=object)
    for i, d in enumerate(jax.devices()):
        devs[i] = d
    mesh = jax.sharding.Mesh(devs, ("dp",))
    B, N = 8, 128
    pts = rng.uniform(-2, 2, size=(B, N, 3)).astype(np.float32)
    clouds = jax.tree_util.tree_map(
        jnp.asarray,
        stack_clouds([make_cloud(pts[b], capacity=N) for b in range(B)]))
    put = shard_batch(mesh)
    readings = put(clouds)
    refs = put(clouds)
    T0 = jnp.tile(jnp.eye(4), (B, 1, 1))
    cfg = ICPConfig(max_iterations=3)
    res = batched_register(readings, refs, T0, cfg)
    # identical clouds -> identity transforms
    np.testing.assert_allclose(np.asarray(res.T),
                               np.tile(np.eye(4), (B, 1, 1)), atol=1e-3)


def test_sharded_icp_step_matches_single_device(rng):
    mesh = make_mesh(8, tp=2)  # dp=4, tp=2
    B, N, M = 8, 64, 256
    cfg = ICPConfig(outlier=(O.TrimmedDist(0.9), O.MaxDist(1.0)))
    step = sharded_icp_step(mesh, cfg)
    ref = rng.uniform(-3, 3, size=(B, M, 3)).astype(np.float32)
    reading = ref[:, :N] + 0.05
    T0 = jnp.tile(jnp.eye(4), (B, 1, 1))
    T_new, overlaps = step(jnp.asarray(reading), jnp.ones((B, N), bool),
                           jnp.asarray(ref), jnp.ones((B, M), bool), T0)
    assert T_new.shape == (B, 4, 4)
    assert np.all(np.isfinite(np.asarray(T_new)))
    assert np.all(np.asarray(overlaps) > 0.5)
    # Cross-check one agent against a host-side single-device solve.
    from pgslam_tpu.ops.knn import knn_brute_force
    from pgslam_tpu.ops import minimizer as MM
    m = knn_brute_force(jnp.asarray(reading[0]), jnp.ones(N, bool),
                        jnp.asarray(ref[0]), jnp.ones(M, bool), k=1)
    w = O.compute_weights(cfg.outlier, m, jnp.ones(N, bool))
    elems = MM.ErrorElements(
        reading=jnp.asarray(reading[0]),
        reference=jnp.take(jnp.asarray(ref[0]), m.ids[:, 0], axis=0),
        weights=w[:, 0])
    delta = MM.point_to_point(elems)
    np.testing.assert_allclose(np.asarray(T_new[0]), np.asarray(delta),
                               atol=1e-4)


@pytest.mark.slow
def test_dryrun_multichip_entrypoint():
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)


def test_sharded_icp_ring_matches_all_gather(rng):
    mesh = make_mesh(8, tp=2)
    B, N, M = 8, 64, 256
    cfg = ICPConfig(outlier=(O.TrimmedDist(0.9), O.MaxDist(1.0)))
    ref = rng.uniform(-3, 3, size=(B, M, 3)).astype(np.float32)
    reading = ref[:, :N] + 0.05
    args = (jnp.asarray(reading), jnp.ones((B, N), bool),
            jnp.asarray(ref), jnp.ones((B, M), bool),
            jnp.tile(jnp.eye(4), (B, 1, 1)))
    T_ag, ov_ag = sharded_icp_step(mesh, cfg, merge="all_gather")(*args)
    T_ring, ov_ring = sharded_icp_step(mesh, cfg, merge="ring")(*args)
    np.testing.assert_allclose(np.asarray(T_ring), np.asarray(T_ag),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(ov_ring), np.asarray(ov_ag),
                               atol=1e-5)


def test_sharded_register_matches_vmapped(rng):
    """Full sharded registration (dp=4, tp=2) must reproduce the plain
    vmapped icp_core results: transforms, overlap, convergence flags."""
    from pgslam_tpu.parallel.sharded_icp import make_sharded_register

    mesh = make_mesh(8, tp=2)
    B, N, Mref = 4, 128, 512
    cfg = ICPConfig(error="point_to_plane", max_iterations=20,
                    outlier=(O.TrimmedDist(0.9), O.MaxDist(1.0)))
    refs, readings = [], []
    twists = rng.normal(size=(B, 6)).astype(np.float32) * 0.03
    from pgslam_tpu.ops.filters import compute_normals
    for b in range(B):
        pts = rng.uniform(-3, 3, size=(Mref, 3)).astype(np.float32)
        pts[:, 2] = 0.3 * np.sin(pts[:, 0]) + 0.2 * np.cos(1.3 * pts[:, 1])
        ref = compute_normals(make_cloud(pts, capacity=Mref), knn=8)
        refs.append(ref)
        T = se3.exp(jnp.asarray(twists[b]))
        # Noisy reading subset: well-separated residual distances keep the
        # trimmed-filter boundary stable across the two paths (a noiseless
        # subset leaves d^2 at fp32-cancellation scale, where the trim
        # threshold is a coin flip on ties).
        noisy = pts[:N] + rng.normal(0, 0.02, (N, 3)).astype(np.float32)
        readings.append(make_cloud(
            np.asarray(se3.apply(se3.inverse(T), jnp.asarray(noisy))),
            capacity=N))
    readings_s = stack_clouds(readings)
    refs_s = stack_clouds(refs)
    T0 = jnp.tile(jnp.eye(4), (B, 1, 1))

    plain = batched_register(readings_s, refs_s, T0, cfg)
    reg = make_sharded_register(mesh, cfg)
    sharded = reg(readings_s, refs_s, T0)

    assert sharded.T.shape == (B, 4, 4)
    # Iteration schedules differ (plain vmap runs all agents until the
    # last converges; sharded converges per device sub-batch), so compare
    # to tight-but-not-bitwise tolerances.
    np.testing.assert_allclose(np.asarray(sharded.T), np.asarray(plain.T),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(sharded.overlap),
                               np.asarray(plain.overlap), atol=0.02)
    # And the registrations actually recover the ground-truth offsets.
    for b in range(B):
        err = np.asarray(se3.log(se3.inverse(sharded.T[b])
                                 @ se3.exp(jnp.asarray(twists[b]))))
        assert np.linalg.norm(err) < 3e-2, f"agent {b}: {err}"


@pytest.mark.parametrize("dp,tp", [(4, 1), (2, 2), (1, 4)])
def test_mesh_layout_and_register(rng, dp, tp):
    """(dp, tp) meshes over 4 devices: consecutive devices form a tp
    group, every device appears once, and the full sharded registration
    runs unchanged on each layout."""
    mesh = make_mesh(4, tp=tp)
    assert dict(mesh.shape) == {"dp": dp, "tp": tp}
    np.testing.assert_array_equal(
        mesh.devices.reshape(-1), np.array(jax.devices()[:4], dtype=object))
    with pytest.raises(ValueError):
        make_mesh(4, tp=3)

    from pgslam_tpu.parallel.sharded_icp import make_sharded_register

    B, N, Mref = 4, 64, 256
    cfg = ICPConfig(max_iterations=10,
                    outlier=(O.TrimmedDist(0.9), O.MaxDist(1.0)))
    pts = rng.uniform(-3, 3, size=(B, Mref, 3)).astype(np.float32)
    refs = stack_clouds([make_cloud(pts[b], capacity=Mref)
                         for b in range(B)])
    readings = stack_clouds([make_cloud(pts[b, :N] + 0.02, capacity=N)
                             for b in range(B)])
    T0 = jnp.tile(jnp.eye(4), (B, 1, 1))
    res = make_sharded_register(mesh, cfg)(readings, refs, T0)
    plain = batched_register(readings, refs, T0, cfg)
    assert res.T.shape == (B, 4, 4)
    np.testing.assert_allclose(np.asarray(res.T), np.asarray(plain.T),
                               atol=1e-4)


def test_prefetch_clouds_equivalence(rng):
    """Double-buffered transfers must be a pure latency optimization:
    identical Clouds, correct order, works for short iterables."""
    from pgslam_tpu.utils.prefetch import prefetch_clouds

    scans = [rng.uniform(-5, 5, (100 + 10 * i, 3)).astype(np.float32)
             for i in range(5)]
    direct = [make_cloud(s, capacity=256) for s in scans]
    fetched = list(prefetch_clouds(scans, capacity=256, depth=2))
    assert len(fetched) == 5
    for d, f in zip(direct, fetched):
        np.testing.assert_array_equal(np.asarray(d.points),
                                      np.asarray(f.points))
        np.testing.assert_array_equal(np.asarray(d.mask), np.asarray(f.mask))
    # depth larger than the sequence
    assert len(list(prefetch_clouds(scans[:1], capacity=256, depth=4))) == 1
