"""Native C++ graph core: build, load, and cross-check against the pure
Python implementation."""

import numpy as np
import pytest

from pgslam_tpu.native import (native_available, native_components,
                               native_dijkstra)
from pgslam_tpu.graph import shortest_path as sp


def _py_dijkstra(n, ef, et, w, s, **kw):
    """Force the pure-Python path for comparison."""
    adj = sp._adjacency(n, ef, et, w, kw.get("vertex_ok"), kw.get("edge_ok"))
    import heapq
    dist = np.full(n, np.inf, np.float32)
    done = np.zeros(n, bool)
    dist[s] = 0
    heap = [(0.0, s)]
    settled = []
    while heap:
        d, u = heapq.heappop(heap)
        if done[u]:
            continue
        done[u] = True
        settled.append(u)
        ms = kw.get("max_settled")
        if ms is not None and len(settled) >= ms:
            break
        for v, ww in adj[u]:
            nd = d + ww
            if nd < dist[v]:
                dist[v] = nd
                heapq.heappush(heap, (nd, v))
    return dist, settled


def random_graph(rng, n=50, extra=60):
    ef = list(range(n - 1))
    et = list(range(1, n))
    for _ in range(extra):
        a, b = rng.integers(0, n, 2)
        if a != b:
            ef.append(int(a))
            et.append(int(b))
    w = rng.uniform(0.1, 5.0, len(ef)).astype(np.float32)
    return (np.asarray(ef, np.int32), np.asarray(et, np.int32), w)


def test_native_builds():
    assert native_available(), "C++ graph core failed to build/load"


def test_native_matches_python(rng):
    n = 50
    ef, et, w = random_graph(rng, n)
    for src in [0, 10, 49]:
        nd, ns = native_dijkstra(n, ef, et, w, src)
        pd, ps = _py_dijkstra(n, ef, et, w, src)
        np.testing.assert_allclose(nd, pd, rtol=1e-6)
        assert ns == ps


def test_native_with_masks(rng):
    n = 30
    ef, et, w = random_graph(rng, n, extra=20)
    vertex_ok = rng.uniform(size=n) > 0.2
    edge_ok = rng.uniform(size=len(ef)) > 0.3
    src = int(np.nonzero(vertex_ok)[0][0])
    nd, _ = native_dijkstra(n, ef, et, w, src, vertex_ok=vertex_ok,
                            edge_ok=edge_ok)
    pd, _ = _py_dijkstra(n, ef, et, w, src, vertex_ok=vertex_ok,
                         edge_ok=edge_ok)
    np.testing.assert_allclose(nd, pd, rtol=1e-6)


def test_native_early_stop(rng):
    n = 40
    ef, et, w = random_graph(rng, n)
    nd, ns = native_dijkstra(n, ef, et, w, 5, max_settled=7)
    assert len(ns) == 7
    assert ns[0] == 5
    _, ps = _py_dijkstra(n, ef, et, w, 5, max_settled=7)
    assert ns == ps


def test_native_components(rng):
    # Two chains, disconnected.
    ef = np.asarray([0, 1, 3, 4], np.int32)
    et = np.asarray([1, 2, 4, 5], np.int32)
    n, labels = native_components(6, ef, et)
    assert n == 2
    assert labels[0] == labels[1] == labels[2]
    assert labels[3] == labels[4] == labels[5]
    assert labels[0] != labels[3]


def test_dispatch_uses_native(rng):
    """graph.shortest_path.dijkstra should agree with native directly."""
    n = 25
    ef, et, w = random_graph(rng, n, extra=10)
    d1, s1 = sp.dijkstra(n, ef, et, w, 0)
    d2, s2 = native_dijkstra(n, ef, et, w, 0)
    np.testing.assert_allclose(d1, d2)
    assert list(s1) == list(s2)


def test_native_scan_loader(tmp_path):
    """The C++ async scan loader streams KITTI .bin files in order and
    matches the numpy reader bit-for-bit."""
    pytest.importorskip("numpy")
    from pgslam_tpu.datasets import load_kitti_bin, save_kitti_bin
    from pgslam_tpu.native import ScanLoader, native_available
    if not native_available():
        pytest.skip("no native toolchain")
    rng = np.random.default_rng(0)
    scans = []
    for i in range(5):
        pts = rng.uniform(-40, 40, (500 + 100 * i, 3)).astype(np.float32)
        refl = rng.uniform(0, 1, len(pts)).astype(np.float32)
        save_kitti_bin(str(tmp_path / f"{i:06d}.bin"), pts, refl)
        scans.append((pts, refl))
    with ScanLoader(str(tmp_path), with_reflectance=True) as loader:
        assert len(loader) == 5
        out = list(loader)
    assert len(out) == 5
    for (pts, refl), (lp, lr) in zip(scans, out):
        np.testing.assert_array_equal(lp, pts)
        np.testing.assert_array_equal(lr, refl)
    # and the plain numpy reader agrees with the native one
    np.testing.assert_array_equal(
        out[0][0], load_kitti_bin(str(tmp_path / "000000.bin")))


def test_native_scan_loader_quantized(tmp_path):
    """quantize_mm streams int16 millimeter packets: values match the
    f32 reader to the 0.5 mm grid, out-of-envelope points are dropped,
    and make_cloud/dequantize_cloud round-trip the packed protocol."""
    from pgslam_tpu.cloud import MM_SCALE, dequantize_cloud, make_cloud
    from pgslam_tpu.datasets import save_kitti_bin
    from pgslam_tpu.native import ScanLoader, native_available
    if not native_available():
        pytest.skip("no native toolchain")
    rng = np.random.default_rng(1)
    pts = rng.uniform(-30, 30, (800, 3)).astype(np.float32)
    pts[5] = [40.0, 0.0, 0.0]        # outside the +-32.767 m envelope
    pts[17] = [0.0, -35.0, 2.0]
    save_kitti_bin(str(tmp_path / "000000.bin"), pts)
    with ScanLoader(str(tmp_path), quantize_mm=True) as loader:
        q = next(iter(loader))
    assert q.dtype == np.int16
    assert q.shape == (798, 3)       # 2 dropped
    keep = np.delete(pts, [5, 17], axis=0)
    np.testing.assert_allclose(q.astype(np.float32) / MM_SCALE, keep,
                               atol=0.5 / MM_SCALE + 1e-7)
    # packed protocol survives make_cloud and dequantizes in-graph
    cloud = make_cloud(q, capacity=1024)
    assert cloud.points.dtype == np.int16
    deq = dequantize_cloud(cloud)
    np.testing.assert_allclose(
        np.asarray(deq.points[:798]), keep, atol=0.5 / MM_SCALE + 1e-7)


def test_int16_cloud_through_slam_facade(tmp_path):
    """An int16 mm cloud entering via add_data tracks identically to the
    same scan in f32 (to the quantization grid): the jitted ingest
    dequantizes in-graph."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_slam_e2e import small_config

    from pgslam_tpu.datasets import corridor_sequence
    from pgslam_tpu.slam import PoseGraphSlam

    rng = np.random.default_rng(7)
    scans, odom, truth = corridor_sequence(
        rng, n_scans=8, scan_points=512, step=0.4, noise=0.003,
        odom_noise=0.005, length=30.0)
    T_rs = np.eye(4, dtype=np.float32)

    def run(quantize):
        slam = PoseGraphSlam(small_config())
        for i, (s, T) in enumerate(zip(scans, odom)):
            if quantize:
                s = np.clip(np.round(s * 1000.0), -32767,
                            32767).astype(np.int16)
            slam.add_data(i, "world", T, T_rs, s)
        return slam.T_world_robot

    d = np.linalg.norm(run(False)[:3, 3] - run(True)[:3, 3])
    assert d < 0.02, f"int16 ingest diverged {d} m from f32"


def test_native_scan_loader_skips_pathological_scans(tmp_path):
    """A scan whose points are ALL dropped by the int16 envelope (or a
    truncated file) must not truncate the stream: the iterator skips it
    and the remaining scans are still served (end-of-stream is the
    distinct -3 code, not n==0)."""
    from pgslam_tpu.datasets import save_kitti_bin
    from pgslam_tpu.native import ScanLoader, native_available
    if not native_available():
        pytest.skip("no native toolchain")
    rng = np.random.default_rng(2)
    good0 = rng.uniform(-20, 20, (300, 3)).astype(np.float32)
    all_out = np.full((50, 3), 40.0, np.float32)   # everything dropped
    good1 = rng.uniform(-20, 20, (200, 3)).astype(np.float32)
    save_kitti_bin(str(tmp_path / "000000.bin"), good0)
    save_kitti_bin(str(tmp_path / "000001.bin"), all_out)
    save_kitti_bin(str(tmp_path / "000002.bin"), good1)
    with ScanLoader(str(tmp_path), quantize_mm=True) as loader:
        out = list(loader)
    assert [len(s) for s in out] == [300, 200]
    # float path: a truncated (unreadable) file mid-stream is skipped too
    (tmp_path / "000001.bin").write_bytes(b"\x00" * 7)  # not a multiple
    # of a 4-float record -> fread count mismatch -> read failure
    with ScanLoader(str(tmp_path)) as loader:
        out = list(loader)
    assert [len(s) for s in out] == [300, 200]


def test_native_scan_loader_quantize_flag_required(tmp_path):
    """sl_next_q on a loader opened without quantize is a hard error —
    the IO thread never built the int16 copy (the f32 path no longer
    pays the conversion)."""
    from pgslam_tpu.datasets import save_kitti_bin
    from pgslam_tpu.native import ScanLoader, native_available
    if not native_available():
        pytest.skip("no native toolchain")
    pts = np.zeros((10, 3), np.float32)
    save_kitti_bin(str(tmp_path / "000000.bin"), pts)
    loader = ScanLoader(str(tmp_path), quantize_mm=False)
    try:
        q = np.empty((16, 3), np.int16)
        assert loader._lib.sl_next_q(loader._h, q, 16) == -4
    finally:
        loader.close()


def test_native_scan_loader_missing_dir(tmp_path):
    from pgslam_tpu.native import ScanLoader, native_available
    if not native_available():
        pytest.skip("no native toolchain")
    with pytest.raises(FileNotFoundError):
        ScanLoader(str(tmp_path / "nope"))
