"""Fixture-cache machinery of the driver-facing bench.py.

The cache (stage A packets / stage B prepped references) exists so runs
start at the timed phases — see bench.py's cache block. These
tests pin the two surfaces that could silently corrupt a benchmark:

1. ``_np_se3_exp`` — the pure-numpy SE(3) exp that stamps fixture
   ground-truth offsets (host-only, so fixture generation needs no
   device round-trip). If it drifts from the package's ``se3.exp``, every
   cached error quantile is wrong while looking plausible.
2. ``_save_npz`` / ``_load_npz`` — atomicity and the fail-soft
   regeneration contract (unreadable/missing cache returns None, never
   raises into the bench).

No rendering, no device — full-shape generation is covered by the smoke
bench run (PGSLAM_BENCH_SMOKE=1 python bench.py).
"""

import os
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/tests/", 1)[0])

import bench


def test_np_se3_exp_matches_package_exp():
    import jax
    from pgslam_tpu import se3

    rng = np.random.default_rng(3)
    twists = np.concatenate([
        rng.normal(size=(32, 6)) * [0.15, 0.15, 0.03, 0.005, 0.005, 0.02],
        rng.normal(size=(8, 6)) * 2.0,          # large rotations
        rng.normal(size=(8, 6)) * 1e-6,         # Taylor branch
        np.zeros((1, 6)),                       # exact identity
    ]).astype(np.float32)
    ours = bench._np_se3_exp(twists)
    ref = np.asarray(jax.vmap(se3.exp)(twists))
    # both fp32 outputs of the same series; agreement to fp32 roundoff
    np.testing.assert_allclose(ours, ref, atol=2e-6)
    # homogeneous row exact, rotation orthonormal
    assert np.all(ours[:, 3] == np.array([0, 0, 0, 1], np.float32))
    RtR = np.einsum("bij,bik->bjk", ours[:, :3, :3], ours[:, :3, :3])
    np.testing.assert_allclose(RtR, np.broadcast_to(np.eye(3), RtR.shape),
                               atol=1e-5)


def test_npz_round_trip_and_fail_soft(tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "_CACHE_DIR", str(tmp_path))
    path = str(tmp_path / "fixtures_test.npz")
    payload = {
        "packets": np.arange(24, dtype=np.int16).reshape(2, 4, 3),
        "offsets": np.eye(4, dtype=np.float32)[None],
    }
    bench._save_npz(path, payload)
    assert os.path.exists(path)
    # no stray .tmp file left behind (atomic rename)
    assert [f for f in os.listdir(tmp_path)] == [os.path.basename(path)]
    loaded = bench._load_npz(path, ("packets", "offsets"))
    assert loaded["packets"].dtype == np.int16
    np.testing.assert_array_equal(loaded["packets"], payload["packets"])
    np.testing.assert_array_equal(loaded["offsets"], payload["offsets"])

    # missing file -> None (cache miss regenerates)
    assert bench._load_npz(str(tmp_path / "absent.npz"), None) is None
    # corrupt file -> None, not an exception into the bench child
    with open(path, "wb") as fh:
        fh.write(b"not a zip archive")
    assert bench._load_npz(path, ("packets",)) is None


def test_save_npz_never_raises(tmp_path, monkeypatch):
    # cache is an optimization: a write failure must not kill the child
    bench._save_npz(str(tmp_path / "no_such_dir" / "x" / "f.npz"),
                    {"a": np.zeros(3)})
