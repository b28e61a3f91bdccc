"""The Triton-route 1-NN kernel against float64 numpy and the brute-force
matcher, in the Pallas interpreter on the CPU, plus the wrapper's rules:
which platform runs the kernel, k>1 routing, padding and splits. The
last test runs the compiled kernel on the card and skips elsewhere."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pgslam_tpu.ops import knn_pallas
from pgslam_tpu.ops.knn import knn_brute_force
from pgslam_tpu.ops.knn_pallas import nn_pallas, use_kernel


def _nn64(q, r, rmask):
    """float64 reference: (squared distance, id) of the nearest valid
    reference point, lowest id on ties; (+inf, 0) when none is valid."""
    d = ((q[:, None, :].astype(np.float64)
          - r[None, :, :].astype(np.float64)) ** 2).sum(-1)
    d[:, ~rmask] = np.inf
    ids = d.argmin(axis=1)
    best = d[np.arange(len(q)), ids]
    return best, np.where(np.isfinite(best), ids, 0)


def _kernel(q, qm, r, rm, **kw):
    return nn_pallas(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(r),
                     jnp.asarray(rm), interpret=True, **kw)


def test_pallas_matches_brute(rng):
    q = rng.uniform(0, 10, (700, 3)).astype(np.float32)
    r = rng.uniform(0, 10, (1500, 3)).astype(np.float32)
    qm = np.ones(700, bool)
    rm = np.ones(1500, bool)
    rm[1000:] = False
    b = knn_brute_force(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(r),
                        jnp.asarray(rm), k=1)
    p = _kernel(q, qm, r, rm)
    d64, i64 = _nn64(q, r, rm)
    np.testing.assert_array_equal(np.asarray(p.ids)[:, 0], i64)
    np.testing.assert_array_equal(np.asarray(p.ids), np.asarray(b.ids))
    np.testing.assert_allclose(np.asarray(p.dists2)[:, 0], d64, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(p.dists2), np.asarray(b.dists2),
                               rtol=1e-3, atol=1e-4)


def test_pallas_masked_query(rng):
    q = rng.uniform(0, 5, (64, 3)).astype(np.float32)
    r = rng.uniform(0, 5, (128, 3)).astype(np.float32)
    qm = np.ones(64, bool)
    qm[[3, 10]] = False
    p = _kernel(q, qm, r, np.ones(128, bool))
    d = np.asarray(p.dists2)[:, 0]
    assert not np.isfinite(d[3]) and not np.isfinite(d[10])
    assert np.asarray(p.ids)[3, 0] == 0 and np.asarray(p.ids)[10, 0] == 0
    assert np.isfinite(d[0])


def test_pallas_all_refs_masked(rng):
    q = rng.uniform(0, 5, (32, 3)).astype(np.float32)
    r = rng.uniform(0, 5, (64, 3)).astype(np.float32)
    p = _kernel(q, np.ones(32, bool), r, np.zeros(64, bool))
    assert not np.isfinite(np.asarray(p.dists2)).any()
    assert (np.asarray(p.ids) == 0).all()


def test_pallas_nonaligned_sizes(rng):
    # Sizes that don't divide the blocks exercise the padding path; a
    # partial reference mask must never match a masked point.
    q = rng.uniform(0, 5, (130, 3)).astype(np.float32)
    r = rng.uniform(0, 5, (257, 3)).astype(np.float32)
    rm = np.ones(257, bool)
    rm[40:90] = False
    b = knn_brute_force(jnp.asarray(q), jnp.ones(130, bool), jnp.asarray(r),
                        jnp.asarray(rm), k=1)
    p = _kernel(q, np.ones(130, bool), r, rm, block_q=32, block_r=32)
    ids = np.asarray(p.ids)[:, 0]
    np.testing.assert_array_equal(ids, np.asarray(b.ids)[:, 0])
    assert rm[ids].all()


@pytest.mark.parametrize("nq,nr", [(130, 257), (64, 1000), (1, 70)])
def test_pallas_parity_at_50m_offset(rng, nq, nr):
    # Scan-like coordinates 50 m from the origin: the kernel's direct
    # difference has no |q|^2 - 2 q.r + |r|^2 cancellation, so it
    # matches float64 to fp32 rounding of the distance itself.
    r = (rng.uniform(-5, 5, (nr, 3)) + 50.0).astype(np.float32)
    q = (r[rng.integers(0, nr, nq)]
         + rng.normal(0, 0.05, (nq, 3))).astype(np.float32)
    rm = rng.random(nr) > 0.1
    p = _kernel(q, np.ones(nq, bool), r, rm, block_q=32, block_r=32)
    d64, i64 = _nn64(q, r, rm)
    np.testing.assert_array_equal(np.asarray(p.ids)[:, 0], i64)
    np.testing.assert_allclose(np.asarray(p.dists2)[:, 0], d64, rtol=1e-5)


def test_pallas_topk_matches_brute(rng):
    # k>1 is served by the brute-force matcher (documented rule in
    # nn_pallas): results are the brute-force results, bit for bit.
    q = rng.uniform(0, 10, (300, 3)).astype(np.float32)
    r = rng.uniform(0, 10, (900, 3)).astype(np.float32)
    qm = np.ones(300, bool)
    rm = np.ones(900, bool)
    rm[700:] = False
    for k in (2, 3, 4):
        b = knn_brute_force(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(r),
                            jnp.asarray(rm), k=k)
        p = _kernel(q, qm, r, rm, k=k)
        np.testing.assert_array_equal(np.asarray(p.ids), np.asarray(b.ids))
        np.testing.assert_array_equal(np.asarray(p.dists2),
                                      np.asarray(b.dists2))


def test_pallas_topk_more_than_valid_refs(rng):
    # k exceeds the number of valid reference points: surplus slots must
    # report +inf / id 0.
    q = rng.uniform(0, 5, (16, 3)).astype(np.float32)
    r = rng.uniform(0, 5, (64, 3)).astype(np.float32)
    rm = np.zeros(64, bool)
    rm[:2] = True
    p = _kernel(q, np.ones(16, bool), r, rm, k=4)
    d = np.asarray(p.dists2)
    assert np.isfinite(d[:, :2]).all()
    assert not np.isfinite(d[:, 2:]).any()
    assert (np.asarray(p.ids)[:, 2:] == 0).all()
    # ascending order within the finite prefix
    assert (d[:, 0] <= d[:, 1]).all()


@pytest.mark.parametrize("k", [2, 3])
def test_k_gt_1_never_reaches_the_kernel(rng, monkeypatch, k):
    def boom(*a, **kw):
        raise AssertionError("pallas_call reached with k > 1")
    monkeypatch.setattr(knn_pallas.pl, "pallas_call", boom)
    q = rng.uniform(0, 5, (40, 3)).astype(np.float32)
    r = rng.uniform(0, 5, (90, 3)).astype(np.float32)
    p = _kernel(q, np.ones(40, bool), r, np.ones(90, bool), k=k)
    assert p.ids.shape == (40, k)


@pytest.mark.parametrize("platform,expected", [("gpu", True),
                                               ("cpu", False)])
def test_use_kernel_by_platform(platform, expected):
    assert use_kernel(platform) is expected


def test_use_kernel_rejects_other_platforms():
    with pytest.raises(NotImplementedError):
        use_kernel("rocm")


def test_match_clouds_on_cpu_takes_brute_path(rng):
    from pgslam_tpu.cloud import make_cloud
    from pgslam_tpu.ops.icp import ICPConfig, match_clouds
    q = rng.uniform(0, 5, (50, 3)).astype(np.float32)
    ref = make_cloud(rng.uniform(0, 5, (80, 3)).astype(np.float32))
    got = match_clouds(jnp.asarray(q), jnp.ones(50, bool), ref,
                       ICPConfig(matcher="pallas"))
    want = knn_brute_force(jnp.asarray(q), jnp.ones(50, bool), ref.points,
                           ref.mask)
    np.testing.assert_array_equal(np.asarray(got.ids), np.asarray(want.ids))


def test_splits_cover_every_reference_tile():
    # Few query blocks -> many reference splits (to fill the card), each
    # walking at least 16 tiles where there are that many; the splits
    # always cover every tile.
    for nq_blocks, nr_tiles in ((1, 1), (1, 5000), (32, 1024), (1024, 1024),
                                (4096, 64), (2, 128), (16, 15)):
        s = knn_pallas._splits(nq_blocks, nr_tiles)
        assert 1 <= s <= max(1, nr_tiles // 16)
        assert s * -(-nr_tiles // s) >= nr_tiles
    assert knn_pallas._splits(32, 1024) == 32
    assert knn_pallas._splits(2, 128) == 8
    assert knn_pallas._splits(1024, 1024) == 1


def test_pallas_under_vmap(rng):
    # The fleet and loop-closure paths batch the matcher with vmap.
    B, nq, nr = 3, 70, 150
    q = rng.uniform(0, 5, (B, nq, 3)).astype(np.float32)
    r = rng.uniform(0, 5, (B, nr, 3)).astype(np.float32)
    rm = rng.random((B, nr)) > 0.2
    p = jax.vmap(lambda a, b, c, d: nn_pallas(a, b, c, d, interpret=True))(
        jnp.asarray(q), jnp.ones((B, nq), bool), jnp.asarray(r),
        jnp.asarray(rm))
    for i in range(B):
        d64, i64 = _nn64(q[i], r[i], rm[i])
        np.testing.assert_array_equal(np.asarray(p.ids)[i, :, 0], i64)


@pytest.mark.gpu
def test_kernel_on_card_matches_float64(gpu, rng):
    nq, nr = 2048, 65536
    r = (rng.uniform(-50, 50, (nr, 3))).astype(np.float32)
    q = (r[rng.integers(0, nr, nq)]
         + rng.normal(0, 0.05, (nq, 3))).astype(np.float32)
    with jax.default_device(gpu):
        p = nn_pallas(jnp.asarray(q), jnp.ones(nq, bool), jnp.asarray(r),
                      jnp.ones(nr, bool))
    d64, i64 = _nn64(q[:256], r, np.ones(nr, bool))
    np.testing.assert_array_equal(np.asarray(p.ids)[:256, 0], i64)
    np.testing.assert_allclose(np.asarray(p.dists2)[:256, 0], d64,
                               rtol=1e-5)
