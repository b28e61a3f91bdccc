import jax
import jax.numpy as jnp
import numpy as np

from pgslam_tpu import se3
from pgslam_tpu.cloud import (Cloud, concatenate_clouds, empty_cloud,
                              make_cloud, pad_cloud, transform_cloud)
from pgslam_tpu.metrics import distance, weight
from pgslam_tpu.ops import filters as F
from pgslam_tpu.ops import outlier as O
from pgslam_tpu.ops.knn import knn_brute_force


def test_make_cloud_padding():
    c = make_cloud(np.ones((10, 3)), capacity=16)
    assert c.capacity == 16
    assert int(c.count()) == 10
    assert not bool(c.is_empty())
    e = empty_cloud(8)
    assert bool(e.is_empty())


def test_transform_cloud_rotates_normals(rng):
    pts = rng.normal(size=(20, 3))
    normals = rng.normal(size=(20, 3))
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    c = make_cloud(pts, descriptors={"normals": normals}, capacity=32)
    T = se3.exp(jnp.asarray([0.5, 0.0, 0.0, 0.0, 0.0, 0.7], jnp.float32))
    out = transform_cloud(T, c)
    R = np.asarray(T)[:3, :3]
    np.testing.assert_allclose(np.asarray(out.points)[:20],
                               pts @ R.T + np.asarray(T)[:3, 3], atol=1e-5)
    np.testing.assert_allclose(np.asarray(out.descriptors["normals"])[:20],
                               normals @ R.T, atol=1e-5)


def test_concatenate_clouds(rng):
    a = make_cloud(rng.normal(size=(5, 3)), capacity=8,
                   descriptors={"normals": np.ones((5, 3))})
    b = make_cloud(rng.normal(size=(3, 3)), capacity=4)
    c = concatenate_clouds([a, b])
    assert c.capacity == 12
    assert int(c.count()) == 8
    assert c.descriptors["normals"].shape == (12, 3)


def test_pad_cloud(rng):
    a = make_cloud(rng.normal(size=(5, 3)), capacity=5)
    b = pad_cloud(a, 9)
    assert b.capacity == 9 and int(b.count()) == 5


def test_metrics_translation_only(rng):
    T1 = se3.exp(jnp.asarray([1.0, 2.0, 2.0, 0.3, 0.2, 0.1], jnp.float32))
    T2 = se3.exp(jnp.asarray([0.0, 0.0, 0.0, -0.5, 0.1, 0.9], jnp.float32))
    d = float(distance(T1, T2))
    expected = np.linalg.norm(np.asarray(T2)[:3, 3] - np.asarray(T1)[:3, 3])
    assert np.isclose(d, expected, atol=1e-6)
    # weight ignores covariance entirely (metrics.hpp:20-24)
    w = float(weight(T1, jnp.eye(6) * 1e9))
    assert np.isclose(w, np.linalg.norm(np.asarray(T1)[:3, 3]), atol=1e-6)


def test_knn_exact_against_numpy(rng):
    q = rng.normal(size=(50, 3)).astype(np.float32)
    r = rng.normal(size=(70, 3)).astype(np.float32)
    qm = np.ones(50, bool)
    rm = np.ones(70, bool)
    rm[60:] = False  # masked reference points must never be selected
    m = knn_brute_force(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(r),
                        jnp.asarray(rm), k=3, tile_ref=32)
    d2 = ((q[:, None, :] - r[None, :, :]) ** 2).sum(-1)
    d2[:, ~rm] = np.inf
    ids_np = np.argsort(d2, axis=1)[:, :3]
    np.testing.assert_array_equal(np.asarray(m.ids), ids_np)
    np.testing.assert_allclose(np.asarray(m.dists2),
                               np.take_along_axis(d2, ids_np, 1), rtol=1e-4,
                               atol=1e-5)


def test_knn_query_tiling_matches(rng):
    q = rng.normal(size=(33, 3)).astype(np.float32)
    r = rng.normal(size=(40, 3)).astype(np.float32)
    ones_q, ones_r = np.ones(33, bool), np.ones(40, bool)
    a = knn_brute_force(jnp.asarray(q), jnp.asarray(ones_q), jnp.asarray(r),
                        jnp.asarray(ones_r), k=1, tile_ref=16)
    b = knn_brute_force(jnp.asarray(q), jnp.asarray(ones_q), jnp.asarray(r),
                        jnp.asarray(ones_r), k=1, tile_ref=16, tile_query=8)
    np.testing.assert_array_equal(np.asarray(a.ids), np.asarray(b.ids))


def test_filters_mask_semantics(rng):
    pts = rng.uniform(-10, 10, size=(200, 3)).astype(np.float32)
    c = make_cloud(pts, capacity=256)
    out = F.apply_chain((F.MaxDist(dist=5.0),), c)
    kept = np.asarray(out.mask)
    radii = np.linalg.norm(pts, axis=-1)
    np.testing.assert_array_equal(kept[:200], radii <= 5.0)
    assert not kept[200:].any()

    out2 = F.apply_chain((F.MaxPointCount(count=10),), c)
    assert int(out2.count()) == 10

    out3 = F.apply_chain((F.RandomSampling(prob=0.5),), c,
                         key=jax.random.PRNGKey(1))
    frac = int(out3.count()) / 200
    assert 0.3 < frac < 0.7


def test_bounding_box_filter(rng):
    pts = np.array([[0.0, 0.0, 0.0], [5.0, 5.0, 5.0]], np.float32)
    c = make_cloud(pts)
    out = F.apply_chain((F.BoundingBox(remove_inside=True),), c)
    np.testing.assert_array_equal(np.asarray(out.mask), [False, True])


def test_voxel_grid_subsamples(rng):
    # 1000 points in a tight cluster -> very few survivors.
    pts = rng.normal(size=(1000, 3)).astype(np.float32) * 0.01
    c = make_cloud(pts)
    out = F.apply_chain((F.VoxelGrid(voxel_size=0.5),), c)
    assert int(out.count()) <= 8
    # spread-out points survive
    pts2 = (rng.uniform(0, 100, size=(100, 3)) // 1.0).astype(np.float32)
    c2 = make_cloud(pts2)
    out2 = F.apply_chain((F.VoxelGrid(voxel_size=0.1),), c2)
    assert int(out2.count()) >= 80


def test_voxel_grid_sort_matches_scatter(rng):
    # The sort-dedup backend (for backends where scatters serialize)
    # must produce the bit-identical keep mask to the scatter-min race,
    # including invalid-point handling and hash collisions.
    import jax.numpy as jnp
    for n, hs in [(512, 1 << 8), (4096, 1 << 15)]:
        pts = rng.normal(size=(n, 3)).astype(np.float32) * 10
        mask = rng.random(n) > 0.1
        c = make_cloud(pts, mask=mask, capacity=n)
        a = F.apply_chain((F.VoxelGrid(0.4, hs, method="scatter"),), c)
        b = F.apply_chain((F.VoxelGrid(0.4, hs, method="sort"),), c)
        assert bool(jnp.all(a.mask == b.mask))
        # vmapped (the batched-prep context on the headline path)
        import jax
        cb = jax.tree_util.tree_map(
            lambda x: jnp.stack([x, x]) if hasattr(x, "shape") else x, c)
        av = jax.vmap(lambda cc: F.apply_chain(
            (F.VoxelGrid(0.4, hs, method="scatter"),), cc))(cb)
        bv = jax.vmap(lambda cc: F.apply_chain(
            (F.VoxelGrid(0.4, hs, method="sort"),), cc))(cb)
        assert bool(jnp.all(av.mask == bv.mask))


def test_observation_direction_and_normals(rng):
    # Points on the z=0 plane observed from above -> normals ~ +z.
    xy = rng.uniform(-1, 1, size=(128, 2)).astype(np.float32)
    pts = np.concatenate([xy, np.zeros((128, 1), np.float32)], axis=-1)
    c = make_cloud(pts)
    chain = (F.ObservationDirection(z=10.0), F.SurfaceNormal(knn=6))
    out = F.apply_chain(chain, c)
    n = np.asarray(out.descriptors["normals"])
    assert np.all(n[:, 2] > 0.99)


def test_compact(rng):
    pts = rng.normal(size=(10, 3)).astype(np.float32)
    mask = np.zeros(10, bool)
    mask[[1, 4, 7]] = True
    c = Cloud(points=jnp.asarray(pts), mask=jnp.asarray(mask))
    out = F.compact(c, capacity=4)
    assert out.capacity == 4
    np.testing.assert_allclose(np.asarray(out.points)[:3], pts[[1, 4, 7]])
    np.testing.assert_array_equal(np.asarray(out.mask), [1, 1, 1, 0])


def test_trimmed_outlier_ratio(rng):
    from pgslam_tpu.ops.knn import Matches
    d2 = jnp.asarray(np.arange(100, dtype=np.float32)[:, None])
    m = Matches(dists2=d2, ids=jnp.zeros((100, 1), jnp.int32))
    w = O.compute_weights((O.TrimmedDist(0.7),), m, jnp.ones(100, bool))
    assert int(w.sum()) == 70
    # smallest distances kept
    assert float(w[:70].sum()) == 70.0


def test_maxdist_outlier(rng):
    from pgslam_tpu.ops.knn import Matches
    d2 = jnp.asarray(np.array([0.5, 2.0, 5.0], np.float32)[:, None])
    m = Matches(dists2=d2, ids=jnp.zeros((3, 1), jnp.int32))
    w = O.compute_weights((O.MaxDist(max_dist=1.5),), m, jnp.ones(3, bool))
    np.testing.assert_allclose(np.asarray(w)[:, 0], [1.0, 1.0, 0.0])
