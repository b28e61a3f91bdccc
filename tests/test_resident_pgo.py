"""Device-resident pose-graph mirror (optim/resident.py): the
production optimize path keeps the padded graph arrays on
device and uploads only deltas. These tests pin

* bit-identical results vs the classic full-rebuild path over multi-call
  sequences (same jitted solver, same inputs — any difference is a
  bookkeeping bug in the delta application),
* the delta-vs-rebuild bookkeeping: appended vertices/edges, host-dirty
  poses, bucket growth, checkpoint-restore invalidation, and the MT
  interleave guard,
* the packed-writeback formats (exact12 bit-exact round-trip; quat7
  within float tolerance),
* the fail-soft fallback to the classic path, and its counter.
"""

import dataclasses

import numpy as np

from pgslam_tpu.cloud import make_cloud
from pgslam_tpu.graph.pose_graph import MapManager
from pgslam_tpu.optimizer import Optimizer, OptimizerConfig


class _NoLC:
    def add_new_vertex(self, v):
        pass


def _chain_world(mm, n, rng, loopy=False):
    """Build an n-keyframe odometry chain; returns true poses."""
    cloud = make_cloud(rng.uniform(-1, 1, (16, 3)).astype(np.float32))
    T = np.eye(4, dtype=np.float32)
    mm.set_loop_closer(_NoLC())
    mm.add_first_keyframe(cloud, T)
    poses = [T]
    for i in range(1, n):
        Tn = np.eye(4, dtype=np.float32)
        Tn[0, 3] = i * 1.0
        Tn[1, 3] = 0.05 * np.sin(i)
        dT = (np.linalg.inv(poses[-1]) @ Tn).astype(np.float32)
        mm.add_new_keyframe(i - 1, Tn, dT,
                            np.eye(6, dtype=np.float32) * 0.01, cloud)
        poses.append(Tn)
    return poses


def _closure(poses, a, b, jitter=0.001):
    T = (np.linalg.inv(poses[a]) @ poses[b]).astype(np.float32)
    return T + jitter


def _run_sequence(resident: str, n=40, closures=((5, 35), (2, 30), (1, 20)),
                  opt_cfg=None, grow_after=None, dirty_after=None):
    """Drive several optimize calls (with graph growth and optional
    host pose writes in between); returns final optimized poses."""
    rng = np.random.default_rng(0)
    mm = MapManager()
    cfg = opt_cfg or OptimizerConfig()
    opt = Optimizer(mm, dataclasses.replace(cfg, resident=resident))
    poses = _chain_world(mm, n, rng)
    for k, (a, b) in enumerate(closures):
        opt.add_new_data(a, b, _closure(poses, a, b, 0.001 * (k + 1)),
                         np.eye(6, dtype=np.float32) * 0.01)
        if grow_after is not None and k == 0:
            # grow the graph between optimizes (new keyframes append)
            cloud = make_cloud(rng.uniform(-1, 1, (16, 3))
                               .astype(np.float32))
            for j in range(grow_after):
                i = len(poses)
                Tn = np.eye(4, dtype=np.float32)
                Tn[0, 3] = i * 1.0
                dT = (np.linalg.inv(poses[-1]) @ Tn).astype(np.float32)
                mm.add_new_keyframe(i - 1, Tn, dT,
                                    np.eye(6, dtype=np.float32) * 0.01, cloud)
                poses.append(Tn)
        if dirty_after is not None and k == 0:
            # a host-side pose write between optimizes (must re-upload)
            T = mm.get_graph().optimized_poses[dirty_after].copy()
            T[0, 3] += 0.05
            mm.update_keyframe_transform(dirty_after, T, mm.now())
    g = mm.get_graph()
    return g.optimized_poses[:g.n_vertices].copy(), opt


def test_resident_matches_classic_bitwise():
    classic, _ = _run_sequence("off")
    res, opt = _run_sequence("auto")
    np.testing.assert_array_equal(classic, res)
    assert opt._mirror is not None
    assert opt._mirror.last_download_bytes > 0


def test_resident_matches_classic_with_growth_and_dirty():
    classic, _ = _run_sequence("off", grow_after=10, dirty_after=3)
    res, _ = _run_sequence("auto", grow_after=10, dirty_after=3)
    np.testing.assert_array_equal(classic, res)


def test_resident_bucket_growth_rebuilds():
    # 40 -> 100 vertices crosses the 64 shape bucket: V/E buckets grow,
    # forcing a mirror rebuild mid-sequence; results stay bit-identical.
    classic, _ = _run_sequence("off", grow_after=70,
                               closures=((5, 35), (2, 30), (1, 90)))
    res, opt = _run_sequence("auto", grow_after=70,
                             closures=((5, 35), (2, 30), (1, 90)))
    np.testing.assert_array_equal(classic, res)
    assert opt._mirror._st["V"] >= 128


def test_resident_delta_bytes_small():
    """The steady-state delta upload must be orders below the rebuild
    upload — the whole point of the mirror."""
    _, opt = _run_sequence("auto")
    m = opt._mirror
    assert m.last_rebuild_bytes > 0
    assert m.last_upload_bytes < m.last_rebuild_bytes / 4, \
        (m.last_upload_bytes, m.last_rebuild_bytes)


def test_restore_invalidates_mirror(tmp_path):
    from pgslam_tpu.io import load_checkpoint, save_checkpoint
    rng = np.random.default_rng(1)
    mm = MapManager()
    opt = Optimizer(mm, OptimizerConfig(resident="auto"))
    poses = _chain_world(mm, 20, rng)
    opt.add_new_data(2, 15, _closure(poses, 2, 15),
                     np.eye(6, dtype=np.float32) * 0.01)
    st_before = opt._mirror._st
    assert st_before is not None
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, mm)
    load_checkpoint(path, mm)
    # next optimize must rebuild (fresh graph object), not reuse slots
    opt.add_new_data(1, 18, _closure(poses, 1, 18),
                     np.eye(6, dtype=np.float32) * 0.01)
    assert opt._mirror._st is not st_before
    # and the result matches a fully classic run of the same history
    mm2 = MapManager()
    opt2 = Optimizer(mm2, OptimizerConfig(resident="off"))
    poses2 = _chain_world(mm2, 20, rng=np.random.default_rng(1))
    opt2.add_new_data(2, 15, _closure(poses2, 2, 15),
                      np.eye(6, dtype=np.float32) * 0.01)
    opt2.add_new_data(1, 18, _closure(poses2, 1, 18),
                      np.eye(6, dtype=np.float32) * 0.01)
    g, g2 = mm.get_graph(), mm2.get_graph()
    np.testing.assert_array_equal(g.optimized_poses[:g.n_vertices],
                                  g2.optimized_poses[:g2.n_vertices])


def test_mt_interleave_invalidates():
    """An edge appended between prepare and the pending insert (the MT
    unlocked-solve window) shifts graph indices off the mirror slots —
    confirm_inserts must invalidate so the next call rebuilds."""
    rng = np.random.default_rng(2)
    mm = MapManager()
    opt = Optimizer(mm, OptimizerConfig(resident="auto"))
    poses = _chain_world(mm, 20, rng)
    opt.add_new_data(2, 15, _closure(poses, 2, 15),
                     np.eye(6, dtype=np.float32) * 0.01)
    assert opt._mirror._st is not None

    # simulate the race: prepare, then append an edge before writeback
    prep = opt.prepare_for_optimization_resident()
    new_poses, stats = opt._mirror.execute(prep)
    cloud = make_cloud(rng.uniform(-1, 1, (16, 3)).astype(np.float32))
    Tn = np.eye(4, dtype=np.float32)
    Tn[0, 3] = 99.0
    dT = (np.linalg.inv(poses[-1]) @ Tn).astype(np.float32)
    mm.add_new_keyframe(len(poses) - 1, Tn, dT,
                        np.eye(6, dtype=np.float32) * 0.01, cloud)
    opt.data_buffer = [(1, 10, _closure(poses, 1, 10),
                        np.eye(6, dtype=np.float32) * 0.01)]
    opt.update_after_optimization(new_poses)
    assert opt._mirror._st is None  # invalidated — rebuild next call


def test_resident_failure_falls_back_to_classic(monkeypatch):
    """A failure inside the resident execute must invalidate the mirror
    and run the batch through the classic path — never crash the SLAM
    loop — count the fallback, and the NEXT optimize rebuilds a fresh
    mirror."""
    from pgslam_tpu.optim import resident
    from pgslam_tpu.utils import counters
    before = counters["optimizer/resident_fallbacks"]

    rng = np.random.default_rng(5)
    mm = MapManager()
    opt = Optimizer(mm, OptimizerConfig(resident="auto"))
    poses = _chain_world(mm, 20, rng)

    calls = {"n": 0}
    orig = resident.ResidentPGO.execute

    def flaky(self, prep):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("synthetic device failure")
        return orig(self, prep)

    monkeypatch.setattr(resident.ResidentPGO, "execute", flaky)
    opt.add_new_data(2, 15, _closure(poses, 2, 15),
                     np.eye(6, dtype=np.float32) * 0.01)   # classic fallback
    assert opt.last_stats is not None
    assert opt._mirror._st is None            # invalidated
    assert counters["optimizer/resident_fallbacks"] == before + 1
    opt.add_new_data(1, 18, _closure(poses, 1, 18),
                     np.eye(6, dtype=np.float32) * 0.01)   # mirror rebuilds
    assert opt._mirror._st is not None
    # same history through pure classic agrees bitwise
    mm2 = MapManager()
    opt2 = Optimizer(mm2, OptimizerConfig(resident="off"))
    poses2 = _chain_world(mm2, 20, np.random.default_rng(5))
    opt2.add_new_data(2, 15, _closure(poses2, 2, 15),
                      np.eye(6, dtype=np.float32) * 0.01)
    opt2.add_new_data(1, 18, _closure(poses2, 1, 18),
                      np.eye(6, dtype=np.float32) * 0.01)
    g, g2 = mm.get_graph(), mm2.get_graph()
    np.testing.assert_array_equal(g.optimized_poses[:g.n_vertices],
                                  g2.optimized_poses[:g2.n_vertices])


def test_quat7_pack_roundtrip():
    from pgslam_tpu import se3
    from pgslam_tpu.optim.resident import (_pack_poses,
                                           _unpack_poses_host)
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    w = rng.normal(0, 1, (32, 3)).astype(np.float32)
    t = rng.normal(0, 10, (32, 3)).astype(np.float32)
    T = np.asarray(se3.make(se3.exp_so3(jnp.asarray(w)), jnp.asarray(t)))
    packed = np.asarray(_pack_poses(jnp.asarray(T), "quat7"))
    back = _unpack_poses_host(packed, 32, "quat7")
    np.testing.assert_allclose(back[:, :3, 3], T[:, :3, 3], atol=0)
    np.testing.assert_allclose(back[:, :3, :3], T[:, :3, :3], atol=1e-6)
    # exact12 is bit-exact
    p12 = np.asarray(_pack_poses(jnp.asarray(T), "exact12"))
    np.testing.assert_array_equal(_unpack_poses_host(p12, 32, "exact12"),
                                  T)


def test_graph_token_survives_id_reuse():
    """Mirror identity must not rely on id(graph): consecutive
    checkpoint restores all produce graphs at mutation_epoch 1, and
    CPython can hand the second restored graph the first one's freed
    address. The per-object token can never alias."""
    from pgslam_tpu.graph.pose_graph import PoseGraph
    from pgslam_tpu.optim.resident import _graph_token

    g1 = PoseGraph()
    t1 = _graph_token(g1)
    assert _graph_token(g1) == t1            # stable per object
    g2 = PoseGraph()
    assert _graph_token(g2) != t1            # distinct objects differ
    # token survives (and distinguishes) even when epochs match
    g1.mutation_epoch = g2.mutation_epoch = 1
    assert _graph_token(g1) != _graph_token(g2)


def test_double_restore_rebuilds_each_time(tmp_path):
    """Two restores in a row: the mirror must rebuild after EACH (both
    restored graphs sit at epoch 1 — only object identity separates
    them), and results stay bit-equal to the classic path."""
    from pgslam_tpu.io import load_checkpoint, save_checkpoint
    rng = np.random.default_rng(11)
    mm = MapManager()
    opt = Optimizer(mm, OptimizerConfig(resident="auto"))
    poses = _chain_world(mm, 16, rng)
    opt.add_new_data(2, 12, _closure(poses, 2, 12),
                     np.eye(6, dtype=np.float32) * 0.01)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, mm)
    for k, (a, b) in enumerate(((1, 14), (3, 10))):
        load_checkpoint(path, mm)
        st = opt._mirror._st
        opt.add_new_data(a, b, _closure(poses, a, b),
                         np.eye(6, dtype=np.float32) * 0.01)
        assert opt._mirror._st is not st
        assert opt._mirror._st["graph_id"] == \
            mm.get_graph()._resident_mirror_token


def test_prepare_failure_falls_back_to_classic(monkeypatch):
    """A HOST-side error in the resident prepare (stale bookkeeping)
    must take the same fail-soft road as a device failure: classic path
    for the batch, mirror invalidated, fallback counted, SLAM loop
    alive."""
    from pgslam_tpu.optim import resident
    from pgslam_tpu.utils import counters
    before = counters["optimizer/resident_fallbacks"]

    rng = np.random.default_rng(7)
    mm = MapManager()
    opt = Optimizer(mm, OptimizerConfig(resident="auto"))
    poses = _chain_world(mm, 20, rng)

    calls = {"n": 0}
    orig = resident.ResidentPGO.prepare

    def flaky(self, *a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise IndexError("synthetic host bookkeeping error")
        return orig(self, *a, **kw)

    monkeypatch.setattr(resident.ResidentPGO, "prepare", flaky)
    opt.add_new_data(2, 15, _closure(poses, 2, 15),
                     np.eye(6, dtype=np.float32) * 0.01)   # classic fallback
    assert opt.last_stats is not None
    assert opt._mirror._st is None
    assert counters["optimizer/resident_fallbacks"] == before + 1
    opt.add_new_data(1, 18, _closure(poses, 1, 18),
                     np.eye(6, dtype=np.float32) * 0.01)   # rebuilds
    assert opt._mirror._st is not None
    mm2 = MapManager()
    opt2 = Optimizer(mm2, OptimizerConfig(resident="off"))
    poses2 = _chain_world(mm2, 20, np.random.default_rng(7))
    opt2.add_new_data(2, 15, _closure(poses2, 2, 15),
                      np.eye(6, dtype=np.float32) * 0.01)
    opt2.add_new_data(1, 18, _closure(poses2, 1, 18),
                      np.eye(6, dtype=np.float32) * 0.01)
    g, g2 = mm.get_graph(), mm2.get_graph()
    np.testing.assert_array_equal(g.optimized_poses[:g.n_vertices],
                                  g2.optimized_poses[:g2.n_vertices])
