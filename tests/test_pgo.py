import jax.numpy as jnp
import numpy as np
import pytest

from pgslam_tpu import se3
from pgslam_tpu.optim.pgo import PGOConfig, optimize_pose_graph


def _pad(arr, n, shape_tail):
    out = np.zeros((n,) + shape_tail, np.float32)
    out[:len(arr)] = arr
    return jnp.asarray(out)


def make_problem(poses, edges, V_pad=None, E_pad=None):
    """edges: list of (i, j, T_meas [4,4], cov [6,6])"""
    V = V_pad or len(poses)
    E = E_pad or len(edges)
    vmask = jnp.arange(V) < len(poses)
    emask = jnp.arange(E) < len(edges)
    ef = np.zeros(E, np.int32)
    et = np.zeros(E, np.int32)
    eT = np.tile(np.eye(4, dtype=np.float32), (E, 1, 1))
    ec = np.tile(np.eye(6, dtype=np.float32), (E, 1, 1))
    for k, (i, j, T, c) in enumerate(edges):
        ef[k], et[k], eT[k], ec[k] = i, j, T, c
    P = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    P[:len(poses)] = poses
    return (jnp.asarray(P), vmask, jnp.asarray(ef), jnp.asarray(et),
            jnp.asarray(eT), jnp.asarray(ec), emask, jnp.int32(0))


def relpose(Ti, Tj):
    return np.asarray(se3.inverse(jnp.asarray(Ti)) @ jnp.asarray(Tj))


def square_trajectory(noise=0.0, rng=None):
    """4 poses on a unit square with perfect odometry + loop edge."""
    true = []
    for k, (x, y) in enumerate([(0, 0), (1, 0), (1, 1), (0, 1)]):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [x, y, 0]
        true.append(T)
    cov = (np.eye(6) * 0.01).astype(np.float32)
    edges = []
    for i in range(3):
        edges.append((i, i + 1, relpose(true[i], true[i + 1]), cov))
    edges.append((3, 0, relpose(true[3], true[0]), cov))
    init = [t.copy() for t in true]
    if rng is not None and noise > 0:
        for i in range(1, 4):
            tw = rng.normal(size=6).astype(np.float32) * noise
            init[i] = np.asarray(jnp.asarray(init[i]) @ se3.exp(jnp.asarray(tw)))
    return true, init, edges


def test_noise_free_square_stays_put(rng):
    true, init, edges = square_trajectory()
    args = make_problem(init, edges)
    out, stats = optimize_pose_graph(*args, config=PGOConfig())
    for i in range(4):
        np.testing.assert_allclose(np.asarray(out)[i], true[i], atol=1e-4)
    assert float(stats["final_cost"]) < 1e-6


def test_perturbed_square_recovers(rng):
    true, init, edges = square_trajectory(noise=0.1, rng=rng)
    args = make_problem(init, edges)
    out, stats = optimize_pose_graph(*args)
    out = np.asarray(out)
    for i in range(4):
        err = np.asarray(se3.log(
            se3.inverse(jnp.asarray(out[i])) @ jnp.asarray(true[i])))
        assert np.linalg.norm(err) < 1e-3, f"pose {i} err {err}"
    assert float(stats["final_cost"]) < 1e-5 * float(stats["initial_cost"]) \
        or float(stats["final_cost"]) < 1e-6


def test_padding_invariance(rng):
    true, init, edges = square_trajectory(noise=0.05, rng=rng)
    out1, _ = optimize_pose_graph(*make_problem(init, edges))
    out2, _ = optimize_pose_graph(*make_problem(init, edges, V_pad=16,
                                                E_pad=32))
    np.testing.assert_allclose(np.asarray(out1), np.asarray(out2)[:4],
                               atol=1e-4)


def test_anchor_stays_fixed(rng):
    true, init, edges = square_trajectory(noise=0.2, rng=rng)
    out, _ = optimize_pose_graph(*make_problem(init, edges))
    np.testing.assert_allclose(np.asarray(out)[0], init[0], atol=1e-4)


def test_loop_drift_correction(rng):
    """Odometry drifts; loop edge snaps the ring back (config-3 analog)."""
    n = 20
    radius = 5.0
    true = []
    for k in range(n):
        a = 2 * np.pi * k / n
        T = np.asarray(se3.exp(jnp.asarray(
            [radius * np.cos(a), radius * np.sin(a), 0, 0, 0, a],
            jnp.float32)))
        true.append(np.asarray(T, np.float32))
    cov = (np.eye(6) * 0.01).astype(np.float32)
    edges = []
    init = [true[0]]
    drift = se3.exp(jnp.asarray([0.02, 0.01, 0, 0, 0, 0.004], jnp.float32))
    for i in range(1, n):
        meas = jnp.asarray(relpose(true[i - 1], true[i])) @ drift
        edges.append((i - 1, i, np.asarray(meas), cov))
        init.append(np.asarray(jnp.asarray(init[-1]) @ meas))
    # exact loop closure 19 -> 0
    edges.append((n - 1, 0, relpose(true[n - 1], true[0]),
                  (np.eye(6) * 1e-4).astype(np.float32)))
    out, stats = optimize_pose_graph(*make_problem(init, edges))
    out = np.asarray(out)
    # Drifted init should end far from truth; optimized must be closer.
    init_err = np.linalg.norm(init[-1][:3, 3] - true[-1][:3, 3])
    opt_err = np.linalg.norm(out[-1][:3, 3] - true[-1][:3, 3])
    assert opt_err < 0.3 * init_err
    assert float(stats["final_cost"]) < float(stats["initial_cost"])


def test_disconnected_components_stay_bounded(rng):
    """A component without the anchor has gauge freedom; damped LM must
    leave consistent (zero-residual) poses where they are, not drift."""
    # Two 3-pose chains, no connection; anchor in component 0.
    poses = [np.eye(4, dtype=np.float32) for _ in range(6)]
    for i in range(6):
        poses[i] = poses[i].copy()
        poses[i][0, 3] = float(i)
    cov = (np.eye(6) * 0.01).astype(np.float32)
    edges = [(0, 1, relpose(poses[0], poses[1]), cov),
             (1, 2, relpose(poses[1], poses[2]), cov),
             (3, 4, relpose(poses[3], poses[4]), cov),
             (4, 5, relpose(poses[4], poses[5]), cov)]
    out, stats = optimize_pose_graph(*make_problem(poses, edges))
    out = np.asarray(out)
    for i in range(6):
        np.testing.assert_allclose(out[i], poses[i], atol=1e-3)


def test_pose_marginals_chain_uncertainty_grows():
    """Dense marginals: anchor is pinned by the prior; uncertainty
    accumulates with graph distance from it; the block-diagonal
    (conditional) covariance never exceeds the true marginal."""
    import jax
    import jax.numpy as jnp

    from pgslam_tpu import se3
    from pgslam_tpu.optim.pgo import pose_marginals

    V = 6
    poses = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    poses[:, 0, 3] = np.arange(V, dtype=np.float32)
    ef = np.arange(V - 1, dtype=np.int32)
    et = ef + 1
    Ts = np.einsum("eij,ejk->eik", np.linalg.inv(poses[ef]), poses[et])
    covs = np.tile((np.eye(6, dtype=np.float32) * 0.01), (V - 1, 1, 1))
    vmask = np.ones(V, bool)
    emask = np.ones(V - 1, bool)
    args = (jnp.asarray(poses), jnp.asarray(vmask), jnp.asarray(ef),
            jnp.asarray(et), jnp.asarray(Ts.astype(np.float32)),
            jnp.asarray(covs), jnp.asarray(emask), jnp.int32(0))
    dense = np.asarray(pose_marginals(*args, method="dense"))
    bd = np.asarray(pose_marginals(*args, method="block_diag"))
    tr = np.trace(dense, axis1=1, axis2=2)
    # anchor pinned to the prior scale
    assert tr[0] < 1e-8
    # strictly growing uncertainty down the chain
    assert np.all(np.diff(tr) > 0)
    # chain tail accumulates ~k * edge covariance
    np.testing.assert_allclose(tr[1], 0.06, rtol=0.15)
    # conditional (block-diag) covariance <= marginal, interior vertices
    tr_bd = np.trace(bd, axis1=1, axis2=2)
    assert np.all(tr_bd[1:-1] <= tr[1:-1] + 1e-9)
    # symmetric SPD blocks
    np.testing.assert_allclose(dense, np.swapaxes(dense, 1, 2), atol=1e-7)


def _ring_problem(V, n_loops, rng, noise=0.02):
    """V poses on a circle: odometry chain plus ``n_loops`` closures with
    noisy measurements, and a perturbed initial guess."""
    true = []
    for i in range(V):
        a = 2 * np.pi * i / V
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.asarray(se3.exp_so3(jnp.asarray([0.0, 0.0, a],
                                                       jnp.float32)))
        T[:3, 3] = [10 * np.cos(a), 10 * np.sin(a), 0.1 * np.sin(3 * a)]
        true.append(T)
    cov = (np.eye(6) * 0.01).astype(np.float32)
    pairs = [(i, i + 1) for i in range(V - 1)]
    pairs += [tuple(sorted(rng.choice(V, 2, replace=False)))
              for _ in range(n_loops)]
    edges = []
    for i, j in pairs:
        tw = (rng.normal(size=6) * noise).astype(np.float32)
        Z = relpose(true[i], true[j]) @ np.asarray(se3.exp(jnp.asarray(tw)))
        edges.append((i, j, Z.astype(np.float32), cov))
    init = [true[0]] + [
        (t @ np.asarray(se3.exp(jnp.asarray(
            (rng.normal(size=6) * 0.05).astype(np.float32))))).astype(
                np.float32) for t in true[1:]]
    return true, init, edges


@pytest.mark.parametrize("V", [64, 500, 1024])
def test_segment_sum_matches_incidence_assembly(V):
    # "auto" assembles with segment_sum on every platform; the one-hot
    # incidence matmuls are an explicit option and must solve the same
    # problem (summation order differs, so not bitwise).
    rng = np.random.default_rng(V)
    _, init, edges = _ring_problem(V, V // 16, rng)
    args = make_problem(init, edges)
    kw = dict(max_iterations=4, cg_iterations=30)
    out_s, st_s = optimize_pose_graph(*args, config=PGOConfig(**kw))
    out_i, st_i = optimize_pose_graph(
        *args, config=PGOConfig(assembly="incidence", **kw))
    np.testing.assert_allclose(np.asarray(out_s), np.asarray(out_i),
                               atol=2e-4)
    np.testing.assert_allclose(float(st_s["final_cost"]),
                               float(st_i["final_cost"]), rtol=1e-3)


@pytest.mark.parametrize("assembly", ["scatter", "onehot"])
def test_unknown_assembly_rejected(assembly):
    rng = np.random.default_rng(0)
    _, init, edges = _ring_problem(8, 1, rng)
    with pytest.raises(ValueError, match="assembly"):
        optimize_pose_graph(*make_problem(init, edges),
                            config=PGOConfig(assembly=assembly))


def _gauss_newton_f64(init, edges, prior_sigma=1e-6, iters=8):
    """Dense float64 Gauss-Newton on the same cost as optimize_pose_graph
    (e = Log(Z^-1 Xf^-1 Xt), right perturbations, anchor prior on vertex
    0), with central-difference Jacobians and scipy's expm/logm."""
    from scipy.linalg import expm, logm

    def hat6(x):
        M = np.zeros((4, 4))
        v, w = x[:3], x[3:]
        M[:3, :3] = [[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]
        M[:3, 3] = v
        return M

    def vee6(M):
        M = np.real(M)
        return np.array([M[0, 3], M[1, 3], M[2, 3],
                         M[2, 1], M[0, 2], M[1, 0]])

    X = [np.asarray(T, np.float64) for T in init]
    P0inv = np.linalg.inv(X[0])
    Ls = [np.linalg.cholesky(np.linalg.inv(np.asarray(c, np.float64))).T
          for (_, _, _, c) in edges]
    Zinv = [np.linalg.inv(np.asarray(Z, np.float64)) for (_, _, Z, _) in edges]

    def residual(Xs):
        r = [L @ vee6(logm(Zi @ np.linalg.inv(Xs[i]) @ Xs[j]))
             for L, Zi, (i, j, _, _) in zip(Ls, Zinv, edges)]
        r.append(vee6(logm(P0inv @ Xs[0])) / prior_sigma)
        return np.concatenate(r)

    n = len(X)
    for _ in range(iters):
        r0 = residual(X)
        J = np.zeros((len(r0), 6 * n))
        h = 1e-6
        for k in range(6 * n):
            d = np.zeros(6)
            d[k % 6] = h
            Xp = list(X)
            Xm = list(X)
            Xp[k // 6] = X[k // 6] @ expm(hat6(d))
            Xm[k // 6] = X[k // 6] @ expm(hat6(-d))
            J[:, k] = (residual(Xp) - residual(Xm)) / (2 * h)
        delta = np.linalg.lstsq(J, -r0, rcond=None)[0]
        X = [X[i] @ expm(hat6(delta[6 * i:6 * i + 6])) for i in range(n)]
        if np.linalg.norm(delta) < 1e-9:
            break
    return np.stack(X)


def test_optimize_matches_float64_gauss_newton():
    rng = np.random.default_rng(3)
    _, init, edges = _ring_problem(6, 2, rng, noise=0.05)
    out, _ = optimize_pose_graph(
        *make_problem(init, edges),
        config=PGOConfig(cg_iterations=200, cg_tol=1e-12))
    ref = _gauss_newton_f64(init, edges)
    np.testing.assert_allclose(np.asarray(out)[:, :3, 3], ref[:, :3, 3],
                               atol=2e-3)
    np.testing.assert_allclose(np.asarray(out)[:, :3, :3], ref[:, :3, :3],
                               atol=2e-4)
