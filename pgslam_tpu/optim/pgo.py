"""SE(3) pose-graph optimization: jitted Levenberg-Marquardt with batched
6x6 Jacobian blocks and block-Jacobi preconditioned conjugate gradient.

Replacement for the reference's GTSAM back-end
(``BetweenFactor<Pose3>`` + ``PriorFactor`` + LM, ``Optimizer.hpp:68,
89-130``). Where GTSAM builds a sparse factor graph and runs sparse
Cholesky on the host, we keep everything as fixed-shape arrays:

* residuals/Jacobians of all E between-factors are computed batched
  (``[E, 6]`` / ``[E, 6, 6]``),
* the normal-equation operator ``H x`` is applied matrix-free via
  ``segment_sum`` scatters (never materializing H),
* the linear solve is block-Jacobi PCG with a fixed iteration cap inside
  ``lax.while_loop`` — one XLA dispatch for the whole LM optimization.

Conventions: twists/covariances are in PM order [t; r] end-to-end (the
reference's [t;r] -> GTSAM [r;t] reorder at ``Optimizer.hpp:33-42`` is not
needed internally; see :func:`pgslam_tpu.optimizer.pm_cov_to_gtsam_cov`
for the parity helper). The anchor vertex gets a near-rigid prior with
sigma = 1e-6 (``Optimizer.hpp:124-130``).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from .. import se3


@dataclasses.dataclass(frozen=True)
class PGOConfig:
    max_iterations: int = 50          # LM outer iterations
    # Linear solver:
    #   "pcg"      — matrix-free block-Jacobi CG.
    #   "cholesky" — dense 6Vx6V factorization; exact Newton steps.
    #   "auto"     — cholesky while 6V <= 8192, else pcg.
    solver: str = "pcg"
    cg_iterations: int = 64           # CG cap per linear solve
    # Inexact-Newton: the LM step only needs a rough solve; 1e-4 on the
    # squared residual (1% on ||r||) costs ~15 CG iters with the
    # block-Jacobi preconditioner and LM absorbs the inexactness.
    cg_tol: float = 1e-4              # relative residual reduction
    lambda_init: float = 1e-6
    lambda_up: float = 10.0
    lambda_down: float = 0.1
    prior_sigma: float = 1e-6         # Optimizer.hpp:128
    min_step_norm: float = 1e-8       # convergence: ||delta||
    min_cost_decrease: float = 1e-7   # convergence: relative cost change
    # Edge<->vertex data movement inside the LM loop: "auto" gathers by
    # index and scatters with segment_sum; "incidence" lowers every
    # gather/scatter to a matmul with a dense one-hot [E, V] matrix
    # (V*E floats each for from/to).
    assembly: str = "auto"
    # Robust kernel on edge residuals (beyond the reference, which uses
    # plain Gaussian noise models), applied as IRLS weights on each
    # edge's information. "huber" bounds an outlier's influence (linear
    # tail — good for moderately heavy tails); "cauchy" and "gm"
    # (Geman-McClure) are redescending — a grossly wrong loop closure's
    # influence decays toward zero instead of pulling linearly forever,
    # which is what survives aliased scan matches. "none" reproduces the
    # reference exactly. delta is the inlier scale in whitened-residual
    # units (||e||_Omega).
    robust: str = "none"
    robust_delta: float = 1.0


def _ad(xi: jax.Array) -> jax.Array:
    """SE(3) adjoint of a twist (little ad), [t; r] order:
    ad(xi) = [[hat(w), hat(v)], [0, hat(w)]]."""
    v, w = xi[..., :3], xi[..., 3:]
    hw = se3.hat(w)
    hv = se3.hat(v)
    zero = jnp.zeros_like(hw)
    top = jnp.concatenate([hw, hv], axis=-1)
    bot = jnp.concatenate([zero, hw], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def _inv3(A: jax.Array) -> jax.Array:
    """Batched closed-form 3x3 inverse via the adjugate."""
    c1 = jnp.cross(A[..., 1, :], A[..., 2, :])
    c2 = jnp.cross(A[..., 2, :], A[..., 0, :])
    c3 = jnp.cross(A[..., 0, :], A[..., 1, :])
    det = jnp.sum(A[..., 0, :] * c1, axis=-1)[..., None, None]
    adjT = jnp.stack([c1, c2, c3], axis=-1)          # adj^T columns
    return adjT / det


def spd_inverse6(M: jax.Array) -> jax.Array:
    """Batched closed-form inverse of SPD 6x6 blocks via the Schur
    complement of the leading 3x3 block.

    ``jnp.linalg.inv`` on [N, 6, 6] lowers to tiny batched LU loops;
    this closed form is a handful of fused batched ops.
    """
    A = M[..., :3, :3]
    B = M[..., :3, 3:]
    C = M[..., 3:, 3:]
    Ai = _inv3(A)
    AiB = Ai @ B
    S = C - jnp.swapaxes(B, -1, -2) @ AiB
    Si = _inv3(S)
    AiBSi = AiB @ Si
    TL = Ai + AiBSi @ jnp.swapaxes(AiB, -1, -2)
    TR = -AiBSi
    return jnp.concatenate([
        jnp.concatenate([TL, TR], axis=-1),
        jnp.concatenate([jnp.swapaxes(TR, -1, -2), Si], axis=-1),
    ], axis=-2)


def _jr_inv(e: jax.Array) -> jax.Array:
    """Inverse right Jacobian of SE(3), 2nd-order approximation:
    Jr^-1(e) ~= I + ad(e)/2 + ad(e)^2/12. Exact enough near convergence
    (residuals are small); LM handles the large-residual regime."""
    a = _ad(e)
    I = jnp.broadcast_to(jnp.eye(6, dtype=e.dtype), a.shape)
    return I + 0.5 * a + (1.0 / 12.0) * (a @ a)


@functools.partial(jax.jit, static_argnames=("config",))
def optimize_pose_graph(poses: jax.Array,        # [V, 4, 4] initial values
                        vmask: jax.Array,        # [V] valid vertices
                        edge_from: jax.Array,    # [E] int32
                        edge_to: jax.Array,      # [E] int32
                        edge_T: jax.Array,       # [E, 4, 4] measurements
                        edge_cov: jax.Array,     # [E, 6, 6] PM order
                        emask: jax.Array,        # [E] valid edges
                        fixed_id: jax.Array,     # scalar int32 anchor
                        robust_emask: jax.Array | None = None,  # [E] where
                        # the robust kernel applies (None = every edge);
                        # production systems robustify loop closures only —
                        # odometry is trusted, so its quadratic cost must
                        # not saturate
                        *, config: PGOConfig = PGOConfig()):
    """Run LM on the pose graph; returns (optimized_poses, stats dict).

    One jitted dispatch: assembly, block-Jacobi PCG or dense Cholesky
    solve, retraction and accept/reject all run inside one
    ``lax.while_loop``. Padded entries (vmask/emask False) contribute
    nothing and their poses pass through unchanged. Shapes are static:
    pad V/E to bucket sizes to avoid recompilation as the graph grows.
    """
    V = poses.shape[0]
    E = edge_from.shape[0]
    dtype = poses.dtype

    prior_info = jnp.asarray(1.0 / config.prior_sigma ** 2, dtype)
    prior_Tinv = se3.inverse(poses[fixed_id])
    Tinv_meas = se3.inverse(edge_T)
    # Closed-form SPD inverse (see spd_inverse6). Masked edges are zeroed
    # below, so guard them with identity to keep the inverse finite.
    cov_safe = jnp.where(emask[:, None, None], edge_cov,
                         jnp.eye(6, dtype=dtype))
    info = spd_inverse6(cov_safe)
    info = jnp.where(emask[:, None, None], info, 0.0)
    # Clamp padded edge endpoints into range (gathers stay in-bounds).
    edge_from = jnp.clip(edge_from, 0, V - 1)
    edge_to = jnp.clip(edge_to, 0, V - 1)

    if config.assembly not in ("auto", "incidence"):
        raise ValueError(f"unknown PGO assembly {config.assembly!r}")
    if config.assembly == "incidence":
        # One-hot incidence matrices: gather x[edge_from] == Sf @ x and
        # segment_sum(y, edge_from) == Sf.T @ y, both matmuls with no
        # scatter; "highest" matmul precision keeps the one-hot selection
        # exact in f32 (TF32 would round the gathered values).
        Sf = jax.nn.one_hot(edge_from, V, dtype=dtype)        # [E, V]
        St = jax.nn.one_hot(edge_to, V, dtype=dtype)
        _hp = jax.lax.Precision.HIGHEST

        def gather(x, S):
            return jnp.matmul(S, x.reshape(V, -1),
                              precision=_hp).reshape((E,) + x.shape[1:])

        def scatter_add(y, S):
            return jnp.matmul(S.T, y.reshape(E, -1),
                              precision=_hp).reshape((V,) + y.shape[1:])

        gather_f = lambda x: gather(x, Sf)
        gather_t = lambda x: gather(x, St)
        scatter_f = lambda y: scatter_add(y, Sf)
        scatter_t = lambda y: scatter_add(y, St)
    else:
        gather_f = lambda x: x[edge_from]
        gather_t = lambda x: x[edge_to]
        scatter_f = lambda y: jax.ops.segment_sum(y, edge_from,
                                                  num_segments=V)
        scatter_t = lambda y: jax.ops.segment_sum(y, edge_to,
                                                  num_segments=V)

    def edge_residuals(cur):
        """e_k = Log(Z_k^-1 X_f^-1 X_t) for all edges, batched."""
        Xf = gather_f(cur)
        Xt = gather_t(cur)
        M = se3.inverse(Xf) @ Xt
        return se3.log(Tinv_meas @ M), M

    def robust_weight(e):
        """IRLS weight per edge for the configured robust kernel."""
        if config.robust == "none":
            return None
        chi2 = jnp.einsum("ei,eij,ej->e", e, info, e)
        r = jnp.sqrt(jnp.maximum(chi2, 1e-30))
        d = config.robust_delta
        if config.robust == "huber":
            w = jnp.minimum(1.0, d / r)
        elif config.robust == "cauchy":
            w = 1.0 / (1.0 + chi2 / (d * d))
        elif config.robust == "gm":
            w = (d * d / (d * d + chi2)) ** 2
        else:
            raise ValueError(f"unknown robust kernel {config.robust!r}")
        if robust_emask is not None:
            w = jnp.where(robust_emask, w, 1.0)
        return w

    def build_system(cur):
        """Residuals + per-edge H blocks + gradient b (as [V, 6])."""
        e, M = edge_residuals(cur)
        rw = robust_weight(e)
        info_e = info if rw is None else info * rw[:, None, None]
        Jri = _jr_inv(e)
        Jt = Jri                                     # [E, 6, 6]
        Jf = -Jri @ se3.adjoint(se3.inverse(M))      # -Jr^-1 Ad(Xt^-1 Xf)
        JtT_O = jnp.swapaxes(Jt, -1, -2) @ info_e
        JfT_O = jnp.swapaxes(Jf, -1, -2) @ info_e
        H_tt = JtT_O @ Jt
        H_ff = JfT_O @ Jf
        H_ft = JfT_O @ Jt
        b_t = jnp.einsum("eij,ej->ei", JtT_O, e)
        b_f = jnp.einsum("eij,ej->ei", JfT_O, e)
        b = scatter_f(b_f) + scatter_t(b_t)
        # Prior on the anchor: r_p = Log(P^-1 X), J ~= I.
        rp = se3.log(prior_Tinv @ cur[fixed_id])
        b = b.at[fixed_id].add(prior_info * rp)
        # Block-diagonal of H (for damping + preconditioner).
        D = scatter_f(H_ff) + scatter_t(H_tt)
        D = D.at[fixed_id].add(prior_info * jnp.eye(6, dtype=dtype))
        return (H_ff, H_tt, H_ft), b, D

    def matvec(blocks, D, lam, x):
        """y = (H + lam * diag(D)) x, matrix-free. x [V, 6]."""
        H_ff, H_tt, H_ft = blocks
        xf = gather_f(x)
        xt = gather_t(x)
        yf = (jnp.einsum("eij,ej->ei", H_ff, xf)
              + jnp.einsum("eij,ej->ei", H_ft, xt))
        yt = (jnp.einsum("eij,ej->ei", H_tt, xt)
              + jnp.einsum("eji,ej->ei", H_ft, xf))   # H_tf = H_ft^T
        y = scatter_f(yf) + scatter_t(yt)
        y = y.at[fixed_id].add(prior_info * x[fixed_id])
        diag = jnp.diagonal(D, axis1=-2, axis2=-1)      # [V, 6]
        return y + lam * diag * x

    def pcg(blocks, D, lam, b):
        """Block-Jacobi PCG for (H + lam diag) x = -b."""
        # Preconditioner: invert per-vertex 6x6 diag blocks (+ damping).
        diag_term = lam * jnp.diagonal(D, axis1=-2, axis2=-1)
        P = D + jax.vmap(jnp.diag)(diag_term)
        # Guard padded vertices with identity blocks.
        P = jnp.where(vmask[:, None, None], P, jnp.eye(6, dtype=dtype))
        P_inv = spd_inverse6(P + 1e-10 * jnp.eye(6, dtype=dtype))

        rhs = -b
        x0 = jnp.zeros_like(rhs)
        r0 = rhs  # since x0 = 0
        z0 = jnp.einsum("vij,vj->vi", P_inv, r0)
        p0 = z0
        rz0 = jnp.sum(r0 * z0)
        rhs_norm2 = jnp.maximum(jnp.sum(rhs * rhs), 1e-30)

        def cond(s):
            _, r, _, _, it = s
            return jnp.logical_and(
                it < config.cg_iterations,
                jnp.sum(r * r) > config.cg_tol * rhs_norm2)

        def body(s):
            x, r, p, rz, it = s
            Ap = matvec(blocks, D, lam, p)
            alpha = rz / jnp.maximum(jnp.sum(p * Ap), 1e-30)
            x = x + alpha * p
            r = r - alpha * Ap
            z = jnp.einsum("vij,vj->vi", P_inv, r)
            rz_new = jnp.sum(r * z)
            beta = rz_new / jnp.maximum(rz, 1e-30)
            p = z + beta * p
            return (x, r, p, rz_new, it + 1)

        x, _, _, _, n_iter = jax.lax.while_loop(
            cond, body, (x0, r0, p0, rz0, jnp.int32(0)))
        return x, n_iter

    def dense_solve(blocks, D, lam, b):
        """Assemble the full 6Vx6V normal matrix and Cholesky-solve.

        The scatter builds [V, V, 6, 6] block grid (V^2*36 floats — fine
        for V up to a few thousand), then one factorization replaces
        ~50 preconditioned CG sweeps.
        """
        H_ff, H_tt, H_ft = blocks
        Hb = jnp.zeros((V, V, 6, 6), dtype)
        Hb = Hb.at[edge_from, edge_from].add(H_ff)
        Hb = Hb.at[edge_to, edge_to].add(H_tt)
        Hb = Hb.at[edge_from, edge_to].add(H_ft)
        Hb = Hb.at[edge_to, edge_from].add(jnp.swapaxes(H_ft, -1, -2))
        H = Hb.transpose(0, 2, 1, 3).reshape(6 * V, 6 * V)
        prior_block = prior_info * jnp.eye(6, dtype=dtype)
        H = jax.lax.dynamic_update_slice(
            H, jax.lax.dynamic_slice(H, (6 * fixed_id, 6 * fixed_id), (6, 6))
            + prior_block, (6 * fixed_id, 6 * fixed_id))
        # LM damping on the diagonal (same scaling as the PCG path) +
        # identity blocks for padded vertices so the factorization exists.
        diag_scale = jnp.diagonal(D, axis1=-2, axis2=-1).reshape(-1)
        pad = jnp.repeat(~vmask, 6)
        damped = jnp.diag(lam * diag_scale + jnp.where(pad, 1.0, 0.0)
                          + 1e-8)
        L = jnp.linalg.cholesky(H + damped)
        x = jax.scipy.linalg.cho_solve((L, True), -b.reshape(-1))
        return x.reshape(V, 6), jnp.int32(0)

    if config.solver == "cholesky" or (config.solver == "auto"
                                       and 6 * V <= 8192):
        solve = dense_solve
    elif config.solver in ("pcg", "auto"):
        solve = pcg
    else:
        raise ValueError(f"unknown PGO solver {config.solver!r}")

    def retract(cur, delta):
        """X_i <- X_i exp(delta_i), masked to valid vertices."""
        step = se3.exp(delta)
        new = cur @ step
        return jnp.where(vmask[:, None, None], new, cur)

    def cost_fn(cur):
        e, _ = edge_residuals(cur)
        c = jnp.einsum("ei,eij,ej->e", e, info, e)
        d = config.robust_delta
        # rho(chi2) consistent with the IRLS weights so LM accept/reject
        # sees the same objective the steps descend.
        if config.robust != "none":
            if config.robust == "huber":
                r = jnp.sqrt(jnp.maximum(c, 1e-30))
                rho = jnp.where(r <= d, c, 2.0 * d * r - d * d)
            elif config.robust == "cauchy":
                rho = d * d * jnp.log1p(c / (d * d))
            elif config.robust == "gm":
                rho = d * d * c / (d * d + c)
            c = rho if robust_emask is None else jnp.where(robust_emask,
                                                           rho, c)
        cost = jnp.sum(jnp.where(emask, c, 0.0))
        rp = se3.log(prior_Tinv @ cur[fixed_id])
        return cost + prior_info * jnp.sum(rp * rp)

    def lm_cond(state):
        _, _, it, done, _ = state
        return jnp.logical_and(it < config.max_iterations, ~done)

    def lm_body(state):
        cur, lam, it, _, cost = state
        blocks, b, D = build_system(cur)
        delta, _ = solve(blocks, D, lam, b)
        delta = jnp.where(vmask[:, None], delta, 0.0)
        candidate = retract(cur, delta)
        new_cost = cost_fn(candidate)
        accept = new_cost < cost
        cur = jnp.where(accept, candidate, cur)
        lam = jnp.where(accept, lam * config.lambda_down,
                        lam * config.lambda_up)
        lam = jnp.clip(lam, 1e-12, 1e10)
        step_norm = jnp.linalg.norm(delta)
        rel_decrease = (cost - new_cost) / jnp.maximum(cost, 1e-30)
        done = jnp.logical_and(
            accept,
            jnp.logical_or(step_norm < config.min_step_norm,
                           rel_decrease < config.min_cost_decrease))
        cost = jnp.where(accept, new_cost, cost)
        return (cur, lam, it + 1, done, cost)

    init_cost = cost_fn(poses)
    final, lam, n_iter, _, final_cost = jax.lax.while_loop(
        lm_cond, lm_body,
        (poses, jnp.asarray(config.lambda_init, dtype), jnp.int32(0),
         jnp.bool_(False), init_cost))
    final = se3.normalize_rotation_fast(final)
    final = jnp.where(vmask[:, None, None], final, poses)
    stats = {"initial_cost": init_cost, "final_cost": final_cost,
             "iterations": n_iter, "lambda": lam}
    return final, stats


@functools.partial(jax.jit, static_argnames=("method",))
def pose_marginals(poses: jax.Array,        # [V, 4, 4] (optimized) values
                   vmask: jax.Array,
                   edge_from: jax.Array,
                   edge_to: jax.Array,
                   edge_T: jax.Array,
                   edge_cov: jax.Array,
                   emask: jax.Array,
                   fixed_id: jax.Array,
                   prior_sigma: float = 1e-6,
                   method: str = "dense") -> jax.Array:
    """Per-vertex 6x6 marginal covariances of the pose graph at ``poses``
    (PM [t; r] twist order) — the GTSAM ``Marginals`` capability, which
    the reference never exposes despite linking it.

    ``method="dense"`` inverts the full damped information matrix and
    extracts the diagonal blocks (exact Gaussian marginals). It
    materializes a [V, V, 6, 6] block tensor plus the dense 6Vx6V
    matrix — 144*V^2 bytes each (~150 MB at V=1024) — so keep V under
    ~1-2k on a small-RAM host. ``method="block_diag"`` inverts only the
    block-diagonal of H — the conditional covariance given all
    neighbors; a cheap optimistic bound useful as a relative confidence
    signal at any scale.
    """
    V = poses.shape[0]
    dtype = poses.dtype
    prior_info = jnp.asarray(1.0 / prior_sigma ** 2, dtype)
    edge_from = jnp.clip(edge_from, 0, V - 1)
    edge_to = jnp.clip(edge_to, 0, V - 1)
    cov_safe = jnp.where(emask[:, None, None], edge_cov,
                         jnp.eye(6, dtype=dtype))
    info = jnp.where(emask[:, None, None], spd_inverse6(cov_safe), 0.0)

    Xf = poses[edge_from]
    Xt = poses[edge_to]
    M = se3.inverse(Xf) @ Xt
    e = se3.log(se3.inverse(edge_T) @ M)
    Jri = _jr_inv(e)
    Jf = -Jri @ se3.adjoint(se3.inverse(M))
    JtT_O = jnp.swapaxes(Jri, -1, -2) @ info
    JfT_O = jnp.swapaxes(Jf, -1, -2) @ info
    H_ff = JfT_O @ Jf
    H_tt = JtT_O @ Jri
    H_ft = JfT_O @ Jri

    D = (jax.ops.segment_sum(H_ff, edge_from, num_segments=V)
         + jax.ops.segment_sum(H_tt, edge_to, num_segments=V))
    D = D.at[fixed_id].add(prior_info * jnp.eye(6, dtype=dtype))
    # Regularize padded / unconstrained vertices so the inverse exists.
    D = jnp.where(vmask[:, None, None], D, jnp.eye(6, dtype=dtype))

    if method == "block_diag":
        out = spd_inverse6(D + 1e-8 * jnp.eye(6, dtype=dtype))
        return jnp.where(vmask[:, None, None], out, 0.0)

    Hb = jnp.zeros((V, V, 6, 6), dtype)
    Hb = Hb.at[edge_from, edge_from].add(H_ff)
    Hb = Hb.at[edge_to, edge_to].add(H_tt)
    Hb = Hb.at[edge_from, edge_to].add(H_ft)
    Hb = Hb.at[edge_to, edge_from].add(jnp.swapaxes(H_ft, -1, -2))
    H = Hb.transpose(0, 2, 1, 3).reshape(6 * V, 6 * V)
    didx = jnp.arange(6 * V)
    prior_rows = (didx // 6) == fixed_id
    H = H.at[didx, didx].add(jnp.where(prior_rows, prior_info, 0.0))
    pad = jnp.repeat(~vmask, 6)
    H = H.at[didx, didx].add(jnp.where(pad, 1.0, 1e-8))
    Sigma = jnp.linalg.inv(H)
    blocks = Sigma.reshape(V, 6, V, 6)[jnp.arange(V), :, jnp.arange(V), :]
    return jnp.where(vmask[:, None, None], blocks, 0.0)
