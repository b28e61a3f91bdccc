"""SE(3) Lie-group utilities, fully batched and jit-friendly.

Conventions
-----------
* Rigid transforms are stored as homogeneous ``[..., 4, 4]`` matrices
  (same storage as the reference's libpointmatcher ``Matrix``,
  ``/root/reference/src/pgslam/types.h:22``).
* Twists are 6-vectors ordered ``[tx, ty, tz, rx, ry, rz]`` — translation
  first, matching libpointmatcher's covariance ordering (the reference
  reorders this to GTSAM's ``[r; t]`` in ``Optimizer.hpp:33-42``; we keep a
  single convention end-to-end and expose the reorder helper in
  :mod:`pgslam_tpu.optimizer` for parity).
* All functions broadcast over leading batch dimensions, making them safe
  to ``vmap``/``jit`` and to use inside ``lax.scan``/``lax.while_loop``.

Numerics: small-angle branches use Taylor expansions selected with
``jnp.where`` so gradients stay finite under jit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def hat(w: jax.Array) -> jax.Array:
    """Skew-symmetric matrix of a 3-vector: ``hat(w) @ v == cross(w, v)``."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = jnp.zeros_like(wx)
    rows = [
        jnp.stack([zeros, -wz, wy], axis=-1),
        jnp.stack([wz, zeros, -wx], axis=-1),
        jnp.stack([-wy, wx, zeros], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def vee(W: jax.Array) -> jax.Array:
    """Inverse of :func:`hat`."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def _sinc_coeffs(theta: jax.Array):
    """Return (A, B, C) coefficients of the Rodrigues/SE(3) formulas.

    A = sin(t)/t, B = (1-cos(t))/t^2, C = (1-A)/t^2, with Taylor fallbacks.
    The Taylor branch is taken for t < ~0.03: in float32, 1-cos(t)
    catastrophically cancels well before that (cos rounds to 1.0 at
    t ~ 3e-4), while the truncated series is accurate to ~1e-9 there.
    """
    t2 = theta * theta
    small = t2 < 1e-3
    # Guard against division by zero under jit.
    safe_t2 = jnp.where(small, 1.0, t2)
    theta_safe = jnp.sqrt(safe_t2)
    t4 = t2 * t2
    A = jnp.where(small, 1.0 - t2 / 6.0 + t4 / 120.0,
                  jnp.sin(theta_safe) / theta_safe)
    B = jnp.where(small, 0.5 - t2 / 24.0 + t4 / 720.0,
                  (1.0 - jnp.cos(theta_safe)) / safe_t2)
    C = jnp.where(small, 1.0 / 6.0 - t2 / 120.0 + t4 / 5040.0,
                  (1.0 - A) / safe_t2)
    return A, B, C


def exp_so3(w: jax.Array) -> jax.Array:
    """SO(3) exponential: rotation vector ``[..., 3]`` -> rotation matrix."""
    theta = jnp.linalg.norm(w, axis=-1)
    A, B, _ = _sinc_coeffs(theta)
    W = hat(w)
    I = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return I + A[..., None, None] * W + B[..., None, None] * (W @ W)


def quaternion_from_matrix(R: jax.Array) -> jax.Array:
    """Rotation matrix -> unit quaternion ``[..., 4]`` (w, x, y, z).

    Shepperd's method: evaluate all four branch candidates and select by the
    largest pivot, which is stable for every rotation including angle pi.
    """
    m00, m11, m22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    r01, r02, r10 = R[..., 0, 1], R[..., 0, 2], R[..., 1, 0]
    r12, r20, r21 = R[..., 1, 2], R[..., 2, 0], R[..., 2, 1]

    def S(pivot_sq):
        return 2.0 * jnp.sqrt(jnp.maximum(pivot_sq, 1e-12))

    s_w = S(1.0 + tr)
    q_w = jnp.stack([0.25 * s_w, (r21 - r12) / s_w, (r02 - r20) / s_w,
                     (r10 - r01) / s_w], axis=-1)
    s_x = S(1.0 + m00 - m11 - m22)
    q_x = jnp.stack([(r21 - r12) / s_x, 0.25 * s_x, (r01 + r10) / s_x,
                     (r02 + r20) / s_x], axis=-1)
    s_y = S(1.0 - m00 + m11 - m22)
    q_y = jnp.stack([(r02 - r20) / s_y, (r01 + r10) / s_y, 0.25 * s_y,
                     (r12 + r21) / s_y], axis=-1)
    s_z = S(1.0 - m00 - m11 + m22)
    q_z = jnp.stack([(r10 - r01) / s_z, (r02 + r20) / s_z,
                     (r12 + r21) / s_z, 0.25 * s_z], axis=-1)

    pivots = jnp.stack([tr, m00, m11, m22], axis=-1)
    best = jnp.argmax(pivots, axis=-1)
    cands = jnp.stack([q_w, q_x, q_y, q_z], axis=-2)      # [..., 4, 4]
    q = jnp.take_along_axis(cands, best[..., None, None].repeat(4, -1),
                            axis=-2)[..., 0, :]
    # Canonical sign (w >= 0) and normalization.
    q = q * jnp.where(q[..., :1] < 0, -1.0, 1.0)
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def log_so3(R: jax.Array) -> jax.Array:
    """SO(3) logarithm: rotation matrix -> rotation vector ``[..., 3]``.

    Quaternion-based; stable for all angles including near 0 and pi.
    """
    q = quaternion_from_matrix(R)
    qw = q[..., 0]
    qv = q[..., 1:]
    n = jnp.linalg.norm(qv, axis=-1)
    angle = 2.0 * jnp.arctan2(n, qw)
    small = n < 1e-8
    # angle/n -> 2/qw as n -> 0 (qw -> 1)
    factor = jnp.where(small, 2.0 / jnp.maximum(qw, 1e-12),
                       angle / jnp.where(small, 1.0, n))
    return factor[..., None] * qv


def exp(twist: jax.Array) -> jax.Array:
    """SE(3) exponential: twist ``[..., 6]`` ([t; r] order) -> ``[..., 4, 4]``."""
    v, w = twist[..., :3], twist[..., 3:]
    theta = jnp.linalg.norm(w, axis=-1)
    A, B, C = _sinc_coeffs(theta)
    W = hat(w)
    WW = W @ W
    I = jnp.broadcast_to(jnp.eye(3, dtype=twist.dtype), W.shape)
    R = I + A[..., None, None] * W + B[..., None, None] * WW
    V = I + B[..., None, None] * W + C[..., None, None] * WW
    t = (V @ v[..., None])[..., 0]
    return make(R, t)


def log(T: jax.Array) -> jax.Array:
    """SE(3) logarithm: ``[..., 4, 4]`` -> twist ``[..., 6]`` ([t; r] order)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = log_so3(R)
    theta = jnp.linalg.norm(w, axis=-1)
    A, B, _ = _sinc_coeffs(theta)
    W = hat(w)
    WW = W @ W
    I = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), W.shape)
    # V^{-1} = I - W/2 + (1/theta^2)(1 - A/(2B)) W^2
    t2 = theta * theta
    small = t2 < 1e-3  # same fp32-cancellation guard as _sinc_coeffs
    safe_t2 = jnp.where(small, 1.0, t2)
    safe_B = jnp.where(small, 1.0, B)
    coef = jnp.where(small, 1.0 / 12.0 + t2 / 720.0 + t2 * t2 / 30240.0,
                     (1.0 - A / (2.0 * safe_B)) / safe_t2)
    Vinv = I - 0.5 * W + coef[..., None, None] * WW
    v = (Vinv @ t[..., None])[..., 0]
    return jnp.concatenate([v, w], axis=-1)


def make(R: jax.Array, t: jax.Array) -> jax.Array:
    """Assemble ``[..., 4, 4]`` from rotation ``[..., 3, 3]`` and translation."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), batch + (4,)
    )[..., None, :]
    return jnp.concatenate([top, bottom], axis=-2)


def identity(dtype=jnp.float32, batch_shape=()) -> jax.Array:
    return jnp.broadcast_to(jnp.eye(4, dtype=dtype), batch_shape + (4, 4))


def rotation(T: jax.Array) -> jax.Array:
    return T[..., :3, :3]


def translation(T: jax.Array) -> jax.Array:
    return T[..., :3, 3]


def inverse(T: jax.Array) -> jax.Array:
    """Closed-form inverse of a rigid transform (no linear solve)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return make(Rt, -(Rt @ t[..., None])[..., 0])


def compose(A: jax.Array, B: jax.Array) -> jax.Array:
    """A @ B for rigid transforms (plain matmul, kept for readability)."""
    return A @ B


def apply(T: jax.Array, points: jax.Array) -> jax.Array:
    """Apply ``[..., 4, 4]`` transform to points ``[..., N, 3]``."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return points @ jnp.swapaxes(R, -1, -2) + t[..., None, :]


def rotate(T: jax.Array, vectors: jax.Array) -> jax.Array:
    """Rotate direction vectors ``[..., N, 3]`` (no translation)."""
    R = T[..., :3, :3]
    return vectors @ jnp.swapaxes(R, -1, -2)


def adjoint(T: jax.Array) -> jax.Array:
    """Adjoint of SE(3) acting on [t; r]-ordered twists: ``[..., 6, 6]``.

    Ad(T) = [[R, hat(t) R], [0, R]] for the [v; w] ordering.
    """
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    tR = hat(t) @ R
    zeros = jnp.zeros_like(R)
    top = jnp.concatenate([R, tR], axis=-1)
    bottom = jnp.concatenate([zeros, R], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def normalize_rotation(T: jax.Array) -> jax.Array:
    """Re-orthonormalize the rotation block via SVD (drift control).

    Handles arbitrarily bad R (reflections excepted). For the common
    near-orthonormal case prefer :func:`normalize_rotation_fast`: tiny
    batched SVDs lower to serialized loops."""
    R = T[..., :3, :3]
    U, _, Vt = jnp.linalg.svd(R)
    det = jnp.linalg.det(U @ Vt)
    D = jnp.concatenate(
        [jnp.ones_like(det)[..., None], jnp.ones_like(det)[..., None],
         det[..., None]], axis=-1)
    Rn = (U * D[..., None, :]) @ Vt
    return make(Rn, T[..., :3, 3])


def normalize_rotation_fast(T: jax.Array, iterations: int = 2) -> jax.Array:
    """Drift control for NEAR-orthonormal rotations via the Newton-Schulz
    polar iteration ``R <- R (3I - R^T R) / 2`` — batched 3x3 matmuls
    only (no serialized SVD loops). Quadratic
    convergence to the polar factor: drift 1e-3 -> ~1e-9 in two
    iterations. NOT safe for arbitrary R (diverges past ||R^T R - I|| ~
    1); PGO retractions come out of ``exp`` so they qualify."""
    R = T[..., :3, :3]
    eye = jnp.eye(3, dtype=R.dtype)
    for _ in range(iterations):
        R = 0.5 * R @ (3.0 * eye - jnp.swapaxes(R, -1, -2) @ R)
    return make(R, T[..., :3, 3])


def rotation_angle(T: jax.Array) -> jax.Array:
    """Rotation angle (radians) of the transform's rotation block."""
    R = T[..., :3, :3]
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return jnp.arccos(jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0))


def translation_norm(T: jax.Array) -> jax.Array:
    return jnp.linalg.norm(T[..., :3, 3], axis=-1)
