"""Rigid-transform error minimizers + the three introspection products the
framework depends on (overlap, covariance, residual error).

Analog of libpointmatcher's ``ErrorMinimizer`` family. Reference
behavior pins (SURVEY.md §2b N5):

* ``getCovariance()``        — 6x6 measurement covariance fed into the pose
  graph (``Localizer.hpp:238``, ``LoopCloser.hpp:108``), PM order [t; r].
* ``getOverlap()``           — weighted point-used ratio used for keyframe
  gating (``Localizer.hpp:278``) and loop acceptance (``LoopCloser.hpp:331``).
* ``getResidualError(...)``  — scalar residual for loop verification
  (``LoopCloser.hpp:362``).

Both minimizers consume an :class:`ErrorElements` bundle (matched reading /
reference points + weights), mirroring PM's ``ErrorElements`` ctor use at
``Localizer.hpp:332``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import se3
from ..utils.pytree import pytree_dataclass


@pytree_dataclass
class ErrorElements:
    """Matched point pairs with weights (k=1 matches, flattened)."""

    reading: jax.Array            # [N, 3] reading points (already transformed)
    reference: jax.Array          # [N, 3] matched reference points
    weights: jax.Array            # [N] outlier weights in [0, 1]
    normals: jax.Array | None = None   # [N, 3] reference normals (p2plane)

    def weight_sum(self) -> jax.Array:
        return jnp.sum(self.weights)


def overlap(weights: jax.Array, n_valid_reading: jax.Array) -> jax.Array:
    """``weightedPointUsedRatio``: sum of outlier weights over the number of
    valid reading points (the default ``ErrorMinimizer::getOverlap`` value,
    relied on at ``Localizer.hpp:344-347``)."""
    return jnp.sum(weights) / jnp.maximum(n_valid_reading.astype(jnp.float32), 1.0)


# --------------------------------------------------------------------------
# Point-to-point (weighted Umeyama / Kabsch)
# --------------------------------------------------------------------------

MIN_SUPPORT = 6.0  # below this many effective points a rigid fit is garbage


def _degenerate_guard(delta: jax.Array, weights: jax.Array) -> jax.Array:
    """Replace the delta with identity when the weighted support is too
    small to determine a rigid transform. libpointmatcher throws a
    ConvergenceError in this situation (which the reference does not
    catch); degrading to a no-op update keeps the pipeline alive and the
    overlap statistic reports the failure downstream."""
    ok = jnp.sum(weights) >= MIN_SUPPORT
    return jnp.where(ok, delta, jnp.eye(4, dtype=delta.dtype))


def point_to_point(elems: ErrorElements) -> jax.Array:
    """Closed-form weighted rigid alignment minimizing sum w |R p + t - q|^2.

    Returns the 4x4 delta transform to left-compose onto the current
    estimate. Degenerate weight sums fall back to identity.
    """
    w = elems.weights
    wsum = jnp.maximum(jnp.sum(w), 1e-12)
    wp = w[:, None]
    mu_p = jnp.sum(wp * elems.reading, axis=0) / wsum
    mu_q = jnp.sum(wp * elems.reference, axis=0) / wsum
    p = elems.reading - mu_p
    q = elems.reference - mu_q
    H = (p * wp).T @ q                      # [3, 3] cross-covariance
    U, _, Vt = jnp.linalg.svd(H)
    det = jnp.linalg.det(Vt.T @ U.T)
    D = jnp.diag(jnp.array([1.0, 1.0, 1.0], H.dtype)).at[2, 2].set(det)
    R = Vt.T @ D @ U.T
    t = mu_q - R @ mu_p
    return _degenerate_guard(se3.make(R, t), w)


# --------------------------------------------------------------------------
# Point-to-plane (one Gauss-Newton step on the linearized 6x6 system)
# --------------------------------------------------------------------------

def _p2plane_system(elems: ErrorElements):
    """Build A = sum w J J^T (6x6) and b = -sum w r J (6,) for the
    point-to-plane error, J_i = [n_i ; p_i x n_i] in [t; r] twist order."""
    n = elems.normals
    p = elems.reading
    r = jnp.sum(n * (p - elems.reference), axis=-1)       # [N]
    J = jnp.concatenate([n, jnp.cross(p, n)], axis=-1)    # [N, 6]
    wJ = elems.weights[:, None] * J
    A = wJ.T @ J                                          # [6, 6]
    b = -jnp.sum(wJ * r[:, None], axis=0)                 # [6]
    return A, b, r


def point_to_plane(elems: ErrorElements) -> jax.Array:
    """One linearized point-to-plane solve; returns the 4x4 delta transform."""
    A, b, _ = _p2plane_system(elems)
    A = A + 1e-6 * jnp.eye(6, dtype=A.dtype)              # Tikhonov guard
    x = jnp.linalg.solve(A, b)
    return _degenerate_guard(se3.exp(x), elems.weights)


# --------------------------------------------------------------------------
# Residual error (LoopCloser.hpp:362 semantics)
# --------------------------------------------------------------------------

def residual_error(elems: ErrorElements, error: str) -> jax.Array:
    """Scalar residual: sum of weighted squared errors at the current pose."""
    if error == "point_to_plane" and elems.normals is not None:
        r = jnp.sum(elems.normals * (elems.reading - elems.reference), axis=-1)
        return jnp.sum(elems.weights * r * r)
    d2 = jnp.sum((elems.reading - elems.reference) ** 2, axis=-1)
    return jnp.sum(elems.weights * d2)


# --------------------------------------------------------------------------
# Measurement covariance (PM order [t; r])
# --------------------------------------------------------------------------

def covariance(elems: ErrorElements, error: str) -> jax.Array:
    """6x6 covariance of the estimated transform: sigma^2 * (J^T W J)^-1.

    For point-to-plane, J is the scalar-residual Jacobian; for
    point-to-point each residual is 3-dimensional with J = [I, -hat(p)].
    sigma^2 is the weighted mean squared residual with dof correction.
    Order is PM's [x, y, z, rx, ry, rz] (the reference converts this to
    GTSAM order at ``Optimizer.hpp:33-42``; we convert inside our optimizer
    equivalently).
    """
    w = elems.weights
    wsum = jnp.sum(w)
    if error == "point_to_plane" and elems.normals is not None:
        A, _, r = _p2plane_system(elems)
        ssr = jnp.sum(w * r * r)
        n_res = wsum
    else:
        p = elems.reading
        diff = p - elems.reference
        # J_i = [I3, -hat(p_i)]  (3x6); A = sum w J^T J
        hp = se3.hat(p)                                    # [N, 3, 3]
        wI = jnp.sum(w) * jnp.eye(3, dtype=p.dtype)
        w_hp = w[:, None, None] * hp
        A_tr = -jnp.sum(w_hp, axis=0)                      # sum w (-hat p)
        A_rr = jnp.einsum("nij,nik->jk", w_hp, hp)         # sum w hat^T hat
        A = jnp.block([[wI, A_tr], [A_tr.T, A_rr]])
        ssr = jnp.sum(w * jnp.sum(diff * diff, axis=-1))
        n_res = 3.0 * wsum
    dof = jnp.maximum(n_res - 6.0, 1.0)
    sigma2 = ssr / dof
    A = A + 1e-9 * jnp.eye(6, dtype=A.dtype)
    cov = sigma2 * jnp.linalg.inv(A)
    # Never return a singular covariance: floor the diagonal.
    return cov + 1e-12 * jnp.eye(6, dtype=A.dtype)
