"""The ICP driver — analog of libpointmatcher's ``ICP`` /
``ICPSequence`` orchestrators (invoked at ``Localizer.hpp:126`` and
``LoopCloser.hpp:98``; ``setMap`` at ``Localizer.hpp:148,168,254``).

The iterate loop (match -> outlier-weight -> minimize -> check) runs as a
``jax.lax.while_loop`` inside one jitted function, so a whole registration
is a single device dispatch. Convergence control reproduces the reference's
transformation checkers (SURVEY.md §2b N7): an iteration cap plus a
differential (min-update) test, with the *reason* for stopping reported in
the result (``max_iter_reached``, consumed at ``LoopCloser.hpp:317``).

``ICPEngine`` is the ``ICPSequence`` analog: it keeps a persistent,
pre-filtered reference map (with precomputed normals / grid index) across
calls so per-scan work stays minimal.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .. import se3
from ..cloud import Cloud
from ..utils.pytree import pytree_dataclass
from . import filters as F
from . import minimizer as M
from . import outlier as O
from .knn import Matches, knn_brute_force
from .knn_pallas import nn_pallas, use_kernel


@dataclasses.dataclass(frozen=True)
class ICPConfig:
    """Static ICP pipeline configuration (hashable -> jit static arg).

    Mirrors the information content of a libpointmatcher YAML pipeline:
    filter chains, matcher, outlier filters, error minimizer, checkers.
    """

    error: str = "point_to_point"          # or "point_to_plane"
    # matcher
    matcher: str = "brute"                  # "brute" | "grid" | "pallas"
    knn: int = 1                            # matches used by the minimizer
    tile_ref: int = 2048
    tile_query: int = 0
    grid_cell_size: float = 0.0             # 0 = auto from cloud extent
    grid_bucket_cap: int = 8
    # outlier filters. NOTE: the default pairs a relative (trimmed) filter
    # with an absolute distance cut — without an absolute criterion the
    # overlap statistic (weightedPointUsedRatio) degenerates to the trim
    # ratio constant and the Localizer's keyframe gating never fires.
    outlier: Tuple = (O.TrimmedDist(0.85), O.MaxDist(1.0))
    # transformation checkers
    max_iterations: int = 40
    trans_eps: float = 1e-4
    rot_eps: float = 1e-4
    # The differential test averages the last ``smooth_length`` iteration
    # deltas (libpointmatcher DifferentialTransformationChecker semantics):
    # correspondence changes make single-iteration deltas jitter, so an
    # instantaneous test can keep a well-converged ICP spinning until the
    # iteration cap.
    smooth_length: int = 4
    # Bound checker (libpointmatcher BoundTransformationChecker analog):
    # if the total correction relative to the initial guess exceeds these,
    # the result is rejected and the initial guess returned with
    # ``diverged=True``. 0 disables. Where libpointmatcher throws (and the
    # reference would crash), we degrade to dead-reckoning on the prior.
    max_correction_trans: float = 0.0
    max_correction_rot: float = 0.0
    # Coarse-to-fine: run ``coarse_iterations`` first on a 1/coarse_div
    # decimation of the reading (inside the same jit — matching cost
    # scales with reading size, so early iterations become nearly free),
    # then refine on the full reading. 0/1 disables.
    coarse_div: int = 0
    coarse_iterations: int = 10
    # Anderson acceleration (AA-ICP, arXiv:1709.05479): extrapolate the
    # fixed-point iterates from a window of ``anderson_m`` twists. Cuts
    # iteration counts ~1.5-2x on well-conditioned problems. 0/1 disables.
    # Safeguarded: falls back to the plain step when the extrapolation
    # overshoots.
    anderson_m: int = 0
    # data-point filter chains
    reading_filters: Tuple = ()
    reference_filters: Tuple = ()


def eps_dead_zone(cfg: ICPConfig) -> Optional[str]:
    """Reason the differential convergence checker can NEVER fire for this
    config, or None if it can.

    The checker smooths the last ``smooth_length`` iteration deltas and
    the window starts ``inf``-filled (libpointmatcher semantics), so
    ``converged`` is structurally unreachable before the window fills.
    The window holds L real deltas after the L-th loop body, and the body
    computes ``converged`` AFTER pushing its delta — so at
    ``max_iterations == smooth_length`` the checker can still fire on the
    final iteration; only ``max_iterations < smooth_length`` is a true
    dead zone (every registration reports ``max_iter_reached=True``
    regardless of the data). That flag is exactly what loop-closure
    acceptance rejects on (``LoopCloser.hpp:317``), so such a profile
    silently rejects 100% of closures. The equality
    case is margin 0 — live but with exactly one iteration of room —
    handled by callers' ``eps_margin`` warning tier."""
    L = max(1, cfg.smooth_length)
    if cfg.max_iterations < L:
        return (f"max_iterations={cfg.max_iterations} < smooth_length={L}: "
                f"the smoothed eps window never fills, so converged can "
                f"never be reported and max_iter_reached is unconditionally "
                f"True")
    if cfg.trans_eps <= 0 or cfg.rot_eps <= 0:
        return (f"trans_eps={cfg.trans_eps} / rot_eps={cfg.rot_eps}: "
                f"non-positive eps can never be satisfied")
    return None


def eps_margin(cfg: ICPConfig) -> int:
    """Iterations of ROOM the differential checker has before the cap
    (``max_iterations - smooth_length``; 0 means it can fire only on the
    very last iteration, exactly when the window first fills). Small
    values mean the checker is live but has almost no room — fine for
    throughput profiles (the localizer ignores ``max_iter_reached``),
    hazardous for loop-closure verification profiles (which reject on
    it)."""
    return cfg.max_iterations - max(1, cfg.smooth_length)


@pytree_dataclass
class ICPResult:
    """Registration result + the introspection the framework depends on."""

    T: jax.Array                 # [4, 4] corrected transform
    iterations: jax.Array        # int32
    converged: jax.Array         # bool: differential checker fired
    max_iter_reached: jax.Array  # bool: stopped by the iteration cap
    overlap: jax.Array           # weightedPointUsedRatio at the solution
    residual: jax.Array          # weighted squared residual sum
    cov: jax.Array               # [6, 6] measurement covariance, PM order
    diverged: jax.Array = None   # bool: bound checker rejected the result


# --------------------------------------------------------------------------
# Matching + error-element assembly
# --------------------------------------------------------------------------

def match_clouds(points: jax.Array, mask: jax.Array, reference: Cloud,
                 cfg: ICPConfig, index=None) -> Matches:
    """Dispatch to the configured matcher. ``index`` is an optional
    precomputed grid index (see :mod:`pgslam_tpu.ops.gridknn`)."""
    if cfg.matcher == "grid" and index is not None:
        from .gridknn import grid_knn
        return grid_knn(points, mask, index, k=cfg.knn)
    if cfg.matcher == "pallas" and use_kernel(jax.default_backend()):
        return nn_pallas(points, mask, reference.points, reference.mask,
                         k=cfg.knn)
    # "brute" — also "pallas" on the CPU (identical exact-kNN semantics;
    # the kernel runs there only in the interpreter, for tests).
    return knn_brute_force(points, mask, reference.points, reference.mask,
                           k=cfg.knn, tile_ref=cfg.tile_ref,
                           tile_query=cfg.tile_query)


def build_error_elements(points, mask, reference: Cloud, matches: Matches,
                         weights, cfg: ICPConfig) -> M.ErrorElements:
    """Flatten [Nq, k] matches into weighted point pairs (k=1 fast path)."""
    ids = matches.ids.reshape(-1)
    ref_pts = jnp.take(reference.points, ids, axis=0)
    normals = None
    if cfg.error == "point_to_plane":
        normals = jnp.take(reference.descriptors["normals"], ids, axis=0)
    k = matches.k
    reading = jnp.repeat(points, k, axis=0) if k > 1 else points
    return M.ErrorElements(reading=reading, reference=ref_pts,
                           weights=weights.reshape(-1), normals=normals)


def _match_and_weigh(points, mask, reference: Cloud, cfg: ICPConfig, index):
    matches = match_clouds(points, mask, reference, cfg, index)
    weights = O.compute_weights(cfg.outlier, matches, mask)
    return matches, weights


# --------------------------------------------------------------------------
# Core registration (single jitted dispatch)
# --------------------------------------------------------------------------

def _icp_loop(reading: Cloud, reference: Cloud, T0: jax.Array,
              cfg: ICPConfig, index, max_iterations: int):
    """The iterate loop (match -> weigh -> minimize -> check)."""

    def step(T):
        pts = se3.apply(T, reading.points)
        matches, weights = _match_and_weigh(pts, reading.mask, reference,
                                            cfg, index)
        elems = build_error_elements(pts, reading.mask, reference, matches,
                                     weights, cfg)
        if cfg.error == "point_to_plane":
            delta = M.point_to_plane(elems)
        else:
            delta = M.point_to_point(elems)
        return delta @ T, delta

    def cond(state):
        _, it, converged, _, _ = state
        return jnp.logical_and(it < max_iterations, ~converged)

    def body(state):
        T, it, _, dts, drs = state
        T_new, delta = step(T)
        dts = jnp.roll(dts, 1).at[0].set(se3.translation_norm(delta))
        drs = jnp.roll(drs, 1).at[0].set(se3.rotation_angle(delta))
        converged = jnp.logical_and(jnp.mean(dts) < cfg.trans_eps,
                                    jnp.mean(drs) < cfg.rot_eps)
        return (T_new, it + 1, converged, dts, drs)

    L = max(1, cfg.smooth_length)
    big = jnp.full((L,), jnp.inf, T0.dtype)

    if cfg.anderson_m and cfg.anderson_m > 1:
        m = cfg.anderson_m
        Tinv0 = se3.inverse(T0)

        def cond_aa(state):
            _, it, converged, _, _, _, _ = state
            return jnp.logical_and(it < max_iterations, ~converged)

        def body_aa(state):
            T, it, _, dts, drs, X, GX = state
            T_plain, _ = step(T)
            x_k = se3.log(T @ Tinv0)
            g_k = se3.log(T_plain @ Tinv0)
            X = jnp.roll(X, 1, axis=0).at[0].set(x_k)
            GX = jnp.roll(GX, 1, axis=0).at[0].set(g_k)
            # Type-II AA on the window's residuals f_i = g_i - x_i.
            Fr = GX - X                                    # [m, 6]
            dF = Fr[0] - Fr[1:]                            # [m-1, 6]
            dG = GX[0] - GX[1:]                            # [m-1, 6]
            A = dF @ dF.T + 1e-10 * jnp.eye(m - 1, dtype=T.dtype)
            gamma = jnp.linalg.solve(A, dF @ Fr[0])        # [m-1]
            x_acc = g_k - gamma @ dG
            # Safeguard: reject runaway extrapolations; also wait for the
            # history window to fill.
            plain_sz = jnp.linalg.norm(g_k - x_k)
            ok = jnp.logical_and(
                jnp.linalg.norm(x_acc - g_k) <= 2.0 * plain_sz + 1e-9,
                it + 1 >= m)
            x_next = jnp.where(ok, x_acc, g_k)
            T_new = se3.exp(x_next) @ T0
            dT = T_new @ se3.inverse(T)
            dts = jnp.roll(dts, 1).at[0].set(se3.translation_norm(dT))
            drs = jnp.roll(drs, 1).at[0].set(se3.rotation_angle(dT))
            converged = jnp.logical_and(jnp.mean(dts) < cfg.trans_eps,
                                        jnp.mean(drs) < cfg.rot_eps)
            return (T_new, it + 1, converged, dts, drs, X, GX)

        zeros6 = jnp.zeros((m, 6), T0.dtype)
        T, iterations, converged, _, _, _, _ = jax.lax.while_loop(
            cond_aa, body_aa,
            (T0, jnp.int32(0), jnp.bool_(False), big, big, zeros6, zeros6))
        return T, iterations, converged

    T, iterations, converged, _, _ = jax.lax.while_loop(
        cond, body, (T0, jnp.int32(0), jnp.bool_(False), big, big))
    return T, iterations, converged


def _decimate(cloud: Cloud, div: int) -> Cloud:
    """Static strided decimation (uniform over scan order)."""
    return Cloud(points=cloud.points[::div], mask=cloud.mask[::div],
                 descriptors={k: v[::div]
                              for k, v in cloud.descriptors.items()})


@functools.partial(jax.jit, static_argnames=("cfg",))
def icp_core(reading: Cloud, reference: Cloud, T_init: jax.Array,
             cfg: ICPConfig, index=None) -> ICPResult:
    """Run the full ICP loop. ``reading``/``reference`` must already be
    filtered (the engine handles chains); shapes are static."""
    n_valid = reading.count()

    T_start = T_init.astype(reading.points.dtype)
    T0 = T_start
    if cfg.coarse_div and cfg.coarse_div > 1:
        # Coarse stage: decimated reading pulls T near the solution for a
        # fraction of the matching cost; the fine stage only polishes.
        coarse = _decimate(reading, cfg.coarse_div)
        T0, _, _ = _icp_loop(coarse, reference, T0, cfg, index,
                             cfg.coarse_iterations)
    T, iterations, converged = _icp_loop(reading, reference, T0, cfg, index,
                                         cfg.max_iterations)
    T0 = T_start  # bound checker measures against the ORIGINAL init

    # Bound checker: clamp runaway corrections back to the initial guess.
    diverged = jnp.bool_(False)
    dT = T @ se3.inverse(T0)
    if cfg.max_correction_trans > 0:
        diverged = jnp.logical_or(
            diverged, se3.translation_norm(dT) > cfg.max_correction_trans)
    if cfg.max_correction_rot > 0:
        diverged = jnp.logical_or(
            diverged, se3.rotation_angle(dT) > cfg.max_correction_rot)
    # NaN/inf guard: a degenerate solve must never poison downstream state.
    diverged = jnp.logical_or(diverged, ~jnp.all(jnp.isfinite(T)))
    T = jnp.where(diverged, T0, T)
    converged = jnp.logical_and(converged, ~diverged)

    # Final introspection at the solution (PM's lastErrorElements analog).
    pts = se3.apply(T, reading.points)
    matches, weights = _match_and_weigh(pts, reading.mask, reference, cfg,
                                        index)
    elems = build_error_elements(pts, reading.mask, reference, matches,
                                 weights, cfg)
    ov = M.overlap(weights, n_valid)
    res = M.residual_error(elems, cfg.error)
    cov = M.covariance(elems, cfg.error)
    max_iter_reached = jnp.logical_and(iterations >= cfg.max_iterations,
                                       ~converged)
    return ICPResult(T=T, iterations=iterations, converged=converged,
                     max_iter_reached=max_iter_reached, overlap=ov,
                     residual=res, cov=cov, diverged=diverged)


def _compute_overlap_impl(reading: Cloud, reference: Cloud, T: jax.Array,
                          cfg: ICPConfig, index=None) -> jax.Array:
    """Partial-ICP overlap probe: filters + match + weights only, no
    minimization (the reference's hackish replay at
    ``Localizer.hpp:282-348``). ``reading``/``reference`` must be
    pre-filtered; ``T`` maps reading into the reference frame."""
    pts = se3.apply(T, reading.points)
    _, weights = _match_and_weigh(pts, reading.mask, reference, cfg, index)
    return M.overlap(weights, reading.count())


compute_overlap = functools.partial(
    jax.jit, static_argnames=("cfg",))(_compute_overlap_impl)


@functools.partial(jax.jit, static_argnames=("cfg",))
def compute_residual(reading: Cloud, reference: Cloud, T: jax.Array,
                     cfg: ICPConfig, index=None) -> jax.Array:
    """Residual recompute pipeline (``LoopCloser.hpp:343-365``): transform
    reading by T, match, weigh, return the scalar residual error."""
    pts = se3.apply(T, reading.points)
    matches, weights = _match_and_weigh(pts, reading.mask, reference, cfg,
                                        index)
    elems = build_error_elements(pts, reading.mask, reference, matches,
                                 weights, cfg)
    return M.residual_error(elems, cfg.error)


# --------------------------------------------------------------------------
# Engine (ICPSequence analog): persistent reference map
# --------------------------------------------------------------------------

class ICPEngine:
    """Holds a persistent pre-processed reference map across calls,
    mirroring ``ICPSequence``'s ``setMap`` semantics."""

    def __init__(self, config: ICPConfig = ICPConfig()):
        reason = eps_dead_zone(config)
        if reason is not None:
            import logging
            logging.getLogger("pgslam_tpu.icp").warning(
                "[ICP] convergence checker can never fire (%s) — every "
                "result will report converged=False / "
                "max_iter_reached=True. Fine for fixed-budget throughput "
                "profiles; NOT usable for loop-closure verification "
                "(check_icp_result rejects on max_iter_reached).", reason)
        self.config = config
        self._reference: Optional[Cloud] = None
        self._index = None

    @property
    def has_map(self) -> bool:
        return self._reference is not None

    @property
    def reference(self) -> Optional[Cloud]:
        return self._reference

    def prepare_reference(self, reference: Cloud) -> Cloud:
        """Apply reference filter chain (incl. normals for point-to-plane)."""
        cfg = self.config
        chain = cfg.reference_filters
        if cfg.error == "point_to_plane" and not any(
                isinstance(f, F.SurfaceNormal) for f in chain):
            if "normals" not in reference.descriptors:
                chain = chain + (F.SurfaceNormal(),)
        if not chain:
            return reference
        return F.apply_chain_jit(chain, reference, jax.random.PRNGKey(0))

    def set_map(self, reference: Cloud) -> None:
        ref = self.prepare_reference(reference)
        self._reference = ref
        if self.config.matcher == "grid":
            from .gridknn import build_grid_index
            self._index = build_grid_index(
                ref.points, ref.mask,
                cell_size=self.config.grid_cell_size,
                bucket_cap=self.config.grid_bucket_cap)
        else:
            self._index = None

    def prepare_reading(self, reading: Cloud) -> Cloud:
        if not self.config.reading_filters:
            return reading
        return F.apply_chain_jit(self.config.reading_filters, reading,
                                 jax.random.PRNGKey(0))

    def __call__(self, reading: Cloud, T_init: jax.Array) -> ICPResult:
        if self._reference is None:
            raise RuntimeError("ICPEngine: set_map() must be called first")
        if self._index is None:
            # One device dispatch for reading-prep + registration instead
            # of the split prepare_reading/icp_core pair. Numerically
            # identical: the same chain + core are traced inline under
            # one jit.
            return _prep_and_register(reading, self._reference, T_init,
                                      self.config)
        reading = self.prepare_reading(reading)
        return icp_core(reading, self._reference, T_init, self.config,
                        self._index)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _prep_and_register(reading: Cloud, reference: Cloud, T_init: jax.Array,
                       cfg: ICPConfig) -> ICPResult:
    """Fused reading-filter chain + registration (single dispatch)."""
    if cfg.reading_filters:
        reading = F.apply_chain(cfg.reading_filters, reading,
                                jax.random.PRNGKey(0))
    return icp_core(reading, reference, T_init, cfg, None)


def icp(reading: Cloud, reference: Cloud, T_init: jax.Array,
        cfg: ICPConfig = ICPConfig()) -> ICPResult:
    """One-shot registration (LoopCloser-style ``icp_(...)`` call):
    applies both filter chains, then runs the loop."""
    engine = ICPEngine(cfg)
    engine.set_map(reference)
    return engine(reading, T_init)
