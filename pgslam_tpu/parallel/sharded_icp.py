"""Full ICP registration sharded over a (dp, tp) device mesh.

This is the production multi-device registration path: the fleet batch axis
shards over ``dp`` (data parallelism over agents) and each agent's
*reference* cloud shards over ``tp`` along its point axis (tensor
parallelism over the long axis — the correspondence search is the
ring-attention-shaped part of SLAM, SURVEY.md §2c). Unlike
:func:`pgslam_tpu.parallel.multichip.sharded_icp_step` (a single-iteration
demo kept for the collective-merge benchmarks), this runs the COMPLETE
registration semantics of :func:`pgslam_tpu.ops.icp.icp_core` — iterate
loop with smoothed differential convergence checkers, outlier weighting,
point-to-point or point-to-plane minimization, bound/NaN guards, and the
full introspection set (overlap / residual / covariance) — so
:class:`pgslam_tpu.parallel.multi_agent.MultiAgentSlam` can swap it in for
the plain vmapped dispatch without any behavior change.

Per iteration each device matches its reading block against its local
reference shard only (O(N * M/tp) work), then one ``all_gather`` over
``tp`` exchanges the per-shard candidate sets (O(N * k) payload — the
matched points and distances, never the reference) and every tp peer
reduces them to the identical global nearest neighbours; the minimization
is replicated along tp (tiny [6x6] solves). Convergence follows the
vmapped-`lax.while_loop` semantics of the plain batched path: the loop
runs until every agent in the device's sub-batch converged.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from .. import se3
from ..cloud import Cloud
from ..ops import knn_pallas as knn_kernel
from ..ops import minimizer as M
from ..ops import outlier as O
from ..ops.icp import ICPConfig, ICPResult
from ..ops.knn import Matches, knn_brute_force


def _minimize_batch(cfg: ICPConfig, pts, weights, ref_pts, ref_nrm):
    """Vmapped minimizer over the local agent batch.

    pts [b, N, 3]; weights [b, N, k]; ref_pts/ref_nrm [b, N, k, 3].
    """
    k = ref_pts.shape[2]
    p2plane = cfg.error == "point_to_plane"

    def one(p, w, rp, rn):
        reading = jnp.repeat(p, k, axis=0) if k > 1 else p
        elems = M.ErrorElements(
            reading=reading, reference=rp.reshape(-1, 3),
            weights=w.reshape(-1),
            normals=rn.reshape(-1, 3) if p2plane else None)
        delta = (M.point_to_plane(elems) if p2plane
                 else M.point_to_point(elems))
        return delta, elems

    return jax.vmap(one)(pts, weights, ref_pts, ref_nrm)


def make_sharded_register(mesh: Mesh, cfg: ICPConfig):
    """Build ``register(reading: Cloud[B,...], reference: Cloud[B,...],
    T0 [B,4,4]) -> ICPResult`` jitted over the mesh.

    ``reading`` shards over dp and replicates over tp; ``reference``
    shards over (dp, tp) along (batch, points). Reference clouds must be
    pre-filtered (normals present for point-to-plane), exactly like
    ``icp_core``'s contract.
    """
    from jax import shard_map

    tp = mesh.shape["tp"]
    k = cfg.knn
    p2plane = cfg.error == "point_to_plane"

    def device_body(r_pts, r_mask, f_pts, f_mask, f_nrm, T0):
        b, N = r_pts.shape[:2]
        m_local = f_pts.shape[1]
        my = jax.lax.axis_index("tp")
        dtype = r_pts.dtype

        use_kernel = (cfg.matcher == "pallas"
                      and knn_kernel.use_kernel(jax.default_backend()))

        def local_match(q, qm, fp, fm):
            if use_kernel:
                mt = knn_kernel.nn_pallas(q, qm, fp, fm, k=k)
            else:
                mt = knn_brute_force(q, qm, fp, fm, k=k,
                                     tile_ref=min(cfg.tile_ref, m_local))
            cand_p = fp[mt.ids]                              # [N, k, 3]
            return mt.dists2, mt.ids, cand_p

        def match_local_batch(pts):
            return jax.vmap(local_match)(pts, r_mask, f_pts, f_mask)

        def mg(pts):
            """Match pts [b,N,3] globally; return (weights, d2, ref_pts,
            ref_nrm) each [b,N,k(,3)] — identical on every tp peer."""
            d2, ids, cand_p = match_local_batch(pts)
            cand_n = (jax.vmap(lambda fn, i: fn[i])(f_nrm, ids)
                      if p2plane else jnp.zeros_like(cand_p))
            gids = ids + my * m_local
            all_d = jax.lax.all_gather(d2, "tp")             # [tp,b,N,k]
            all_i = jax.lax.all_gather(gids, "tp")
            all_p = jax.lax.all_gather(cand_p, "tp")         # [tp,b,N,k,3]
            all_n = jax.lax.all_gather(cand_n, "tp")
            d = jnp.moveaxis(all_d, 0, 2).reshape(b, N, tp * k)
            i = jnp.moveaxis(all_i, 0, 2).reshape(b, N, tp * k)
            pm = jnp.moveaxis(all_p, 0, 2).reshape(b, N, tp * k, 3)
            nm = jnp.moveaxis(all_n, 0, 2).reshape(b, N, tp * k, 3)
            neg, arg = jax.lax.top_k(-d, k)
            best_d = -neg                                    # [b,N,k] asc
            best_i = jnp.take_along_axis(i, arg, axis=-1)
            best_p = jnp.take_along_axis(pm, arg[..., None], axis=2)
            best_n = jnp.take_along_axis(nm, arg[..., None], axis=2)
            weights = jax.vmap(
                lambda da, ia, qm: O.compute_weights(
                    cfg.outlier, Matches(dists2=da, ids=ia), qm))(
                best_d, best_i, r_mask)
            return weights, best_d, best_p, best_n

        def step(T):
            pts = se3.apply(T, r_pts)
            weights, _, best_p, best_n = mg(pts)
            delta, _ = _minimize_batch(cfg, pts, weights, best_p, best_n)
            return delta @ T, delta

        L = max(1, cfg.smooth_length)
        big = jnp.full((b, L), jnp.inf, dtype)

        def cond(state):
            _, it, conv, _, _ = state
            return jnp.logical_and(it < cfg.max_iterations,
                                   ~jnp.all(conv))

        def body(state):
            T, it, _, dts, drs = state
            T_new, delta = step(T)
            dts = jnp.roll(dts, 1, axis=1).at[:, 0].set(
                se3.translation_norm(delta))
            drs = jnp.roll(drs, 1, axis=1).at[:, 0].set(
                se3.rotation_angle(delta))
            conv = jnp.logical_and(jnp.mean(dts, axis=1) < cfg.trans_eps,
                                   jnp.mean(drs, axis=1) < cfg.rot_eps)
            return (T_new, it + 1, conv, dts, drs)

        T0d = T0.astype(dtype)
        T, iterations, converged, _, _ = jax.lax.while_loop(
            cond, body,
            (T0d, jnp.int32(0), jnp.zeros((b,), bool), big, big))

        # Bound / NaN guards (icp_core parity).
        diverged = jnp.zeros((b,), bool)
        dT = T @ se3.inverse(T0d)
        if cfg.max_correction_trans > 0:
            diverged |= se3.translation_norm(dT) > cfg.max_correction_trans
        if cfg.max_correction_rot > 0:
            diverged |= se3.rotation_angle(dT) > cfg.max_correction_rot
        diverged |= ~jnp.all(jnp.isfinite(T), axis=(1, 2))
        T = jnp.where(diverged[:, None, None], T0d, T)
        converged = jnp.logical_and(converged, ~diverged)

        # Final introspection at the solution.
        n_valid = jnp.sum(r_mask, axis=1)
        pts = se3.apply(T, r_pts)
        weights, _, best_p, best_n = mg(pts)
        _, elems = _minimize_batch(cfg, pts, weights, best_p, best_n)
        ov = jax.vmap(M.overlap)(weights, n_valid)
        res = jax.vmap(lambda e: M.residual_error(e, cfg.error))(elems)
        cov = jax.vmap(lambda e: M.covariance(e, cfg.error))(elems)
        its = jnp.full((b,), iterations, jnp.int32)
        max_iter = jnp.logical_and(its >= cfg.max_iterations, ~converged)
        return T, its, converged, max_iter, ov, res, cov, diverged

    sharded = shard_map(
        device_body, mesh=mesh,
        in_specs=(P("dp"), P("dp"), P("dp", "tp"), P("dp", "tp"),
                  P("dp", "tp"), P("dp")),
        out_specs=(P("dp"),) * 8,
        check_vma=False)

    @jax.jit
    def register(reading: Cloud, reference: Cloud, T0: jax.Array
                 ) -> ICPResult:
        f_nrm = reference.descriptors.get(
            "normals", jnp.zeros_like(reference.points))
        outs = sharded(reading.points, reading.mask, reference.points,
                       reference.mask, f_nrm, T0)
        T, its, conv, max_iter, ov, res, cov, div = outs
        return ICPResult(T=T, iterations=its, converged=conv,
                         max_iter_reached=max_iter, overlap=ov,
                         residual=res, cov=cov, diverged=div)

    return register
