"""Multi-chip SLAM step: dp over agents x tp over reference points.

The correspondence search is the ring-attention-shaped part of SLAM: the
"sequence" axis is the reference cloud's point count. Under ``shard_map``
each device holds a tile of the reference, computes local nearest
neighbours for the (replicated-within-tp) reading, gathers the matched
points alongside their distances, and an ``all_gather`` over the tp axis
merges per-tile candidates into the global nearest neighbour — the
communication volume is O(Nq * k), never the full reference.

The pose-graph optimization runs jitted over the same mesh with
replicated poses (graphs are small; its parallelism is the batched 6x6
block math, not sharding).

This module backs ``__graft_entry__.dryrun_multichip`` and the
four-card phase of ``chip_smoke.py``; the collectives go to NCCL.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import se3
from ..ops import minimizer as M
from ..ops import outlier as O
from ..ops.icp import ICPConfig
from ..ops.knn import knn_brute_force
from ..optim.pgo import PGOConfig, optimize_pose_graph


def _merge_gathered(all_d, all_i, all_p, k: int):
    """Merge per-tile candidates: [tp, b, N, k] dists / ids and
    [tp, b, N, k, 3] points -> global top-k along the tp*k axis."""
    tp, b, n, kk = all_d.shape
    d = jnp.moveaxis(all_d, 0, -2).reshape(b, n, tp * kk)
    i = jnp.moveaxis(all_i, 0, -2).reshape(b, n, tp * kk)
    p = jnp.moveaxis(all_p, 0, -3).reshape(b, n, tp * kk, 3)
    neg, arg = jax.lax.top_k(-d, k)
    best_d = -neg
    best_i = jnp.take_along_axis(i, arg, axis=-1)
    best_p = jnp.take_along_axis(p, arg[..., None], axis=-2)
    return best_d, best_i, best_p


def sharded_icp_step(mesh: Mesh, cfg: ICPConfig, merge: str = "all_gather"):
    """Build a jitted one-iteration ICP update sharded (dp, tp).

    Returns ``step(reading_pts, reading_mask, ref_pts, ref_mask, T)`` with
    reading ``[B, N, 3]`` sharded over dp and reference ``[B, M, 3]``
    sharded over (dp, tp). Produces the updated ``[B, 4, 4]`` transforms
    and per-agent overlaps.

    ``merge``: how per-shard candidates combine across the point axis —
    ``"all_gather"`` (one collective of the tiny [N, k] candidate sets) or
    ``"ring"`` (ppermute the reading + running best around the tp ring,
    the ring-attention-style pass; same result, neighbour-only traffic).
    """
    from jax import shard_map

    tp = mesh.shape["tp"]

    def body(r_pts, r_mask, f_pts, f_mask, T):
        # Per-device shapes: r [b, N, 3]; f [b, M/tp, 3]; T [b, 4, 4].
        shard_m = f_pts.shape[1]
        pts = se3.apply(T, r_pts)                       # [b, N, 3]

        def local_match(q, qm, rp, rm):
            m = knn_brute_force(q, qm, rp, rm, k=1,
                                tile_ref=min(512, shard_m))
            matched = jnp.take(rp, m.ids[:, 0], axis=0)
            return m.dists2, m.ids, matched

        if merge == "ring":
            # Ring pass: the reading (and its running best) visits every
            # reference shard; after tp hops it is back home holding the
            # global nearest neighbours. Traffic is nearest-neighbor only.
            my = jax.lax.axis_index("tp")
            perm = [(i, (i + 1) % tp) for i in range(tp)]

            def hop(carry, _):
                pts_c, qm_c, best_d, best_i, best_p, hops = carry
                d2, ids, matched = jax.vmap(local_match)(
                    pts_c, qm_c, f_pts, f_mask)
                gids = ids + my * shard_m
                better = d2 < best_d
                best_d = jnp.where(better, d2, best_d)
                best_i = jnp.where(better, gids, best_i)
                best_p = jnp.where(better[..., None],
                                   matched[:, :, None, :], best_p)
                carry = (pts_c, qm_c, best_d, best_i, best_p, hops + 1)
                return jax.tree_util.tree_map(
                    lambda x: jax.lax.ppermute(x, "tp", perm), carry), None

            b, n = pts.shape[:2]
            init = (pts, r_mask,
                    jnp.full((b, n, 1), jnp.inf, jnp.float32),
                    jnp.zeros((b, n, 1), jnp.int32),
                    jnp.zeros((b, n, 1, 3), jnp.float32),
                    jnp.zeros((), jnp.int32))
            (pts, r_mask_back, best_d, best_i, best_p, _), _ = \
                jax.lax.scan(hop, init, None, length=tp)
            del r_mask_back
        else:
            d2, ids, matched = jax.vmap(local_match)(pts, r_mask, f_pts,
                                                     f_mask)
            ids = ids + jax.lax.axis_index("tp") * shard_m  # globalize ids
            # Candidate exchange over the point-sharded axis.
            all_d = jax.lax.all_gather(d2, "tp")            # [tp, b, N, 1]
            all_i = jax.lax.all_gather(ids, "tp")
            all_p = jax.lax.all_gather(matched[:, :, None, :], "tp")
            best_d, _, best_p = _merge_gathered(all_d, all_i, all_p, k=1)

        def solve(q, qm, d, p_matched):
            from ..ops.knn import Matches
            w = O.compute_weights(
                cfg.outlier,
                Matches(dists2=d, ids=jnp.zeros(d.shape, jnp.int32)), qm)
            elems = M.ErrorElements(reading=q, reference=p_matched[:, 0],
                                    weights=w[:, 0])
            delta = M.point_to_point(elems)
            ov = M.overlap(w, jnp.sum(qm))
            return delta, ov

        deltas, overlaps = jax.vmap(solve)(pts, r_mask, best_d, best_p)
        return deltas @ T, overlaps

    step = shard_map(
        body, mesh=mesh,
        in_specs=(P("dp"), P("dp"), P("dp", "tp"), P("dp", "tp"), P("dp")),
        out_specs=(P("dp"), P("dp")),
        check_vma=False)
    return jax.jit(step)


def make_mesh(n_devices: int, tp: int = 2) -> Mesh:
    """(dp, tp) device mesh for the sharded registration paths: the first
    ``n_devices`` devices, ``tp`` consecutive devices per reference-shard
    group. The cards of one host reach each other at the same rate, so
    the layout follows the algorithm alone."""
    tp = min(tp, n_devices)
    if n_devices % tp:
        raise ValueError(f"tp={tp} must divide n_devices={n_devices}")
    devices = np.array(jax.devices()[:n_devices], dtype=object)
    return Mesh(devices.reshape(n_devices // tp, tp), ("dp", "tp"))


def multichip_slam_step(mesh: Mesh, cfg: ICPConfig,
                        pgo_cfg: PGOConfig = PGOConfig(max_iterations=3)):
    """Full multi-chip training-step analog: one FULL sharded registration
    (``parallel.sharded_icp`` — the same semantics MultiAgentSlam runs in
    production) for B agents feeding one pose-graph optimization.

    Returns ``step(args) -> (T_new, overlaps, opt_poses)`` where args is
    (reading_pts, reading_mask, ref_pts, ref_mask, ref_normals, T_init,
    poses, vmask, edge_from, edge_to, edge_T, edge_cov, emask,
    agent_edge_ids, agent_edge_mask).

    ``agent_edge_ids [B]`` names the edge slot that carries each agent's
    refined measurement (``agent_edge_mask`` False = agent contributes no
    edge this step), replacing r1's unconditional ``eT[:B]`` overwrite.
    """
    from ..cloud import Cloud
    from .sharded_icp import make_sharded_register

    register = make_sharded_register(mesh, cfg)
    repl = NamedSharding(mesh, P())
    E_axis = None  # edges replicated; scatter below is tiny

    def step(reading_pts, reading_mask, ref_pts, ref_mask, ref_nrm, T_init,
             poses, vmask, ef, et, eT, ec, emask,
             agent_edge_ids, agent_edge_mask):
        reading = Cloud(points=reading_pts, mask=reading_mask,
                        descriptors={})
        reference = Cloud(points=ref_pts, mask=ref_mask,
                          descriptors={"normals": ref_nrm})
        res = register(reading, reference, T_init)
        T_new, overlaps = res.T, res.overlap
        # Agents' refined relative transforms land in their assigned edge
        # slots of the shared pose graph (batched multi-agent, BASELINE
        # config 5); masked agents leave the graph untouched.
        slots = jnp.where(agent_edge_mask, agent_edge_ids, eT.shape[0])
        eT = eT.at[slots].set(res.T, mode="drop")  # OOB = masked agent
        opt, _ = optimize_pose_graph(poses, vmask, ef, et, eT, ec, emask,
                                     jnp.int32(0), config=pgo_cfg)
        return T_new, overlaps, opt

    del E_axis
    return jax.jit(step,
                   in_shardings=(
                       NamedSharding(mesh, P("dp")),
                       NamedSharding(mesh, P("dp")),
                       NamedSharding(mesh, P("dp", "tp")),
                       NamedSharding(mesh, P("dp", "tp")),
                       NamedSharding(mesh, P("dp", "tp")),
                       NamedSharding(mesh, P("dp")),
                       repl, repl, repl, repl, repl, repl, repl,
                       repl, repl),
                   out_shardings=(NamedSharding(mesh, P("dp")),
                                  NamedSharding(mesh, P("dp")), repl))
