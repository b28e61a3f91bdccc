"""Outlier filters: per-match weights in [0, 1].

Analog of libpointmatcher's ``OutlierFilters``
(``outlierFilters.compute(reading, reference, matches)``, reference call
sites ``Localizer.hpp:330`` and ``LoopCloser.hpp:360``). The weights feed
both the error minimizer and the overlap statistic
(``weightedPointUsedRatio``), so their semantics directly gate keyframe
creation and loop-closure acceptance.

All filters are vectorized over the ``[Nq, k]`` match arrays; invalid
matches (masked query points or +inf distances) always get weight 0.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from .knn import Matches


@dataclasses.dataclass(frozen=True)
class TrimmedDist:
    """Keep the ``ratio`` fraction of matches with smallest distance
    (libpointmatcher ``TrimmedDistOutlierFilter``)."""
    ratio: float = 0.85


@dataclasses.dataclass(frozen=True)
class MaxDist:
    """Binary weight: distance <= ``max_dist`` (in meters, not squared)."""
    max_dist: float = 1.0


@dataclasses.dataclass(frozen=True)
class MedianDist:
    """Binary weight: distance <= ``factor`` * median distance."""
    factor: float = 3.0


@dataclasses.dataclass(frozen=True)
class SurfaceNormalOutlier:
    """Weight by agreement between reading and reference normals:
    w = 1 if |cos angle| >= cos(max_angle), else 0. Requires ``normals``
    on both clouds; silently passes through if absent."""
    max_angle: float = 1.0  # radians


OutlierChain = Tuple


def compute_weights(chain: OutlierChain, matches: Matches,
                    query_mask: jax.Array,
                    reading_normals=None, reference_normals=None
                    ) -> jax.Array:
    """Compose outlier filters multiplicatively, like libpointmatcher chains.

    Returns weights ``[Nq, k]`` with invalid matches zeroed.
    """
    d2 = matches.dists2
    valid = jnp.isfinite(d2) & query_mask[:, None]
    w = valid.astype(jnp.float32)
    n_valid = jnp.maximum(jnp.sum(valid), 1)

    for cfg in chain:
        if isinstance(cfg, TrimmedDist):
            w = w * _trimmed(d2, valid, cfg.ratio)
        elif isinstance(cfg, MaxDist):
            w = w * (d2 <= cfg.max_dist * cfg.max_dist).astype(w.dtype)
        elif isinstance(cfg, VarTrimmedDist):
            w = w * _var_trimmed(d2, valid, cfg)
        elif isinstance(cfg, MedianDist):
            med = _masked_quantile(d2, valid, 0.5, n_valid)
            w = w * (d2 <= cfg.factor * cfg.factor * med).astype(w.dtype)
        elif isinstance(cfg, SurfaceNormalOutlier):
            if reading_normals is not None and reference_normals is not None:
                cos = jnp.abs(jnp.sum(
                    reading_normals[:, None, :] * reference_normals, axis=-1))
                w = w * (cos >= jnp.cos(cfg.max_angle)).astype(w.dtype)
        else:
            raise TypeError(f"unknown outlier filter {type(cfg)}")
    return w


def _masked_quantile(d2, valid, q, n_valid):
    """Quantile of d2 over valid entries (invalid sorted to the end)."""
    flat = jnp.where(valid, d2, jnp.inf).reshape(-1)
    s = jnp.sort(flat)
    idx = jnp.clip((q * n_valid.astype(jnp.float32)).astype(jnp.int32),
                   0, flat.shape[0] - 1)
    return s[idx]


def _var_trimmed(d2, valid, cfg):
    """Binary keep-mask with the FTMP-optimal trim ratio.

    Vectorized over all candidate ratios: sort the distances, evaluate
    psi(k) = (cumsum_k / k) / (k / n_valid)^lam for every k in the
    [min_ratio, max_ratio] band, keep everything up to the argmin k.
    """
    flat = jnp.where(valid, d2, jnp.inf).reshape(-1)
    n = flat.shape[0]
    s = jnp.sort(flat)
    n_valid = jnp.maximum(jnp.sum(valid), 1)
    ks = jnp.arange(1, n + 1, dtype=jnp.float32)
    r = ks / n_valid.astype(jnp.float32)
    csum = jnp.cumsum(jnp.where(jnp.isfinite(s), s, 0.0))
    e = csum / ks
    psi = e / jnp.maximum(r, 1e-9) ** cfg.lam
    in_band = (r >= cfg.min_ratio) & (r <= cfg.max_ratio)
    psi = jnp.where(in_band, psi, jnp.inf)
    kth = jnp.argmin(psi)
    thresh = s[kth]
    return (d2 <= thresh).astype(jnp.float32)


def _trimmed(d2, valid, ratio):
    """Binary keep-mask for the trimmed-distance filter.

    Threshold = distance of the ceil(ratio * n_valid)-th smallest match, so
    exactly the closest ``ratio`` fraction survives (ties keep extras).
    """
    flat = jnp.where(valid, d2, jnp.inf).reshape(-1)
    s = jnp.sort(flat)
    n_valid = jnp.sum(valid)
    kth = jnp.clip(jnp.ceil(ratio * n_valid).astype(jnp.int32) - 1,
                   0, flat.shape[0] - 1)
    thresh = s[kth]
    return (d2 <= thresh).astype(jnp.float32)


@dataclasses.dataclass(frozen=True)
class VarTrimmedDist:
    """Auto-tuned trimmed-distance filter (libpointmatcher
    ``VarTrimmedDistOutlierFilter``): pick the trim ratio by minimizing
    Chetverikov's FTMP criterion psi(r) = e(r) / r^lambda, where e(r) is
    the mean squared distance of the closest ``r`` fraction. Adapts the
    inlier ratio per scan pair instead of fixing it a priori — the right
    choice when overlap varies widely (loop-closure verification against
    partially overlapping candidate maps)."""
    min_ratio: float = 0.2
    max_ratio: float = 0.99
    lam: float = 2.0
