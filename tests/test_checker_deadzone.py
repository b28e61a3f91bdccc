"""Convergence-checker dead-zone guard.

The differential checker smooths the last ``smooth_length`` deltas over
an inf-initialized window, so ``converged`` is unreachable before the
window fills: a profile with ``max_iterations < smooth_length`` reports
``max_iter_reached=True`` unconditionally — and loop-closure acceptance
rejects on exactly that flag (``LoopCloser.hpp:317``). Equality is the
margin-0 warning tier: the window fills on the final body iteration and
``converged`` is computed after the push, so it CAN still fire there. These tests pin
the guard: structural dead zones ERROR at LoopCloser config time, the
one-iteration-of-room flagship profile WARNS, and the localizer-side
engine only logs (it never rejects on the flag).
"""

import logging

import numpy as np
import pytest

from pgslam_tpu.graph.pose_graph import MapManager
from pgslam_tpu.loopcloser import LoopCloser, LoopCloserConfig
from pgslam_tpu.ops.icp import (ICPConfig, ICPEngine, ICPResult,
                                eps_dead_zone, eps_margin)
from pgslam_tpu.optimizer import Optimizer


def _dead_cfg():
    # Strictly below the window length: the checker structurally cannot
    # fire. mi == smooth_length is NOT dead (the window fills, and
    # converged is computed after the push, on the final body iteration).
    return ICPConfig(max_iterations=3, smooth_length=4)


def _flagship_like_cfg():
    # bench.py's throughput profile shape: mi=5 with the default
    # smooth_length=4 — the checker can only fire in its final iteration.
    return ICPConfig(max_iterations=5, smooth_length=4,
                     trans_eps=1e-4, rot_eps=1e-4)


def test_dead_zone_detection():
    assert eps_dead_zone(_dead_cfg()) is not None
    assert eps_dead_zone(ICPConfig(max_iterations=30)) is None
    assert eps_dead_zone(ICPConfig(max_iterations=10, trans_eps=0.0)) \
        is not None
    # Equality is margin 0 — reachable on the final iteration, so it is
    # NOT a structural dead zone (the off-by-one).
    eq = ICPConfig(max_iterations=4, smooth_length=4)
    assert eps_dead_zone(eq) is None
    assert eps_margin(eq) == 0
    assert eps_margin(_flagship_like_cfg()) == 1


def test_loopcloser_rejects_dead_profile():
    mm = MapManager()
    opt = Optimizer(mm)
    with pytest.raises(ValueError, match="never report convergence"):
        LoopCloser(mm, opt, LoopCloserConfig(icp=_dead_cfg()))


def test_loopcloser_warns_on_flagship_profile(caplog):
    mm = MapManager()
    opt = Optimizer(mm)
    with caplog.at_level(logging.WARNING, logger="pgslam_tpu.loopcloser"):
        lc = LoopCloser(mm, opt, LoopCloserConfig(icp=_flagship_like_cfg()))
    assert any("only fire in the final iteration" in r.message
               for r in caplog.records)
    # ... and the behavior the warning flags: a max-iter result is
    # rejected as a closure regardless of its overlap/residual quality.
    res = ICPResult(T=np.eye(4, dtype=np.float32),
                    iterations=np.int32(5), converged=np.bool_(False),
                    max_iter_reached=np.bool_(True),
                    overlap=np.float32(0.95), residual=np.float32(1.0),
                    cov=np.eye(6, dtype=np.float32),
                    diverged=np.bool_(False))
    assert lc.check_icp_result(res, residual=1.0) is False


def test_set_icp_config_validates(tmp_path):
    yaml = tmp_path / "dead.yaml"
    yaml.write_text(
        "errorMinimizer: PointToPointErrorMinimizer\n"
        "transformationCheckers:\n"
        "  - CounterTransformationChecker:\n"
        "      maxIterationCount: 3\n")
    mm = MapManager()
    opt = Optimizer(mm)
    lc = LoopCloser(mm, opt, LoopCloserConfig(icp=ICPConfig()))
    with pytest.raises(ValueError, match="never report convergence"):
        lc.set_icp_config(str(yaml))


def test_equality_profile_can_converge():
    # Behavioral pin for the boundary: at mi == smooth_length the window
    # fully fills on the final body iteration and converged is computed
    # after the push, so a trivially-converged registration (identical
    # clouds, identity init) DOES report converged=True there.
    from pgslam_tpu.cloud import make_cloud
    from pgslam_tpu.ops.icp import icp_core
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    cloud = make_cloud(pts)
    cfg = ICPConfig(max_iterations=4, smooth_length=4,
                    trans_eps=1e-3, rot_eps=1e-3)
    res = icp_core(cloud, cloud, np.eye(4, dtype=np.float32), cfg)
    assert bool(res.converged)
    assert not bool(res.max_iter_reached)


def test_engine_only_warns(caplog):
    # Localizer-side engines never reject on max_iter_reached: the dead
    # zone is legal there (fixed-budget throughput profiles), logged only.
    with caplog.at_level(logging.WARNING, logger="pgslam_tpu.icp"):
        ICPEngine(_dead_cfg())
    assert any("can never fire" in r.message for r in caplog.records)
