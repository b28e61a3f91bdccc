"""Test configuration.

Tests run on the CPU backend unless ``JAX_PLATFORMS`` says otherwise
(``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`` runs the tests
that need the card). The CPU backend gets 8 virtual devices so the
multi-device sharding paths compile and execute without several cards;
XLA_FLAGS must be set before the first backend init.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import time  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from pgslam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none. Decided
    here, at run time, never while a test module is imported."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda)")
    return devices[0]


# ---- fast-tier wall-clock budget guard ----
# The default tier must stay a quick pre-commit gate (~5 min). The guard
# only arms on FULL unfiltered fast-tier runs, and the hard threshold is
# deliberately loose (2x the target) because a shared host's speed swings
# widely — the guard exists to catch structural growth (a new expensive
# test landing untiered), not tenancy noise.
_BUDGET_WARN_S = 400.0
_BUDGET_FAIL_S = 900.0
_t_session = None


def pytest_configure(config):
    global _t_session
    # Arm only for the default fast tier: no -k filter and the markexpr
    # is pytest.ini's addopts default ("not slow").
    if not config.option.keyword and \
            config.option.markexpr == "not slow":
        _t_session = time.monotonic()


def pytest_sessionfinish(session, exitstatus):
    if _t_session is None:
        return
    dt = time.monotonic() - _t_session
    if dt > _BUDGET_FAIL_S:
        session.exitstatus = 1
        print(f"\nFAST-TIER BUDGET EXCEEDED: {dt:.0f}s > "
              f"{_BUDGET_FAIL_S:.0f}s — move new expensive tests to the "
              f"slow tier (@pytest.mark.slow)")
    elif dt > _BUDGET_WARN_S:
        print(f"\nfast-tier budget warning: {dt:.0f}s "
              f"(target < {_BUDGET_WARN_S:.0f}s)")
