"""Platform plumbing: the compile-cache helper, the dataclass pytrees,
``chip_smoke.py``'s refusal to run without a GPU, and the absence of
imports of the Mosaic backend that only the previous accelerator had."""

import dataclasses
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pgslam_tpu.utils import compile_cache

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert compile_cache.enable_compile_cache() == str(REPO / ".jax_cache")
        assert calls == [("jax_compilation_cache_dir",
                          str(REPO / ".jax_cache"))]
    else:
        d = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", d)
        assert compile_cache.enable_compile_cache() == d
        assert calls == []          # JAX reads the variable itself


def _cloud():
    from pgslam_tpu.cloud import make_cloud
    return make_cloud(np.arange(12, dtype=np.float32).reshape(4, 3),
                      capacity=6)


def _matches():
    from pgslam_tpu.ops.knn import Matches
    return Matches(dists2=jnp.ones((4, 1)), ids=jnp.zeros((4, 1), jnp.int32))


def _icp_result():
    from pgslam_tpu.ops.icp import ICPResult
    return ICPResult(T=jnp.eye(4), iterations=jnp.int32(3),
                     converged=jnp.bool_(True),
                     max_iter_reached=jnp.bool_(False),
                     overlap=jnp.float32(0.9), residual=jnp.float32(1.0),
                     cov=jnp.eye(6), diverged=jnp.bool_(False))


def _error_elements():
    from pgslam_tpu.ops.minimizer import ErrorElements
    return ErrorElements(reading=jnp.ones((5, 3)), reference=jnp.zeros((5, 3)),
                         weights=jnp.ones(5), normals=None)


def _grid_index():
    from pgslam_tpu.ops.gridknn import build_grid_index
    pts = jnp.asarray(np.random.default_rng(0).uniform(0, 4, (32, 3)),
                      jnp.float32)
    return build_grid_index(pts, jnp.ones(32, bool), cell_size=1.0,
                            bucket_cap=4)


@pytest.mark.parametrize("make", [_cloud, _matches, _icp_result,
                                  _error_elements, _grid_index])
def test_dataclass_pytrees(make):
    obj = make()
    leaves, treedef = jax.tree_util.tree_flatten(obj)
    assert leaves and all(isinstance(x, jax.Array) for x in leaves)
    # tree_map keeps the type and the field order
    doubled = jax.tree_util.tree_map(lambda x: x * 2, obj)
    assert type(doubled) is type(obj)
    for a, b in zip(jax.tree_util.tree_leaves(doubled), leaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b) * 2)
    # through jit, and through vmap over a stacked batch
    back = jax.jit(lambda o: o)(obj)
    assert jax.tree_util.tree_structure(back) == treedef
    stacked = jax.tree_util.tree_map(lambda x: jnp.stack([x, x]), obj)
    out = jax.vmap(lambda o: jax.tree_util.tree_map(lambda x: x + 1, o))(
        stacked)
    assert type(out) is type(obj)
    np.testing.assert_array_equal(
        np.asarray(jax.tree_util.tree_leaves(out)[0][1]),
        np.asarray(leaves[0]) + 1)
    # frozen, with the replace() the code relies on
    name = dataclasses.fields(obj)[0].name
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(obj, name, None)
    swapped = obj.replace(**{name: getattr(doubled, name)})
    assert type(swapped) is type(obj) and swapped is not obj
    np.testing.assert_array_equal(np.asarray(getattr(swapped, name)),
                                  np.asarray(getattr(doubled, name)))


def test_chip_smoke_refuses_without_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    runs = [subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                           cwd=REPO, env=env, capture_output=True,
                           text=True, timeout=300)]
    # and alone, without the rest of the repository
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    runs.append(subprocess.run([sys.executable, "chip_smoke.py"],
                               cwd=tmp_path, env=env, capture_output=True,
                               text=True, timeout=300))
    for r in runs:
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
        assert "[slam]" not in r.stdout      # no phase started


def test_package_has_no_mosaic_backend_imports():
    # Spelled in pieces so that this file does not match itself.
    backend = "t" + "pu"
    forbidden = (f"pallas.{backend}", f"pallas import {backend}",
                 f"pl{backend}")
    offenders = [str(path.relative_to(REPO))
                 for path in (REPO / "pgslam_tpu").rglob("*.py")
                 if any(f in path.read_text() for f in forbidden)]
    assert offenders == []
