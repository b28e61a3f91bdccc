"""Frozen dataclasses registered as JAX pytrees."""

from __future__ import annotations

import dataclasses

import jax


def pytree_dataclass(cls):
    """Make ``cls`` a frozen dataclass whose fields are all pytree leaves
    (in field order), with a ``replace(**changes)`` method."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    names = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=names, meta_fields=[])
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return cls
