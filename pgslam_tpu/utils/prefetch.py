"""Host->device transfer / compute double-buffering.

The pipeline-parallel analog from SURVEY.md §2c: while scan t's
registration computes on device, scan t+1's padded cloud is already in
flight over PCIe (JAX transfers are asynchronous — ``device_put``
returns immediately and the copy overlaps whatever the device is doing),
so the transfer hides behind compute.

Usage::

    for cloud in prefetch_clouds(raw_scans, capacity=2048):
        slam.add_data(t, "world", odom[t], T_rs, cloud)
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator, Optional

import jax
import numpy as np

from ..cloud import Cloud, make_cloud


def prefetch_clouds(scans: Iterable[np.ndarray], capacity: int,
                    depth: int = 2,
                    sharding: Optional[jax.sharding.Sharding] = None
                    ) -> Iterator[Cloud]:
    """Yield device-resident :class:`Cloud` objects for an iterable of raw
    ``[N, 3]`` scans, keeping ``depth`` transfers in flight ahead of the
    consumer. ``sharding`` optionally places the transfers directly onto a
    mesh (so the batched paths skip a device-to-device reshard)."""
    if depth < 1:
        raise ValueError("depth must be >= 1")

    def put(scan) -> Cloud:
        cloud = scan if isinstance(scan, Cloud) else make_cloud(
            np.asarray(scan), capacity=capacity)
        if sharding is not None:
            cloud = jax.device_put(cloud, sharding)
        return cloud

    queue: collections.deque = collections.deque()
    it = iter(scans)
    try:
        for _ in range(depth):
            queue.append(put(next(it)))
    except StopIteration:
        pass
    while queue:
        ready = queue.popleft()
        try:
            queue.append(put(next(it)))
        except StopIteration:
            pass
        yield ready


def prefetch_batches(batches: Iterable, depth: int = 1) -> Iterator:
    """Generic async double-buffer: ``device_put`` every array leaf of each
    batch ``depth`` steps ahead of the consumer (multi-agent fleets feed
    ``[B, N, 3]`` stacks rather than single clouds)."""
    queue: collections.deque = collections.deque()

    def put(tree):
        return jax.tree_util.tree_map(
            lambda x: jax.device_put(np.asarray(x))
            if isinstance(x, (np.ndarray, list)) or np.isscalar(x) else x,
            tree)

    it = iter(batches)
    try:
        for _ in range(depth):
            queue.append(put(next(it)))
    except StopIteration:
        pass
    while queue:
        ready = queue.popleft()
        try:
            queue.append(put(next(it)))
        except StopIteration:
            pass
        yield ready
