"""Multi-device scaling layer.

The reference's only parallelism is three host threads over one mutex
(SURVEY.md §2c). The device scaling axes are:

* **dp (agents)** — batch whole registrations / SLAM instances across
  devices via ``vmap`` + sharding (:mod:`batched`).
* **tp (points)** — shard the reference cloud's point axis inside the
  correspondence search via ``shard_map`` + ``all_gather``
  (:mod:`multichip`), the ring-attention-shaped decomposition of kNN.

Pipeline/expert parallelism have no analog here (no layer stack, no MoE);
the actor pipeline maps to host-side threads in
:mod:`pgslam_tpu.pipeline`.
"""

from .batched import batched_register  # noqa: F401
