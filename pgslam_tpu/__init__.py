"""pgslam_tpu — a pose-graph SLAM framework in JAX.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of the reference
C++ library ``Ellon/pgslam`` (header-only orchestration over
libpointmatcher ICP + GTSAM optimization + Boost.Graph). The compute core —
kNN correspondence search, filter chains, rigid-transform estimation, and
SE(3) pose-graph optimization — runs as fixed-shape jitted code on the GPU;
the pose graph and pipeline orchestration run host-side with an optional
C++ native graph core.

Public API mirrors the reference facade (``PoseGraphSlam.h:17-62``):

    slam = PoseGraphSlam(config)
    slam.add_data(timestamp, frame_id, T_world_robot, T_robot_sensor, cloud)
    slam.write_graphviz(path)
"""

__version__ = "0.1.0"

import jax as _jax

# SE(3) math, 6x6 solves and the one-hot incidence gathers need true fp32
# products; on the GPU a float32 matmul otherwise runs in TF32 (about
# three decimal digits). Hot paths that can tolerate lower precision
# request it explicitly.
_jax.config.update("jax_default_matmul_precision", "highest")

from . import se3, metrics  # noqa: F401
from .cloud import Cloud, make_cloud, empty_cloud, transform_cloud  # noqa: F401
from .ops.icp import ICPConfig, ICPEngine, ICPResult, icp  # noqa: F401

__all__ = [
    "se3", "metrics", "Cloud", "make_cloud", "empty_cloud",
    "transform_cloud", "ICPConfig", "ICPEngine", "ICPResult", "icp",
]


def __getattr__(name):
    # Lazy imports of heavier layers to keep `import pgslam_tpu` cheap.
    if name in ("PoseGraphSlam", "SlamConfig"):
        from . import slam
        return getattr(slam, name)
    if name == "PoseGraphSlamMT":
        from .pipeline import PoseGraphSlamMT
        return PoseGraphSlamMT
    if name == "PoseGraph":
        from .graph.pose_graph import PoseGraph
        return PoseGraph
    if name == "LocalMap":
        from .localmap import LocalMap
        return LocalMap
    if name == "MultiAgentSlam":
        from .parallel.multi_agent import MultiAgentSlam
        return MultiAgentSlam
    if name in ("LocalizerConfig", "Localizer"):
        from . import localizer
        return getattr(localizer, name)
    if name in ("LoopCloserConfig", "LoopCloser"):
        from . import loopcloser
        return getattr(loopcloser, name)
    if name in ("OptimizerConfig", "Optimizer"):
        from . import optimizer
        return getattr(optimizer, name)
    if name in ("PGOConfig", "optimize_pose_graph", "pose_marginals"):
        from .optim import pgo
        return getattr(pgo, name)
    if name in ("save_checkpoint", "load_checkpoint",
                "save_trajectory_kitti", "load_trajectory_kitti",
                "save_trajectory_tum", "load_trajectory_tum"):
        from . import io
        return getattr(io, name)
    if name in ("ate_rmse", "rpe", "align_umeyama"):
        from . import eval as _eval
        return getattr(_eval, name)
    if name == "make_sharded_register":
        from .parallel.sharded_icp import make_sharded_register
        return make_sharded_register
    if name in ("prefetch_clouds", "prefetch_batches"):
        from .utils import prefetch
        return getattr(prefetch, name)
    if name == "ScanLoader":
        from .native import ScanLoader
        return ScanLoader
    if name in ("load_kitti_bin", "save_kitti_bin", "harsh_velodyne_pair"):
        from . import datasets
        return getattr(datasets, name)
    raise AttributeError(f"module 'pgslam_tpu' has no attribute {name!r}")
