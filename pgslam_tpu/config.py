"""YAML configuration — a libpointmatcher-style schema subset.

The reference consumes libpointmatcher YAML for ICP pipelines and filter
chains and buffers the text to replay it into throwaway ICP objects
(``Localizer.hpp:55-71``, ``LoopCloser.hpp:59-74``). Here YAML parses once
into frozen config dataclasses (:class:`~pgslam_tpu.ops.icp.ICPConfig`
etc.), which are hashable and reused everywhere — the replay trick is
unnecessary because configs are values, not stateful objects.

Supported schema (names mirror libpointmatcher's)::

    readingDataPointsFilters:
      - RandomSamplingDataPointsFilter: {prob: 0.75}
    referenceDataPointsFilters:
      - SurfaceNormalDataPointsFilter: {knn: 10}
    matcher:
      KDTreeMatcher: {knn: 1}            # or GridMatcher: {cellSize: 1.0}
    outlierFilters:
      - TrimmedDistOutlierFilter: {ratio: 0.85}
      - MaxDistOutlierFilter: {maxDist: 1.0}
    errorMinimizer: PointToPlaneErrorMinimizer
    transformationCheckers:
      - CounterTransformationChecker: {maxIterationCount: 40}
      - DifferentialTransformationChecker: {minDiffTransErr: 0.001,
                                            minDiffRotErr: 0.001}

plus a top-level SLAM schema (``load_slam_config``) that nests an ``icp``
section per component and exposes the eight scalar thresholds the
reference sets programmatically (``Localizer.h:33-37``,
``LoopCloser.h:32-37``).
"""

from __future__ import annotations

import io
from typing import Any, Dict, List, Tuple, Union

from .ops import filters as F
from .ops import outlier as O
from .ops.icp import ICPConfig


def _safe_load(stream):
    import yaml  # PyYAML is needed only to read YAML configs
    return yaml.safe_load(stream)


_FILTERS = {
    "IdentityDataPointsFilter":
        lambda p: F.Identity(),
    "RandomSamplingDataPointsFilter":
        lambda p: F.RandomSampling(prob=float(p.get("prob", 0.75))),
    "MaxPointCountDataPointsFilter":
        lambda p: F.MaxPointCount(count=int(p.get("maxCount", 10000))),
    "MaxDistDataPointsFilter":
        lambda p: F.MaxDist(dist=float(p.get("maxDist", 100.0)),
                            dim=int(p.get("dim", -1))),
    "MinDistDataPointsFilter":
        lambda p: F.MinDist(dist=float(p.get("minDist", 0.5)),
                            dim=int(p.get("dim", -1))),
    "BoundingBoxDataPointsFilter":
        lambda p: F.BoundingBox(
            xmin=float(p.get("xMin", -1.0)), xmax=float(p.get("xMax", 1.0)),
            ymin=float(p.get("yMin", -1.0)), ymax=float(p.get("yMax", 1.0)),
            zmin=float(p.get("zMin", -1.0)), zmax=float(p.get("zMax", 1.0)),
            remove_inside=bool(p.get("removeInside", True))),
    "VoxelGridDataPointsFilter":
        lambda p: F.VoxelGrid(voxel_size=float(p.get("vSizeX", 0.2))),
    "ObservationDirectionDataPointsFilter":
        lambda p: F.ObservationDirection(x=float(p.get("x", 0.0)),
                                         y=float(p.get("y", 0.0)),
                                         z=float(p.get("z", 0.0))),
    "SurfaceNormalDataPointsFilter":
        lambda p: F.SurfaceNormal(knn=int(p.get("knn", 8))),
    "ShadowDataPointsFilter":
        lambda p: F.Shadow(eps=float(p.get("eps", 0.1))),
    "MaxDensityDataPointsFilter":
        lambda p: F.MaxDensity(radius=float(p.get("radius", 0.5)),
                               max_count=int(p.get("maxCount", 4))),
    "FixStepSamplingDataPointsFilter":
        lambda p: F.FixStepSampling(step=int(p.get("startStep", 2))),
}

_OUTLIERS = {
    "TrimmedDistOutlierFilter":
        lambda p: O.TrimmedDist(ratio=float(p.get("ratio", 0.85))),
    # YAML defaults match upstream libpointmatcher's
    # VarTrimmedDistOutlierFilter (minRatio 0.05, maxRatio 0.99,
    # lambda 2.35) so pipelines ported from the reference ecosystem trim
    # identically; the Python-level class keeps tighter SLAM-tuned
    # defaults (see MIGRATION.md).
    "VarTrimmedDistOutlierFilter":
        lambda p: O.VarTrimmedDist(
            min_ratio=float(p.get("minRatio", 0.05)),
            max_ratio=float(p.get("maxRatio", 0.99)),
            lam=float(p.get("lambda", 2.35))),
    "MaxDistOutlierFilter":
        lambda p: O.MaxDist(max_dist=float(p.get("maxDist", 1.0))),
    "MedianDistOutlierFilter":
        lambda p: O.MedianDist(factor=float(p.get("factor", 3.0))),
    "SurfaceNormalOutlierFilter":
        lambda p: O.SurfaceNormalOutlier(
            max_angle=float(p.get("maxAngle", 1.0))),
}

_MINIMIZERS = {
    "PointToPointErrorMinimizer": "point_to_point",
    "PointToPlaneErrorMinimizer": "point_to_plane",
}


def _named_entries(spec) -> List[Tuple[str, Dict[str, Any]]]:
    """Normalize '- Name: {params}' / '- Name' lists."""
    out = []
    if spec is None:
        return out
    for item in spec:
        if isinstance(item, str):
            out.append((item, {}))
        elif isinstance(item, dict):
            for name, params in item.items():
                out.append((name, params or {}))
        else:
            raise ValueError(f"bad chain entry: {item!r}")
    return out


def parse_filter_chain(spec) -> Tuple:
    chain = []
    for name, params in _named_entries(spec):
        if name not in _FILTERS:
            raise ValueError(f"unknown DataPointsFilter {name!r}")
        chain.append(_FILTERS[name](params))
    return tuple(chain)


def parse_outlier_chain(spec) -> Tuple:
    chain = []
    for name, params in _named_entries(spec):
        if name not in _OUTLIERS:
            raise ValueError(f"unknown OutlierFilter {name!r}")
        chain.append(_OUTLIERS[name](params))
    return tuple(chain)


def parse_icp_config(doc: Union[str, Dict, io.IOBase]) -> ICPConfig:
    """Parse a libpointmatcher-style ICP pipeline into an ICPConfig."""
    if isinstance(doc, (str, io.IOBase)):
        doc = _safe_load(doc)
    doc = doc or {}
    kwargs: Dict[str, Any] = {}

    kwargs["reading_filters"] = parse_filter_chain(
        doc.get("readingDataPointsFilters"))
    kwargs["reference_filters"] = parse_filter_chain(
        doc.get("referenceDataPointsFilters"))
    if "outlierFilters" in doc:
        kwargs["outlier"] = parse_outlier_chain(doc["outlierFilters"])

    matcher = doc.get("matcher")
    if matcher:
        if isinstance(matcher, str):
            name, params = matcher, {}
        else:
            name = next(iter(matcher))
            params = matcher[name] or {}
        if name == "KDTreeMatcher":
            # Exact kNN, the reference's kd-tree (Localizer.hpp:317): the
            # matcher kernel on the GPU, the tiled brute-force path with
            # identical semantics on the CPU (ops.knn_pallas.use_kernel).
            kwargs["matcher"] = "pallas"
            kwargs["knn"] = int(params.get("knn", 1))
        elif name == "BruteForceMatcher":
            kwargs["matcher"] = "brute"
            kwargs["knn"] = int(params.get("knn", 1))
        elif name == "GridMatcher":
            kwargs["matcher"] = "grid"
            kwargs["grid_cell_size"] = float(params.get("cellSize", 0.0))
            kwargs["grid_bucket_cap"] = int(params.get("bucketCap", 8))
            kwargs["knn"] = int(params.get("knn", 1))
        else:
            raise ValueError(f"unknown matcher {name!r}")

    minimizer = doc.get("errorMinimizer")
    if minimizer:
        if isinstance(minimizer, dict):
            minimizer = list(minimizer.keys())[0]
        if minimizer not in _MINIMIZERS:
            raise ValueError(f"unknown errorMinimizer {minimizer!r}")
        kwargs["error"] = _MINIMIZERS[minimizer]

    for name, params in _named_entries(doc.get("transformationCheckers")):
        if name == "CounterTransformationChecker":
            kwargs["max_iterations"] = int(params.get("maxIterationCount", 40))
        elif name == "DifferentialTransformationChecker":
            kwargs["trans_eps"] = float(params.get("minDiffTransErr", 1e-4))
            kwargs["rot_eps"] = float(params.get("minDiffRotErr", 1e-4))
        else:
            raise ValueError(f"unknown transformationChecker {name!r}")

    return ICPConfig(**kwargs)


def load_icp_config(path: str) -> ICPConfig:
    with open(path) as fh:
        return parse_icp_config(fh)


def load_input_filters(path: str) -> Tuple:
    """Parse an input-filter chain file (a bare YAML list of filters)."""
    with open(path) as fh:
        return parse_filter_chain(_safe_load(fh))


def load_slam_config(path: str):
    """Parse a full SLAM config (nested component sections)."""
    from .localizer import LocalizerConfig
    from .loopcloser import LoopCloserConfig
    from .optim.pgo import PGOConfig
    from .optimizer import OptimizerConfig
    from .slam import SlamConfig

    with open(path) as fh:
        doc = _safe_load(fh) or {}

    loc = doc.get("localizer", {}) or {}
    localizer = LocalizerConfig(
        local_map_size=int(loc.get("localMapSize", 3)),
        overlap_threshold=float(loc.get("overlapThreshold", 0.8)),
        minimal_overlap=float(loc.get("minimalOverlap", 0.5)),
        input_filters=parse_filter_chain(loc.get("inputFilters")),
        icp=parse_icp_config(loc.get("icp", {})),
        keyframe_cloud_capacity=int(loc.get("keyframeCloudCapacity", 1024)))

    lc = doc.get("loopCloser", {}) or {}
    loop_closer = LoopCloserConfig(
        topo_dist_threshold=float(lc.get("topoDistThreshold", 3.0)),
        geom_dist_threshold=float(lc.get("geomDistThreshold", 3.0)),
        overlap_threshold=float(lc.get("overlapThreshold", 0.8)),
        residual_error_threshold=float(
            lc.get("residualErrorThreshold", 5000.0)),
        candidate_local_map_size=int(lc.get("candidateLocalMapSize", 3)),
        icp=parse_icp_config(lc.get("icp", loc.get("icp", {}))))

    opt = doc.get("optimizer", {}) or {}
    # Only pass keys present in the YAML so an unset key means the
    # PGOConfig dataclass default — identical behavior to the
    # programmatic path (advisor finding r1).
    pgo_kwargs = {}
    for yaml_key, field, cast in (("maxIterations", "max_iterations", int),
                                  ("cgIterations", "cg_iterations", int),
                                  ("priorSigma", "prior_sigma", float)):
        if yaml_key in opt:
            pgo_kwargs[field] = cast(opt[yaml_key])
    optimizer = OptimizerConfig(
        pgo=PGOConfig(**pgo_kwargs),
        shape_bucket=int(opt.get("shapeBucket", 64)))

    return SlamConfig(
        localizer=localizer, loop_closer=loop_closer, optimizer=optimizer,
        sensor_cloud_capacity=int(doc.get("sensorCloudCapacity", 2048)))
