"""Device compute kernels for the ICP engine.

This package replaces the numeric core the reference delegates to
libpointmatcher (SURVEY.md §2b): correspondence search (:mod:`knn`,
:mod:`gridknn`), data-point filter chains (:mod:`filters`), outlier
weighting (:mod:`outlier`), rigid-transform estimation and introspection
(:mod:`minimizer`), and the ICP driver itself (:mod:`icp`).
"""

from .knn import Matches, knn_brute_force  # noqa: F401
