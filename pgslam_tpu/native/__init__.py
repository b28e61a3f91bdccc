"""Native (C++) runtime components, loaded via ctypes.

``graph_core.cpp`` provides the pose-graph shortest-path engine (the role
Boost.Graph plays in the reference); ``scan_loader.cpp`` is the async
scan-stream IO worker (threaded KITTI ``.bin`` reader with prefetch). The
library is compiled on first use with the system toolchain, into a file
named after a hash of the sources, so a library built elsewhere or from
other sources is never loaded; if
compilation fails (no compiler in a restricted environment), everything
degrades gracefully to the pure-Python implementations
(:mod:`pgslam_tpu.graph.shortest_path`,
:func:`pgslam_tpu.datasets.load_kitti_bin`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_DIR, "graph_core.cpp"),
         os.path.join(_DIR, "scan_loader.cpp")]

_lib = None


def library_path() -> str:
    """Where the library built from the current sources lives."""
    h = hashlib.sha256()
    for src in _SRCS:
        with open(src, "rb") as fh:
            h.update(fh.read())
    return os.path.join(_DIR, f"libpgslam_graph_{h.hexdigest()[:16]}.so")


def _build(path: str) -> bool:
    # Build to a private name, then rename: concurrent importers (test
    # workers) never load a half-written library.
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-pthread",
             *_SRCS, "-o", tmp],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not os.path.exists(path) and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.pg_dijkstra.restype = ctypes.c_int
    lib.pg_dijkstra.argtypes = [
        ctypes.c_int, ctypes.c_int, i32p, i32p, f32p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, f32p, i32p]
    lib.pg_components.restype = ctypes.c_int
    lib.pg_components.argtypes = [ctypes.c_int, ctypes.c_int, i32p, i32p,
                                  i32p]
    lib.sl_open.restype = ctypes.c_int
    lib.sl_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
                            ctypes.c_int]
    lib.sl_count.restype = ctypes.c_int
    lib.sl_count.argtypes = [ctypes.c_int]
    lib.sl_max_points.restype = ctypes.c_long
    lib.sl_max_points.argtypes = [ctypes.c_int]
    lib.sl_next.restype = ctypes.c_long
    lib.sl_next.argtypes = [ctypes.c_int, f32p, ctypes.c_void_p,
                            ctypes.c_long]
    i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    lib.sl_next_q.restype = ctypes.c_long
    lib.sl_next_q.argtypes = [ctypes.c_int, i16p, ctypes.c_long]
    lib.sl_eos.restype = ctypes.c_int
    lib.sl_eos.argtypes = [ctypes.c_int]
    lib.sl_close.restype = None
    lib.sl_close.argtypes = [ctypes.c_int]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def native_dijkstra(n_vertices: int, edge_from, edge_to, weights,
                    source: int, vertex_ok=None, edge_ok=None,
                    max_settled: Optional[int] = None):
    """Drop-in for :func:`pgslam_tpu.graph.shortest_path.dijkstra`.
    Returns (dists [n], settled list) or raises ImportError if the native
    library is unavailable."""
    lib = _load()
    if lib is None:
        raise ImportError("native graph core unavailable")
    ne = len(edge_from)
    ef = np.ascontiguousarray(edge_from, np.int32)
    et = np.ascontiguousarray(edge_to, np.int32)
    w = np.ascontiguousarray(weights, np.float32)
    dist = np.empty(n_vertices, np.float32)
    settled = np.empty(max(n_vertices, 1), np.int32)

    def mask_ptr(m):
        if m is None:
            return None
        arr = np.ascontiguousarray(np.asarray(m, bool).view(np.uint8))
        return arr.ctypes.data_as(ctypes.c_void_p), arr

    vp = mask_ptr(vertex_ok)
    ep = mask_ptr(edge_ok)
    n = lib.pg_dijkstra(
        n_vertices, ne, ef, et, w, int(source),
        vp[0] if vp else None, ep[0] if ep else None,
        0 if max_settled is None else int(max_settled), dist, settled)
    return dist, settled[:n].tolist()


def native_components(n_vertices: int, edge_from, edge_to):
    lib = _load()
    if lib is None:
        raise ImportError("native graph core unavailable")
    ef = np.ascontiguousarray(edge_from, np.int32)
    et = np.ascontiguousarray(edge_to, np.int32)
    labels = np.empty(n_vertices, np.int32)
    n = lib.pg_components(n_vertices, len(ef), ef, et, labels)
    return n, labels


class ScanLoader:
    """Async scan stream over a directory of KITTI ``.bin`` files, backed
    by the native IO worker (a background thread reads and parses ahead of
    the consumer). Iterate to get ``[N, 3]`` float32 arrays in filename
    order; combine with :func:`pgslam_tpu.utils.prefetch.prefetch_clouds`
    for disk -> host -> device triple overlap.
    """

    def __init__(self, directory: str, ext: str = ".bin",
                 prefetch_depth: int = 2, with_reflectance: bool = False,
                 quantize_mm: bool = False):
        """``quantize_mm=True`` yields int16 MILLIMETER fixed-point
        ``[N, 3]`` arrays instead of float32: the loader's IO thread
        quantizes (1 mm grid = 0.5 mm max round-off vs ~10 mm LiDAR
        range noise; points beyond the +-32.767 m int16 envelope are
        dropped), and the packed stream halves host->device bytes. Every
        jitted ingest path dequantizes int16 clouds in-graph
        (``pgslam_tpu.cloud.MM_SCALE`` protocol). The quantize flag is
        plumbed into the loader: float-path consumers never pay the
        per-scan int16 conversion on the host."""
        lib = _load()
        if lib is None:
            raise ImportError("native scan loader unavailable")
        self._lib = lib
        self._h = lib.sl_open(directory.encode(), ext.encode(),
                              int(prefetch_depth), 1 if quantize_mm else 0)
        if self._h < 0:
            raise FileNotFoundError(
                f"no '{ext}' scans under {directory!r}")
        self._cap = int(lib.sl_max_points(self._h))
        self._with_refl = with_reflectance
        self._quant = quantize_mm
        if quantize_mm and with_reflectance:
            raise ValueError("quantize_mm drops reflectance")

    def __len__(self) -> int:
        return int(self._lib.sl_count(self._h))

    def __iter__(self):
        return self

    def __next__(self):
        # End-of-stream is the DISTINCT -3 code (and sl_eos); a failed
        # read (-2) or a legitimately empty scan (0 points — e.g. every
        # point dropped by the int16 envelope) is SKIPPED, never allowed
        # to truncate the rest of the sequence mid-stream.
        while True:
            if self._h < 0:
                raise StopIteration
            if self._quant:
                q = np.empty((self._cap, 3), np.int16)
                n = self._lib.sl_next_q(self._h, q, self._cap)
            else:
                xyz = np.empty((self._cap, 3), np.float32)
                refl = (np.empty(self._cap, np.float32)
                        if self._with_refl else None)
                refl_ptr = (refl.ctypes.data_as(ctypes.c_void_p)
                            if refl is not None else None)
                n = self._lib.sl_next(self._h, xyz, refl_ptr, self._cap)
            if n == -3 or n == -1:          # end of stream / dead handle
                self.close()
                raise StopIteration
            if n == -4:
                raise RuntimeError(
                    "ScanLoader opened with quantize_mm=False cannot "
                    "serve the int16 stream")
            if n <= 0:                      # failed read or empty scan
                continue
            if self._quant:
                return np.ascontiguousarray(q[:n])
            pts = np.ascontiguousarray(xyz[:n])
            if self._with_refl:
                return pts, np.ascontiguousarray(refl[:n])
            return pts

    def close(self) -> None:
        if self._h >= 0:
            self._lib.sl_close(self._h)
            self._h = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
