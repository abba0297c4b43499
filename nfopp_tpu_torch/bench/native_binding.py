"""ctypes binding for the native path-statistics evaluator (port of
`nfopp_tpu/bench/native_binding.py`).

The port keeps its own copy of the C++ source (`native/path_stats.cpp`) and
builds it on first use, with the host's C++ compiler and the flags of
`nfopp_tpu/bench/native/Makefile`, into `kernels/build/` (which git
ignores), named by a hash of the source and flags, so an edited source
rebuilds. It never loads the JAX package's library. This is host code, not a
device kernel. `available()` gates callers; the numpy implementation in
`metrics.py` is the drop-in fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import numpy as np

__all__ = [
    "available",
    "library_path",
    "path_stats_native",
    "path_stats_batch_native",
    "path_clearance_segments_native",
]

SOURCE = pathlib.Path(__file__).resolve().parent / "native" / "path_stats.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "kernels" / "build"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared"]

_lock = threading.Lock()
_lib = None
_build_failed = False


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libpath_stats_{digest.hexdigest()[:16]}.so"


def _build(target: pathlib.Path) -> None:
    """Compile into a temporary file and rename it into place, so processes
    building at once never load a half-written library."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise FileNotFoundError("no C++ compiler (g++ / c++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = pathlib.Path(tmp) / target.name
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(out), str(SOURCE)], check=True,
                       capture_output=True)
        os.replace(out, target)


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        target = library_path()
        try:
            if not target.exists():
                _build(target)
            lib = ctypes.CDLL(str(target))
        except (subprocess.CalledProcessError, FileNotFoundError, OSError):
            _build_failed = True
            return None
        dp, i64, f64 = ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_double
        lib.nfopp_path_stats.argtypes = [dp, i64, dp, i64, f64, f64, dp]
        lib.nfopp_path_stats_batch.argtypes = [dp, i64, i64, dp, i64, f64, f64, dp]
        lib.nfopp_path_clearance_segments.argtypes = [dp, i64, dp, i64, dp]
        for fn in (lib.nfopp_path_stats, lib.nfopp_path_stats_batch,
                   lib.nfopp_path_clearance_segments):
            fn.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _as_c(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _lib_or_raise():
    lib = _load()
    if lib is None:
        raise RuntimeError("native metrics library unavailable")
    return lib


def _obstacles(obstacles):
    """(pointer, count, array kept alive by the caller) of [M, 2] obstacles."""
    if obstacles is not None and len(obstacles):
        obstacles = np.ascontiguousarray(obstacles, np.float64)
        return _as_c(obstacles), len(obstacles), obstacles
    return None, 0, None


def path_stats_native(
    path: np.ndarray,
    obstacles: np.ndarray | None = None,
    angular_weight: float = 1.0,
    cusp_threshold: float = np.pi / 2,
) -> np.ndarray:
    """[N, 3] path -> raw [12] stats vector (see path_stats.cpp header)."""
    lib = _lib_or_raise()
    path = np.ascontiguousarray(path, np.float64)
    out = np.zeros(12, np.float64)
    obs_ptr, m, _keep = _obstacles(obstacles)
    lib.nfopp_path_stats(
        _as_c(path), len(path), obs_ptr, m, angular_weight, cusp_threshold, _as_c(out)
    )
    return out


def path_clearance_segments_native(
    path: np.ndarray, segments: np.ndarray
) -> np.ndarray:
    """[N, 3] path, [S, 4] segment rows (x0, y0, x1, y1) -> [4] clearance
    stats (mean, median, min, max) measured EXACTLY against the segments."""
    lib = _lib_or_raise()
    path = np.ascontiguousarray(path, np.float64)
    segments = np.ascontiguousarray(segments, np.float64)
    out = np.zeros(4, np.float64)
    lib.nfopp_path_clearance_segments(
        _as_c(path), len(path), _as_c(segments), len(segments), _as_c(out)
    )
    return out


def path_stats_batch_native(
    paths: np.ndarray,
    obstacles: np.ndarray | None = None,
    angular_weight: float = 1.0,
    cusp_threshold: float = np.pi / 2,
) -> np.ndarray:
    """[B, N, 3] paths -> [B, 12] stats."""
    lib = _lib_or_raise()
    paths = np.ascontiguousarray(paths, np.float64)
    batch, n, _ = paths.shape
    out = np.zeros((batch, 12), np.float64)
    obs_ptr, m, _keep = _obstacles(obstacles)
    lib.nfopp_path_stats_batch(
        _as_c(paths), batch, n, obs_ptr, m, angular_weight, cusp_threshold, _as_c(out)
    )
    return out
