"""ctypes bindings for the repository's native host-ops library,
`cpp/host_ops.cpp` (the JAX package's `utils/native.py`).

The pair loops of the empirical initialization run on the host in both
packages: the semivariogram of one series and of every column, the
windowed scatter covariances and the 1-D nearest-neighbour search.  The
library is built with `g++` at first use into the repository's `build/`
directory (named by a hash of the source, the flags and the host's CPU
features), with the JAX
package's Makefile flags, so both packages' libraries compute the same
bits; the JAX package's own `cpp/libcnmgp_host.so` is never loaded.  Where
no compiler is present `available()` is False and every function takes its
NumPy version, the same loops in the same pair order, as the JAX package
does.  Nothing is compiled or loaded at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "available",
    "semivariogram",
    "semivariogram_multi",
    "windowed_scatter_cov",
    "knn_1d",
]

_ROOT = Path(__file__).resolve().parents[2]
_SOURCE = _ROOT / "cpp" / "host_ops.cpp"
_BUILD = _ROOT / "build"
# cpp/Makefile's CXXFLAGS, and a shared library
_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _cpu_features() -> bytes:
    """This host's CPU feature flags: `-march=native` builds for them, so a
    library built on another host is not loaded here."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((line for line in f if line.startswith(b"flags")), b"")
    except OSError:
        return b""


def _library_path() -> Path:
    key = _SOURCE.read_bytes() + " ".join(_FLAGS).encode() + _cpu_features()
    return _BUILD / f"libcnmgp_host-{hashlib.sha1(key).hexdigest()[:12]}.so"


def _build(out: Path) -> bool:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None or not _SOURCE.exists():
        return False
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *_FLAGS, "-o", str(tmp), str(_SOURCE)], check=True,
                       capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    tmp.replace(out)  # atomic: a process that races this one loads a whole file
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = _library_path()
    if not path.exists() and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    dptr = ctypes.POINTER(ctypes.c_double)
    iptr = ctypes.POINTER(ctypes.c_int64)
    i64 = ctypes.c_int64
    for name, argtypes in (("semivariogram", [dptr, dptr, i64, dptr, dptr]),
                           ("semivariogram_multi", [dptr, dptr, i64, i64, dptr, dptr]),
                           ("windowed_scatter_cov", [dptr, i64, i64, i64, dptr]),
                           ("knn_1d", [dptr, i64, dptr, i64, i64, iptr])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, None
    _lib = lib
    return _lib


def available() -> bool:
    """True when the library is built (or builds now) and loads."""
    return _load() is not None


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _pairs(x, Y):
    """All pairs i < j in row-major order: (lag (P,), sv (m, P))."""
    iu, ju = np.triu_indices(x.shape[0], k=1)
    return x[ju] - x[iu], (0.5 * (Y[ju] - Y[iu]) ** 2).T


def semivariogram(x, y) -> Tuple[np.ndarray, np.ndarray]:
    """All-pairs semivariogram of one series: (lag, sv), pairs i < j in
    row-major order."""
    x = np.ascontiguousarray(x, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float64)
    n = x.shape[0]
    lib = _load()
    if lib is None:
        lag, sv = _pairs(x, y[:, None])
        return lag, sv[0]
    npairs = n * (n - 1) // 2
    lag, sv = np.empty(npairs), np.empty(npairs)
    lib.semivariogram(_dp(x), _dp(y), n, _dp(lag), _dp(sv))
    return lag, sv


def semivariogram_multi(x, Y) -> Tuple[np.ndarray, np.ndarray]:
    """All-pairs semivariograms of every column of Y (n, m): (lag (P,),
    sv (m, P))."""
    x = np.ascontiguousarray(x, dtype=np.float64)
    Y = np.ascontiguousarray(Y, dtype=np.float64)
    n, m = Y.shape
    lib = _load()
    if lib is None:
        return _pairs(x, Y)
    npairs = n * (n - 1) // 2
    lag, sv = np.empty(npairs), np.empty((m, npairs))
    lib.semivariogram_multi(_dp(x), _dp(Y), n, m, _dp(lag), _dp(sv))
    return lag, sv


def windowed_scatter_cov(Y, window: int) -> np.ndarray:
    """Per-point windowed scatter covariances (n, m, m): out[p] = Y[s:e]^T
    Y[s:e] / max(e - s - 1, 1), s = max(0, p - window), e = min(p + window,
    n - 1) (the reference's window convention, empirical_estimation.py:
    80-82)."""
    Y = np.ascontiguousarray(Y, dtype=np.float64)
    n, m = Y.shape
    out = np.empty((n, m, m))
    lib = _load()
    if lib is None:
        for p in range(n):
            seg = Y[max(0, p - window):min(p + window, n - 1)]
            out[p] = seg.T @ seg / max(seg.shape[0] - 1, 1)
        return out
    lib.windowed_scatter_cov(_dp(Y), n, m, window, _dp(out))
    return out


def knn_1d(x, z, k: int) -> np.ndarray:
    """Indices (nz, k) of the k nearest x to each z, nearest first, ties by
    index; past len(x) the last one repeats."""
    x = np.ascontiguousarray(x, dtype=np.float64)
    z = np.ascontiguousarray(np.reshape(z, -1), dtype=np.float64)
    lib = _load()
    if lib is None:
        rows = []
        for zq in z:
            order = np.argsort(np.abs(x - zq), kind="stable")[:k]
            rows.append(np.concatenate([order, np.repeat(order[-1:], k - order.shape[0])]))
        return np.stack(rows).astype(np.int64) if rows else np.empty((0, k), np.int64)
    out = np.empty((z.shape[0], k), dtype=np.int64)
    lib.knn_1d(_dp(x), x.shape[0], _dp(z), z.shape[0], k,
               out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out
