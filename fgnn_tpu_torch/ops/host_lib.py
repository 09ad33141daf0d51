"""Build and bind the port's host sampling library (``csrc/fgnn_host.cpp``).

The counterpart of ``fgnn_tpu/native``: the arch0 engine's khop, weighted
and random-walk samplers and its dedup, in C++ with OpenMP. At first use the
source is compiled by ``g++`` with the reference's flags into a shared
library under ``fgnn_tpu_torch/_build/`` (listed in ``.gitignore``), named
by a hash of the source, the compiler, the flags and the host
(``-march=native`` code runs only on the CPU it was built for), and loaded
with ``ctypes``. The build writes a temporary file and
renames it into place, so processes that build at once never load a half
written library.

There is no fallback: a failed build raises with the compiler's output.
Nothing here runs at import time.

The samplers keep the source's limit of :data:`MAX_FANOUT` picks a row; the
engine samples wider hops with its NumPy hop functions, as the reference
does.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from typing import Dict, Tuple

import numpy as np

from .cuda_lib import BUILD_DIR, CSRC_DIR

SOURCE = os.path.join(CSRC_DIR, "fgnn_host.cpp")
# the reference Makefile's compiler; ``$CXX`` is not read: a machine may
# point it at a compiler without OpenMP
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-fPIC", "-shared",
             "-std=c++17")
# the C++ samplers keep a row's picks in a 256-slot array
MAX_FANOUT = 256

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def library_path(cxx: str) -> str:
    key = " ".join((cxx,) + CXX_FLAGS + (platform.node(), platform.machine()))
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + key.encode())
    return os.path.join(BUILD_DIR, f"fgnn_host-{digest.hexdigest()[:16]}.so")


def build(cxx: str = CXX) -> str:
    """Compile the library with ``cxx`` unless it is built; returns its
    path. Raises ``RuntimeError`` with the compiler's output when the build
    fails."""
    so = library_path(cxx)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, SOURCE]
    try:
        try:
            r = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot run the host compiler: {' '.join(cmd)}"
                               f": {e}") from e
        if r.returncode != 0:
            raise RuntimeError(f"host compiler failed (rc {r.returncode}): "
                               f"{' '.join(cmd)}\n{r.stdout}{r.stderr}")
        os.replace(tmp, so)   # atomic: a concurrent loader sees all or none
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


def load(cxx: str = CXX) -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    with _lock:
        if cxx not in _libs:
            lib = ctypes.CDLL(build(cxx))
            i64, u64, i32 = ctypes.c_int64, ctypes.c_uint64, ctypes.c_int32
            p = ctypes.c_void_p
            lib.fgnn_sample_khop.argtypes = [p, p, p, i64, i64, u64, i32, p]
            lib.fgnn_sample_khop.restype = None
            lib.fgnn_sample_weighted_khop.argtypes = [p, p, p, p, i64, i64,
                                                      u64, i32, p]
            lib.fgnn_sample_weighted_khop.restype = None
            lib.fgnn_sample_random_walk.argtypes = [
                p, p, p, i64, i64, i64, ctypes.c_float, i64, u64, p, p]
            lib.fgnn_sample_random_walk.restype = None
            lib.fgnn_dedup_remap.argtypes = [p, i64, p, i64, i64, p, p]
            lib.fgnn_dedup_remap.restype = i64
            _libs[cxx] = lib
        return _libs[cxx]


def _arr(a, dtype) -> np.ndarray:
    """A C-contiguous array of ``dtype`` (no copy where ``a`` is one)."""
    return np.ascontiguousarray(a, dtype=dtype)


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _check_fanout(fanout: int) -> None:
    if fanout > MAX_FANOUT:
        raise ValueError(f"the host samplers take at most {MAX_FANOUT} picks "
                         f"a row, got {fanout}")


def sample_khop(indptr, indices, inputs, fanout: int, seed: int,
                replace: bool = False) -> np.ndarray:
    """Uniform khop picks, ``[len(inputs), fanout]`` int32 neighbour ids,
    -1 padded: Floyd's algorithm without replacement (every neighbour when
    ``deg <= fanout``), or ``fanout`` draws with it."""
    _check_fanout(fanout)
    indptr, indices = _arr(indptr, np.int64), _arr(indices, np.int32)
    inputs = _arr(inputs, np.int32)
    out = np.empty((len(inputs), fanout), dtype=np.int32)
    load().fgnn_sample_khop(_ptr(indptr), _ptr(indices), _ptr(inputs),
                            len(inputs), fanout, seed & (2**64 - 1),
                            int(replace), _ptr(out))
    return out


def sample_weighted_khop(indptr, indices, gcum, inputs, fanout: int,
                         seed: int, dedup: bool = False) -> np.ndarray:
    """Weighted khop picks by inverse CDF on the global float64 edge-weight
    cumsum ``gcum``; ``dedup`` makes a row's picks distinct (every
    neighbour when ``deg <= fanout``). ``[len(inputs), fanout]`` int32, -1
    padded."""
    _check_fanout(fanout)
    indptr, indices = _arr(indptr, np.int64), _arr(indices, np.int32)
    gcum, inputs = _arr(gcum, np.float64), _arr(inputs, np.int32)
    out = np.empty((len(inputs), fanout), dtype=np.int32)
    load().fgnn_sample_weighted_khop(_ptr(indptr), _ptr(indices), _ptr(gcum),
                                     _ptr(inputs), len(inputs), fanout,
                                     seed & (2**64 - 1), int(dedup), _ptr(out))
    return out


def sample_random_walk(indptr, indices, inputs, num_walk: int, walk_len: int,
                       restart: float, topk: int, seed: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """PinSAGE picks: ``num_walk`` walks of ``walk_len`` steps from each
    input, the ``topk`` most visited as neighbours. Returns (``[n, topk]``
    int32 ids, -1 padded; ``[n, topk]`` float32 visit counts)."""
    indptr, indices = _arr(indptr, np.int64), _arr(indices, np.int32)
    inputs = _arr(inputs, np.int32)
    nbr = np.empty((len(inputs), topk), dtype=np.int32)
    w = np.empty((len(inputs), topk), dtype=np.float32)
    load().fgnn_sample_random_walk(_ptr(indptr), _ptr(indices), _ptr(inputs),
                                   len(inputs), num_walk, walk_len, restart,
                                   topk, seed & (2**64 - 1), _ptr(nbr),
                                   _ptr(w))
    return nbr, w


def dedup_remap(cur, nbr_flat, cap: int) -> Tuple[np.ndarray, int, np.ndarray]:
    """Dedup and remap of one hop: the frontier ``cur`` keeps its slots, the
    new ids of ``nbr_flat`` follow in ascending order up to ``cap``, and
    every pick maps to its local (-1 for padding and clipped ids). Returns
    ``(unique [cap] int32, n_new, src_local [len(nbr_flat)] int32)``."""
    cur, nbr_flat = _arr(cur, np.int32), _arr(nbr_flat, np.int32)
    unique = np.empty(cap, dtype=np.int32)
    src_local = np.empty(len(nbr_flat), dtype=np.int32)
    n_new = load().fgnn_dedup_remap(_ptr(cur), len(cur), _ptr(nbr_flat),
                                    len(nbr_flat), cap, _ptr(unique),
                                    _ptr(src_local))
    return unique, int(n_new), src_local
