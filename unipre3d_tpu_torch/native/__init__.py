"""Host (CPU) point-cloud ops of the input pipeline, in C++.

The port's own copy of unipre3d_tpu/native/: farthest point sampling,
which caps a ScanNet cloud at ``data.max_points`` for PTv3
(data/transforms.py:FPS), the first-point-per-voxel grid dedup
(``host_grid_subsample``) and brute-force kNN (``host_knn``).
``host_ops.cpp`` is compiled with ``g++`` at
first use into ``unipre3d_tpu_torch/_build/`` (listed in ``.gitignore``)
under a name that hashes the source and the flags, and loaded with
``ctypes``. If it cannot be built, each function raises: the plain numpy
versions (``host_fps_ref``, ``host_grid_subsample_ref``, ``host_knn_ref``,
the references the tests hold the C++ to, bit for bit) are not fallbacks;
the FPS one takes tens of seconds for each 80,000-point cap.

FPS seeds at index 0 and breaks ties by the lowest index. The C++ runs on
one thread, its loops vectorized (host_ops.cpp says why); ctypes releases
the GIL for the call, so the loader's reader threads cap several clouds at
once. (The JAX package's OpenMP version breaks ties between threads in
the order the threads arrive; its numpy fallback by the lowest index.)
kNN orders by squared distance, ties to the lowest index (JAX's C++ does
too; its numpy fallback, ``argpartition``, breaks ties arbitrarily). In
the JAX package only its tests call the grid dedup and kNN; the port's
tests hold them to these references and to JAX's on inputs without ties.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from unipre3d_tpu_torch.kernels import BUILD_DIR

SRC = Path(__file__).resolve().with_name("host_ops.cpp")
# no fused multiply-add (the reference's rounding); finite, unsigned-zero
# maxima let the compiler vectorize the max reduction without reordering
# any sum
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off",
             "-ffinite-math-only", "-fno-signed-zeros", "-fno-trapping-math")

_F32 = ctypes.POINTER(ctypes.c_float)
_I32 = ctypes.POINTER(ctypes.c_int32)
_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    h = hashlib.sha1(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"host_ops_{h.hexdigest()[:12]}.so"


def _build() -> Path:
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise RuntimeError(f"the host-ops library needs g++ to build "
                           f"{SRC.name}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SRC.name}:\n{proc.stdout}")
    os.replace(tmp, so)
    return so


def load() -> ctypes.CDLL:
    """The host-ops library, built first if needed (raises if it cannot
    be)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            lib.fps.argtypes = [_F32, ctypes.c_int, ctypes.c_int, _I32]
            lib.fps.restype = None
            lib.grid_subsample.argtypes = [
                _F32, ctypes.c_int, ctypes.c_float, _F32, _I32, _I32]
            lib.grid_subsample.restype = ctypes.c_int
            lib.knn.argtypes = [_F32, ctypes.c_int, _F32, ctypes.c_int,
                                ctypes.c_int, _I32, _F32]
            lib.knn.restype = None
            _lib = lib
        return _lib


def _points(xyz: np.ndarray, m: int):
    xyz = np.ascontiguousarray(np.asarray(xyz)[:, :3], dtype=np.float32)
    return xyz, min(int(m), len(xyz))


def host_fps(xyz: np.ndarray, m: int) -> np.ndarray:
    """FPS indices [min(m, n)] int32 of xyz [n, 3+] (float32; seed index 0,
    ties to the lowest index), in C++."""
    xyz, m = _points(xyz, m)
    out = np.empty(m, dtype=np.int32)
    if m > 0:
        load().fps(xyz.ctypes.data_as(_F32), len(xyz), m,
                   out.ctypes.data_as(_I32))
    return out


def host_fps_ref(xyz: np.ndarray, m: int) -> np.ndarray:
    """The plain numpy version of :func:`host_fps` (O(n m)): the same
    float32 arithmetic, ``argmax``'s first index on a tie."""
    xyz, m = _points(xyz, m)
    out = np.zeros(m, dtype=np.int32)
    min_d2 = np.full(len(xyz), np.inf, dtype=np.float32)
    cur = 0
    for i in range(1, m):
        d = xyz - xyz[cur]
        d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
        np.minimum(min_d2, d2, out=min_d2)
        cur = int(np.argmax(min_d2))
        out[i] = cur
    return out


def _grid_inputs(xyz, grid_size, min_coord):
    xyz = np.ascontiguousarray(np.asarray(xyz)[:, :3], dtype=np.float32)
    if min_coord is None:
        min_coord = xyz.min(axis=0)
    return (xyz, np.float32(grid_size),
            np.ascontiguousarray(min_coord, dtype=np.float32))


def host_grid_subsample(xyz: np.ndarray, grid_size: float,
                        min_coord: np.ndarray = None):
    """The first row of each occupied voxel of xyz [n, 3+] (voxel
    ``floor((x - min_coord) / grid_size)`` in float32; ``min_coord``
    defaults to the cloud's minimum), in input order -> (kept indices [k]
    int32, voxel coordinates [k, 3] int32), in C++."""
    xyz, g, lo = _grid_inputs(xyz, grid_size, min_coord)
    n = len(xyz)
    idx = np.empty(n, dtype=np.int32)
    grid = np.empty((n, 3), dtype=np.int32)
    k = load().grid_subsample(xyz.ctypes.data_as(_F32), n, float(g),
                              lo.ctypes.data_as(_F32),
                              idx.ctypes.data_as(_I32),
                              grid.ctypes.data_as(_I32)) if n else 0
    return idx[:k].copy(), grid[:k].copy()


def host_grid_subsample_ref(xyz: np.ndarray, grid_size: float,
                            min_coord: np.ndarray = None):
    """The plain numpy version of :func:`host_grid_subsample`: the same
    float32 voxels, keyed by their coordinates' low 21 bits."""
    xyz, g, lo = _grid_inputs(xyz, grid_size, min_coord)
    grid = np.floor((xyz - lo) / g).astype(np.int64)
    m = np.int64(0x1FFFFF)
    key = ((grid[:, 0] & m) << 42) | ((grid[:, 1] & m) << 21) | (grid[:, 2] & m)
    _, keep = np.unique(key, return_index=True)
    keep.sort()
    return keep.astype(np.int32), grid[keep].astype(np.int32)


def _knn_inputs(query, support, k):
    query = np.ascontiguousarray(np.asarray(query)[:, :3], dtype=np.float32)
    support = np.ascontiguousarray(np.asarray(support)[:, :3],
                                   dtype=np.float32)
    return query, support, min(int(k), len(support))


def host_knn(query: np.ndarray, support: np.ndarray, k: int):
    """The k nearest support points of each query (xyz of [n, 3+] each)
    -> (indices [nq, k] int32, squared distances [nq, k] float32),
    ascending, ties to the lowest index, in C++."""
    query, support, k = _knn_inputs(query, support, k)
    nq = len(query)
    idx = np.empty((nq, k), dtype=np.int32)
    d2 = np.empty((nq, k), dtype=np.float32)
    if nq and k > 0:
        load().knn(query.ctypes.data_as(_F32), nq,
                   support.ctypes.data_as(_F32), len(support), k,
                   idx.ctypes.data_as(_I32), d2.ctypes.data_as(_F32))
    return idx, d2


def host_knn_ref(query: np.ndarray, support: np.ndarray, k: int):
    """The plain numpy version of :func:`host_knn`: the same float32
    squared distances, a stable sort of each row."""
    query, support, k = _knn_inputs(query, support, k)
    d = support[None, :, :] - query[:, None, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return idx.astype(np.int32), np.take_along_axis(d2, idx, axis=1)
