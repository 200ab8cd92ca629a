"""Host (CPU) point-cloud ops of the input pipeline, in C++.

The port's own copy of what it needs of unipre3d_tpu/native/: farthest
point sampling, which caps a ScanNet cloud at ``data.max_points`` for PTv3
(data/transforms.py:FPS). ``host_ops.cpp`` is compiled with ``g++`` at
first use into ``unipre3d_tpu_torch/_build/`` (listed in ``.gitignore``)
under a name that hashes the source and the flags, and loaded with
``ctypes``. If it cannot be built, ``host_fps`` raises: the plain numpy
version (``host_fps_ref``, the reference the tests hold the C++ to, bit for
bit) takes tens of seconds for each 80,000-point cap and is not a fallback.

Both seed at index 0 and break ties by the lowest index. The C++ runs on
one thread, its loops vectorized (host_ops.cpp says why); ctypes releases
the GIL for the call, so the loader's reader threads cap several clouds at
once. (The JAX package's OpenMP version breaks ties between threads in
the order the threads arrive; its numpy fallback by the lowest index.)

Not ported: the JAX package's ``host_grid_subsample`` and ``host_knn``,
which only its fine-tuning transforms call (ROADMAP queue A, item 16).
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
        raise RuntimeError(f"the host FPS needs g++ to build {SRC.name}: "
                           f"{e}") from e
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
            lib.fps.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                                ctypes.c_int, ctypes.POINTER(ctypes.c_int32)]
            lib.fps.restype = None
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
        load().fps(xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                   len(xyz), m,
                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
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
