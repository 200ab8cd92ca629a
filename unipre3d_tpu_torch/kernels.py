"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source has a plain C interface; it is compiled with ``nvcc`` for
``sm_90a`` into a shared library at first use and loaded with ``ctypes``.
The library lands in ``unipre3d_tpu_torch/_build/`` (listed in
``.gitignore``) under a name that hashes the source, every header of
``csrc/`` (``*.cuh``) and the flags, so an edited source or header is
rebuilt and an unchanged one is reused. Beside it lies
nvcc's output (``.log``: ptxas' register, shared-memory and spill report).
Nothing is built at import time: the CPU tests import every module of the
package.

Beside the build: ``CudaKernel`` (one C entry point with its launch count)
and the two checks every kernel wrapper makes, ``use_kernel`` (a CUDA
tensor launches the kernel, a CPU tensor takes the plain version, any
other device raises) and ``check_tensor``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict = {}
ALL: list = []        # every CudaKernel made


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (CUDA_HOME or /usr/local/cuda)")
    return found


def nvcc_command(src, out) -> list:
    """nvcc's command line that builds the source ``src`` into the shared
    library ``out`` (headers are found in ``csrc/``, also for a copy of a
    source kept elsewhere)."""
    return [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(out),
            str(src)]


def library_path(name: str) -> Path:
    h = hashlib.sha1((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:12]}.so"


def _build(name: str) -> Path:
    """Compile one source unless it is built; returns the library path."""
    so = library_path(name)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: a concurrent process never
    # loads a half-written library
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(nvcc_command(CSRC_DIR / f"{name}.cu", tmp),
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {so.name}:\n{proc.stdout}")
    so.with_suffix(".log").write_text(proc.stdout)
    os.replace(tmp, so)
    return so


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        lib = _libs[name] = ctypes.CDLL(str(_build(name)))
    return lib


def build_log(name: str) -> str:
    """nvcc's output from the build of one source (written with it)."""
    return library_path(name).with_suffix(".log").read_text()


class CudaKernel:
    """One C entry point of a kernel library, with its launch count (a
    plain int, incremented at each launch; a CUDA graph's capture, which
    records launches and makes none, takes its own back off, and each
    replay adds them: models/backbone_graph.py). Every instance is in
    ``ALL``. Arguments:
    ``n_ptr`` pointers, then ``n_int`` ints, then the stream (appended
    here); the entry point returns ``cudaGetLastError()`` after its launch
    and a non-zero code raises."""

    def __init__(self, lib: str, fn: str, n_ptr: int, n_int: int):
        self.lib_name, self.fn_name = lib, fn
        self.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                         + [ctypes.c_void_p])
        self.launches = 0
        self._fn = None
        ALL.append(self)

    def __call__(self, *args):
        import torch
        if self._fn is None:
            fn = getattr(load(self.lib_name), self.fn_name)
            fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
            self._fn = fn
        stream = torch.cuda.current_stream().cuda_stream
        err = self._fn(*args, ctypes.c_void_p(stream))
        self.launches += 1
        if err != 0:
            raise RuntimeError(f"{self.fn_name} launch failed: CUDA error "
                               f"{err}")


def use_kernel(what: str, *tensors) -> bool:
    """True: launch the CUDA kernel; False: take the plain version. Only
    CPU tensors take the plain version; any other device raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"the {what} runs on cuda or cpu, not {dev}")
    return True


def check_tensor(name, t, shape, dtype=None) -> None:
    """Raise unless ``t`` is contiguous, of ``dtype`` (float32 by default)
    and of ``shape``."""
    import torch
    dtype = torch.float32 if dtype is None else dtype
    if t.dtype != dtype or not t.is_contiguous() or \
            tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: need a contiguous {dtype} tensor of shape "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)} "
                         f"contiguous={t.is_contiguous()}")
