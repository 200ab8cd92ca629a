"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source has a plain C interface; it is compiled with ``nvcc`` for
``sm_90a`` into a shared library at first use and loaded with ``ctypes``.
The library lands in ``unipre3d_tpu_torch/_build/`` (listed in
``.gitignore``) under a name that hashes the source and the flags, so an
edited source is rebuilt and an unchanged one is reused. Beside it lies
nvcc's output (``.log``: ptxas' register, shared-memory and spill report).
Nothing is built at import time: the CPU tests import every module of the
package.
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


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (CUDA_HOME or /usr/local/cuda)")
    return found


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}_{tag}.so"


def _build(name: str) -> Path:
    """Compile one source unless it is built; returns the library path."""
    so = library_path(name)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: a concurrent process never
    # loads a half-written library
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(CSRC_DIR / f"{name}.cu")],
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
