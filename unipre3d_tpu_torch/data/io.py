"""Point-cloud file loaders (.npy / .txt / .h5 / .pth / .ply).

The port's own copy of unipre3d_tpu/data/io.py: one entry point that loads
a point array from any of the common formats, returning [N, C] float32
(``h5py`` is imported only for .h5 files).
"""

from __future__ import annotations

import os

import numpy as np


def load_points(path: str, keys=("data", "points", "pos")) -> np.ndarray:
    """Load a point array from .npy/.txt/.h5/.hdf5/.pth/.ply."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        data = np.load(path)
    elif ext in (".txt", ".xyz", ".pts"):
        try:
            data = np.loadtxt(path, delimiter=",")
        except ValueError:
            data = np.loadtxt(path)
    elif ext in (".h5", ".hdf5"):
        import h5py
        with h5py.File(path, "r") as f:
            key = next((k for k in keys if k in f), None)
            if key is None:
                key = list(f.keys())[0]
            data = f[key][:]
    elif ext == ".pth":
        import torch
        obj = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(obj, dict):
            key = next((k for k in keys if k in obj), None)
            obj = obj[key] if key else next(iter(obj.values()))
        data = obj.numpy() if hasattr(obj, "numpy") else np.asarray(obj)
    elif ext == ".ply":
        data = _load_ply(path)
    else:
        raise ValueError(f"unsupported point file: {path}")
    data = np.asarray(data, dtype=np.float32)
    if data.ndim == 3 and data.shape[0] == 1:
        data = data[0]
    return data


def _load_ply(path: str) -> np.ndarray:
    """Minimal ASCII/binary-little-endian PLY vertex reader (x, y, z and
    any following float properties)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        n_vert = int(next(l.split()[-1] for l in header
                          if l.startswith("element vertex")))
        props = [l.split() for l in header if l.startswith("property")
                 and "list" not in l]
        dtypes = {"float": "f4", "float32": "f4", "double": "f8",
                  "uchar": "u1", "uint8": "u1", "int": "i4",
                  "int32": "i4", "short": "i2", "ushort": "u2"}
        np_dtype = np.dtype([(p[2], dtypes.get(p[1], "f4")) for p in props])
        if fmt == "ascii":
            rows = np.loadtxt(f, max_rows=n_vert)
            return np.asarray(rows, dtype=np.float32).reshape(n_vert, -1)
        arr = np.frombuffer(f.read(np_dtype.itemsize * n_vert),
                            dtype=np_dtype, count=n_vert)
        return np.stack([arr[name].astype(np.float32)
                         for name in np_dtype.names], axis=1)


def save_ply(path: str, points: np.ndarray) -> None:
    """Write an ASCII PLY of xyz(+rgb when 6 columns)."""
    n, c = points.shape
    names = ["x", "y", "z", "red", "green", "blue"][:c]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        for nm in names:
            f.write(f"property float {nm}\n")
        f.write("end_header\n")
        np.savetxt(f, points, fmt="%.6f")
