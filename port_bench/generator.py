"""The one traffic generator: reads a mix's parameters
(``traffic/<mix>.json``) and makes the cell's dataset from ``--seed``.

A mix names its ``kind``; the kind's dataset is ``Dataset`` in
``port_bench/kinds/<kind>.py``, found by that name, so a later mix of a
new kind adds a file and edits none. The helpers every kind shares (the
seed's streams, orbit and look-at camera tensors) live here.
"""

from __future__ import annotations

import importlib
import math

import numpy as np

VIRTUAL_LENGTH = 1 << 20


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for stream ``stream`` of run seed ``seed``."""
    a, b = np.random.SeedSequence([int(seed), stream]).generate_state(2)
    return (int(a) << 31 ^ int(b)) & ((1 << 63) - 1)


def camera_tensors(azimuth, elevation, distance, fov_deg, znear, zfar):
    """Orbit cameras looking at the origin -> the renderer's (transposed)
    ``world_view_transform``, ``full_proj_transform``, ``view_to_world``
    [n, 4, 4] and ``camera_center`` [n, 3], float32 (the conventions of
    the ShapeNet reader's camera tensors)."""
    ca, sa = np.cos(azimuth), np.sin(azimuth)
    ce, se = np.cos(elevation), np.sin(elevation)
    pos = np.stack([distance * ce * sa, distance * se, distance * ce * ca], 1)
    fwd = -pos / np.linalg.norm(pos, axis=1, keepdims=True)
    right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right /= np.linalg.norm(right, axis=1, keepdims=True)
    up = np.cross(right, fwd)
    c2w_rot = np.stack([right, -up, fwd], axis=2)          # columns
    n = len(azimuth)
    w2c = np.zeros((n, 4, 4))
    w2c[:, :3, :3] = c2w_rot.transpose(0, 2, 1)
    w2c[:, :3, 3] = -np.einsum("nji,nj->ni", c2w_rot, pos)
    w2c[:, 3, 3] = 1.0
    tan = math.tan(math.radians(fov_deg) / 2)
    proj = np.zeros((4, 4))
    proj[0, 0] = proj[1, 1] = 1.0 / tan
    proj[3, 2] = 1.0
    proj[2, 2] = zfar / (zfar - znear)
    proj[2, 3] = -(zfar * znear) / (zfar - znear)
    world_view = w2c.transpose(0, 2, 1)
    full_proj = world_view @ proj.T
    view_to_world = np.linalg.inv(world_view)
    return {"world_view_transforms": world_view.astype(np.float32),
            "full_proj_transforms": full_proj.astype(np.float32),
            "view_to_world_transforms": view_to_world.astype(np.float32),
            "camera_centers": view_to_world[:, 3, :3].astype(np.float32)}



def make_dataset(mix: dict, spec: dict, seed: int, device):
    """The dataset of ``mix``'s kind over the configuration ``spec``."""
    kind = mix["kind"]
    try:
        module = importlib.import_module(f"port_bench.kinds.{kind}")
    except ModuleNotFoundError as e:
        raise ValueError(f"traffic kind {kind!r}: no port_bench/kinds/"
                         f"{kind}.py") from e
    return module.Dataset(mix, spec, seed, device)
