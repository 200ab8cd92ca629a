"""Camera math for Gaussian-splat supervision.

Port of unipre3d_tpu/utils/camera.py. Conventions are kept exactly:

* ``world_view_transform`` and ``full_proj_transform`` are stored
  *transposed*, i.e. they are applied to **row** vectors:
  ``p_clip = [x y z 1] @ full_proj_transform``.
* The projection matrix maps camera-space z in ``[znear, zfar]`` to
  NDC z in ``[0, 1]``.
* NDC xy in ``[-1, 1]`` map to pixels via ``((v + 1) * S - 1) / 2``.

Matrix construction is host-side numpy (data pipeline); the per-Gaussian
functions take torch tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def get_world2view(R: np.ndarray, t: np.ndarray,
                   translate=(0.0, 0.0, 0.0), scale: float = 1.0) -> np.ndarray:
    """World-to-view 4x4 (not transposed); R is the c2w rotation, t the w2c
    translation."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = np.asarray(R).T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    c2w = np.linalg.inv(Rt)
    cam_center = (c2w[:3, 3] + np.asarray(translate)) * scale
    c2w[:3, 3] = cam_center
    return np.linalg.inv(c2w).astype(np.float32)


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def get_projection_matrix(znear: float, zfar: float,
                          fovx: float, fovy: float) -> np.ndarray:
    """Perspective projection, z in [0, 1] after divide, in the
    *untransposed* math convention (column vectors)."""
    tan_half_fovy = math.tan(fovy / 2)
    tan_half_fovx = math.tan(fovx / 2)
    top = tan_half_fovy * znear
    right = tan_half_fovx * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def build_camera_tensors(R: np.ndarray, t: np.ndarray, fovx: float, fovy: float,
                         znear: float, zfar: float,
                         translate=(0.0, 0.0, 0.0), scale: float = 1.0):
    """The (transposed) camera matrices the renderer consumes:
    ``world_view_transform`` [4,4], ``full_proj_transform`` [4,4],
    ``camera_center`` [3] and ``view_to_world`` [4,4] (transposed c2w)."""
    world_view = get_world2view(R, t, translate, scale).T
    proj = get_projection_matrix(znear, zfar, fovx, fovy).T
    full_proj = world_view @ proj
    cam_center = np.linalg.inv(world_view.astype(np.float64))[3, :3].astype(np.float32)
    view_to_world = np.linalg.inv(world_view.astype(np.float64)).astype(np.float32)
    return {
        "world_view_transform": world_view.astype(np.float32),
        "full_proj_transform": full_proj.astype(np.float32),
        "camera_center": cam_center,
        "view_to_world": view_to_world,
    }


def intrinsics_from_fov(fov_deg: float, resolution: int) -> np.ndarray:
    """Pinhole intrinsic 3x4 used by object-level feature fusion."""
    K = np.zeros((3, 4), dtype=np.float32)
    focal = (resolution / 2.0) / math.tan(math.radians(fov_deg / 2.0))
    K[0, 0] = focal
    K[1, 1] = focal
    K[0, 2] = resolution / 2.0
    K[1, 2] = resolution / 2.0
    K[2, 2] = 1.0
    return K


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) [..., 4] -> rotation matrix [..., 3, 3]."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - r * z),
                        2.0 * (x * z + r * y)], dim=-1)
    row1 = torch.stack([2.0 * (x * y + r * z), 1.0 - 2.0 * (x * x + z * z),
                        2.0 * (y * z - r * x)], dim=-1)
    row2 = torch.stack([2.0 * (x * z - r * y), 2.0 * (y * z + r * x),
                        1.0 - 2.0 * (x * x + y * y)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def ndc2pix(v: torch.Tensor, size: int) -> torch.Tensor:
    """NDC [-1, 1] -> pixel coordinate: ((v + 1) * S - 1) * 0.5."""
    return ((v + 1.0) * size - 1.0) * 0.5
