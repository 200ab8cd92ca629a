"""Shared camera-info readers.

The port's own copy of unipre3d_tpu/data/dataset_readers.py.
``CameraInfo`` carries one view's rotation/translation/image paths;
``read_cameras_from_txt`` parses 4x4 camera-to-world pose files (txt or
json) into CameraInfos, optionally recentring poses by a cloud centroid
(the ScanNet path, reference :73-75). The rotation is stored as the c2w
rotation (the reference stores it "transposed for CUDA glm" relative to
the w2c matrix — same quantity).
"""

from __future__ import annotations

import json
import math
from typing import List, NamedTuple, Optional, Sequence

import numpy as np


class CameraInfo(NamedTuple):
    uid: int
    R: np.ndarray            # c2w rotation [3, 3]
    T: np.ndarray            # w2c translation [3]
    FovX: float              # radians
    FovY: float
    image_path: str
    depth_path: Optional[str] = None
    w2c: Optional[np.ndarray] = None


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: int) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def _load_pose(path: str) -> np.ndarray:
    if path.endswith(".json"):
        with open(path) as f:
            data = json.load(f)
        mat = data.get("camera_to_world", data.get("transform_matrix",
                                                   data))
        return np.asarray(mat, dtype=np.float64).reshape(4, 4)
    return np.loadtxt(path).reshape(4, 4)


def read_cameras_from_txt(image_paths: Sequence[str],
                          pose_paths: Sequence[str],
                          fov_deg: float,
                          aspect: float = 1.0,
                          moving_centers: Optional[np.ndarray] = None,
                          depth_paths: Optional[Sequence[str]] = None
                          ) -> List[CameraInfo]:
    """Parse per-view c2w pose files -> CameraInfos (reference
    readCamerasFromTxt). ``fov_deg`` is FovX; FovY follows from the
    aspect ratio (reference :97). Non-finite poses are skipped (the
    ScanNet trees contain them)."""
    fovx = math.radians(fov_deg)
    fovy = 2 * math.atan(math.tan(fovx / 2) * aspect)
    out: List[CameraInfo] = []
    for uid, (img_p, pose_p) in enumerate(zip(image_paths, pose_paths)):
        c2w = _load_pose(pose_p)
        if not np.isfinite(c2w).all():
            continue
        if moving_centers is not None:
            c2w = c2w.copy()
            c2w[:3, 3] -= np.asarray(moving_centers)
        w2c = np.linalg.inv(c2w)
        out.append(CameraInfo(
            uid=uid,
            R=np.transpose(w2c[:3, :3]).astype(np.float32),
            T=w2c[:3, 3].astype(np.float32),
            FovX=fovx, FovY=fovy,
            image_path=img_p,
            depth_path=depth_paths[uid] if depth_paths else None,
            w2c=w2c.astype(np.float32)))
    return out
