"""Synthetic scene-level dataset (ScanNet schema) with learnable GT.

Port of unipre3d_tpu/data/synthetic_scene.py: a procedural coloured room
(floor + two walls + three boxes), voxel-deduplicated at ``grid_size``
like the reference GridSample transform, padded to the ``max_points``
capacity; per-pixel unprojection maps from z-buffering the scene points
into each conditioning view (a stand-in for sensor-depth unprojection).
Every random draw comes from one numpy generator in the JAX version's
order, so point clouds, cameras and unprojections equal the JAX dataset's.

The ground-truth views differ: the JAX dataset renders them with its XLA
tiled renderer (capacity min(512, N)); the port renders them with its own
binned splat, forward only, all views of a scene in one launch, on
``device`` (the card by default).

Splits as the JAX version's: ``train``, ``val`` and ``test`` draw from the
dataset seed + 0, + 10,000 and + 20,000, and every example holds every view
in order. The JAX version gives every split a virtual length of 16 (its 4
scenes repeated); here only ``train`` does, and ``val``/``test`` hold each
scene once, which leaves every mean over the split as it is.

Example schema (padded to a fixed point capacity M):
``point_cloud`` {``coord`` [M,3], ``grid_coord`` [M,3] int32, ``feat``
[M,6] (normal || colour*2-1), ``mask`` [M], ``min_coord`` [3]},
``gt_images`` [V,3,H,W] (the first ``input_images`` are conditioning),
the camera tensors per view, ``unprojected_coords`` [input_images,H,W,4]
(xyz + validity).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from unipre3d_tpu_torch import resolve_device
from unipre3d_tpu_torch.ops.rasterizer.preprocess import preprocess_gaussians
from unipre3d_tpu_torch.ops.rasterizer.render import binned_tile
from unipre3d_tpu_torch.ops.rasterizer.splat_binned import \
    rasterize_projected_binned
from unipre3d_tpu_torch.utils import camera as cam_util
from unipre3d_tpu_torch.utils.sh import rgb2sh

GRID_SIZE = 0.02
GT_MAX_PER_TILE = 4096


def _room_points(rng: np.random.Generator, n: int, half: float = 0.6):
    """Floor + two walls + coloured boxes; returns (coord, color, normal)."""
    n_floor = n // 3
    n_wall = n // 4
    n_box = n - n_floor - 2 * n_wall
    pts, nrm, col = [], [], []
    xy = rng.uniform(-half, half, (n_floor, 2))
    pts.append(np.stack([xy[:, 0], np.full(n_floor, -half), xy[:, 1]], 1))
    nrm.append(np.tile([0, 1, 0], (n_floor, 1)))
    col.append(np.tile(rng.uniform(0.3, 0.9, 3), (n_floor, 1)))
    xy = rng.uniform(-half, half, (n_wall, 2))
    pts.append(np.stack([xy[:, 0], xy[:, 1], np.full(n_wall, -half)], 1))
    nrm.append(np.tile([0, 0, 1], (n_wall, 1)))
    col.append(np.tile(rng.uniform(0.3, 0.9, 3), (n_wall, 1)))
    xy = rng.uniform(-half, half, (n_wall, 2))
    pts.append(np.stack([np.full(n_wall, -half), xy[:, 0], xy[:, 1]], 1))
    nrm.append(np.tile([1, 0, 0], (n_wall, 1)))
    col.append(np.tile(rng.uniform(0.3, 0.9, 3), (n_wall, 1)))
    for _ in range(3):
        c = rng.uniform(-half * 0.6, half * 0.6, 2)
        s = rng.uniform(0.05, 0.15)
        k = n_box // 3
        face = rng.integers(0, 5, k)  # no bottom face
        uv = rng.uniform(-s, s, (k, 2))
        p = np.zeros((k, 3))
        nv = np.zeros((k, 3))
        for i in range(k):
            if face[i] == 0:  # top
                p[i] = [c[0] + uv[i, 0], -half + 2 * s, c[1] + uv[i, 1]]
                nv[i] = [0, 1, 0]
            else:
                ax = (face[i] - 1) % 2
                sgn = 1 if face[i] < 3 else -1
                if ax == 0:
                    p[i] = [c[0] + sgn * s, -half + s + uv[i, 0],
                            c[1] + uv[i, 1]]
                    nv[i] = [sgn, 0, 0]
                else:
                    p[i] = [c[0] + uv[i, 0], -half + s + uv[i, 1],
                            c[1] + sgn * s]
                    nv[i] = [0, 0, sgn]
        pts.append(p)
        nrm.append(nv)
        col.append(np.tile(rng.uniform(0.2, 1.0, 3), (k, 1)))
    return (np.concatenate(pts).astype(np.float32),
            np.concatenate(col).astype(np.float32),
            np.concatenate(nrm).astype(np.float32))


def grid_sample_dedup(coord, grid_size=GRID_SIZE):
    """Keep the first point per occupied voxel (GridSample, train mode).
    Returns (kept indices, grid_coord, min_coord)."""
    min_coord = coord.min(axis=0)
    grid = np.floor((coord - min_coord) / grid_size).astype(np.int32)
    key = (grid[:, 0].astype(np.int64) << 40) | \
          (grid[:, 1].astype(np.int64) << 20) | grid[:, 2].astype(np.int64)
    _, keep = np.unique(key, return_index=True)
    keep.sort()
    return keep, grid[keep], min_coord


def _look_at(pos: np.ndarray, target: np.ndarray):
    """c2w rotation + w2c translation of a camera at pos looking at target
    (projection looks down +z)."""
    fwd = target - pos
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    if np.linalg.norm(right) < 1e-6:
        right = np.array([1.0, 0.0, 0.0])
    right = right / np.linalg.norm(right)
    up2 = np.cross(right, fwd)
    R = np.stack([right, -up2, fwd], axis=1)
    t = -R.T @ pos
    return R.astype(np.float32), t.astype(np.float32)


def unproject_zbuffer(coord: np.ndarray, world_view: np.ndarray,
                      full_proj: np.ndarray, H: int, W: int) -> np.ndarray:
    """Per-pixel world coordinate of the nearest scene point -> [H, W, 4]
    (xyz, valid)."""
    n = coord.shape[0]
    hom = np.concatenate([coord, np.ones((n, 1), np.float32)], axis=1)
    p_view = hom @ world_view
    p_clip = hom @ full_proj
    ndc = p_clip[:, :3] / (p_clip[:, 3:4] + 1e-8)
    px = ((ndc[:, 0] + 1) * W - 1) / 2
    py = ((ndc[:, 1] + 1) * H - 1) / 2
    z = p_view[:, 2]
    xi = np.round(px).astype(np.int64)
    yi = np.round(py).astype(np.int64)
    ok = (z > 0.05) & (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    out = np.zeros((H, W, 4), np.float32)
    idx = np.where(ok)[0]
    order = idx[np.argsort(-z[idx])]  # far to near; near written last
    out[yi[order], xi[order], :3] = coord[order]
    out[yi[order], xi[order], 3] = 1.0
    return out


class SyntheticSceneDataset:
    """Scene-level synthetic training set (ScanNet schema)."""

    def __init__(self, cfg, split: str = "train", num_scenes: int = 4,
                 num_points: int = 4096, capacity: int = None, seed: int = 0,
                 device=None):
        self.cfg = cfg
        self.split = split
        H = int(cfg.data.training_height)
        W = int(cfg.data.training_width)
        self.input_images = int(cfg.data.input_images)
        n_views = 2 * self.input_images
        fovx = math.radians(float(cfg.data.fov))
        fovy = 2 * math.atan(math.tan(fovx / 2) * H / W)
        znear, zfar = float(cfg.data.znear), float(cfg.data.zfar)
        capacity = capacity or int(cfg.data.get("max_points", num_points))
        base_seed = seed + {"train": 0, "val": 10_000, "test": 20_000}[split]
        rng = np.random.default_rng(base_seed)
        bg = [1.0] * 3 if cfg.data.white_background else [0.0] * 3
        device = resolve_device(device)

        self.examples = []
        for _ in range(num_scenes):
            coord, color, normal = _room_points(rng, num_points)
            keep, grid_coord, min_coord = grid_sample_dedup(coord)
            coord_k, color_k, normal_k = coord[keep], color[keep], normal[keep]
            M = len(keep)
            if M > capacity:
                sel = rng.choice(M, capacity, replace=False)
                sel.sort()
                coord_k, color_k = coord_k[sel], color_k[sel]
                normal_k, grid_coord = normal_k[sel], grid_coord[sel]
                M = capacity
            pad = capacity - M

            def pad_rows(a):
                return np.concatenate([a, np.zeros((pad, a.shape[1]),
                                                   a.dtype)])

            mask = np.concatenate([np.ones(M, bool), np.zeros(pad, bool)])
            # feat order (normal, colour) as the reference Collect feat_keys
            feat = np.concatenate([normal_k, color_k * 2.0 - 1.0], axis=1)
            cams = []
            for v in range(n_views):
                az = 2 * np.pi * v / n_views + rng.uniform(0, 0.2)
                pos = np.array([0.9 * math.cos(az), rng.uniform(0.1, 0.4),
                                0.9 * math.sin(az)])
                R, t = _look_at(pos, np.array([0.0, -0.3, 0.0]))
                cams.append(cam_util.build_camera_tensors(
                    R, t, fovx, fovy, znear, zfar))
            stack = {k: np.stack([c[k] for c in cams]) for k in cams[0]}
            gt = self._render_gt(coord_k, color_k, stack, bg, H, W,
                                 math.tan(fovx / 2), math.tan(fovy / 2),
                                 device)
            unproj = [unproject_zbuffer(coord_k, c["world_view_transform"],
                                        c["full_proj_transform"], H, W)
                      for c in cams[:self.input_images]]
            self.examples.append({
                "point_cloud": {
                    "coord": pad_rows(coord_k),
                    "grid_coord": pad_rows(grid_coord).astype(np.int32),
                    "feat": pad_rows(feat.astype(np.float32)),
                    "mask": mask,
                    "min_coord": min_coord.astype(np.float32),
                },
                "gt_images": gt,
                "unprojected_coords": np.stack(unproj),
                "world_view_transforms": stack["world_view_transform"],
                "view_to_world_transforms": stack["view_to_world"],
                "full_proj_transforms": stack["full_proj_transform"],
                "camera_centers": stack["camera_center"],
            })

    @staticmethod
    def _render_gt(coord, color, cams, bg, H, W, tanfovx, tanfovy, device):
        """Every view of one scene (opacity 0.95, isotropic scale
        1.5 x grid, SH degree 1 with only the DC term) in one binned-splat
        launch -> [V, 3, H, W]."""
        n = coord.shape[0]
        t = lambda a: torch.as_tensor(a, device=device)
        sh = torch.zeros(n, 4, 3, device=device)
        sh[:, 0] = rgb2sh(t(color))
        quat = torch.zeros(n, 4, device=device)
        quat[:, 0] = 1.0
        th, tw = binned_tile(H, W)
        with torch.no_grad():
            pg = preprocess_gaussians(
                t(coord), torch.full((n,), 0.95, device=device),
                torch.full((n, 3), 1.5 * GRID_SIZE, device=device), quat, sh,
                t(cams["world_view_transform"]),
                t(cams["full_proj_transform"]), t(cams["camera_center"]),
                H, W, tanfovx, tanfovy, 1)
            img = rasterize_projected_binned(
                *pg[:4], pg.depth, pg.radius, pg.valid, bg, H, W, th, tw,
                max_per_tile=GT_MAX_PER_TILE)
        return img.cpu().numpy()

    def __len__(self):
        # train: a virtual length that keeps epochs non-empty at any batch
        # size
        if self.split == "train":
            return max(len(self.examples), 16)
        return len(self.examples)

    def __getitem__(self, index: int) -> Dict:
        return self.examples[index % len(self.examples)]
