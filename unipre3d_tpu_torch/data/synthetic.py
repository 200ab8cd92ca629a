"""Synthetic object-level dataset with a learnable objective.

Port of unipre3d_tpu/data/synthetic.py: procedural coloured point-cloud
shapes whose ground-truth views are rendered with the port's own dense
splat (isotropic gaussians at a subsample of the surface points), in the
ShapeNet batch schema: ``gt_images [V,3,H,W]``, ``world_view_transforms``
/ ``view_to_world_transforms`` / ``full_proj_transforms`` ``[V,4,4]``,
``camera_centers [V,3]``, ``point_cloud [N,3(+1)]``. Every random draw
comes from a generator seeded by the dataset seed (and, per example, by
the index), where the JAX version draws its view choice unseeded.

Splits as the JAX version's: ``train``, ``val`` and ``test`` draw from the
dataset seed + 0, + 10,000 and + 20,000; outside ``train`` an example holds
every view in order. The JAX version gives every split a virtual length of
128 (its 8 objects repeated 16 times); here only ``train`` does, and
``val``/``test`` hold each object once, which leaves every mean over the
split as it is.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from unipre3d_tpu_torch import resolve_device
from unipre3d_tpu_torch.ops.rasterizer.preprocess import preprocess_gaussians
from unipre3d_tpu_torch.ops.rasterizer.splat_dense import \
    rasterize_dense_batched
from unipre3d_tpu_torch.utils import camera as cam_util
from unipre3d_tpu_torch.utils.sh import rgb2sh

SPLIT_SEED = {"train": 0, "val": 10_000, "test": 20_000}


def _shape_points(rng: np.random.Generator, kind: int, n: int) -> np.ndarray:
    """n surface points of a unit-ish centred shape (sphere/torus/cube)."""
    if kind == 0:
        v = rng.normal(size=(n, 3))
        pts = v / np.linalg.norm(v, axis=1, keepdims=True) * 0.35
    elif kind == 1:
        u, t = rng.uniform(0, 2 * np.pi, (2, n))
        R, r = 0.3, 0.12
        pts = np.stack([(R + r * np.cos(t)) * np.cos(u),
                        (R + r * np.cos(t)) * np.sin(u),
                        r * np.sin(t)], axis=1)
    else:
        face = rng.integers(0, 6, n)
        uv = rng.uniform(-0.3, 0.3, (n, 2))
        ax = face % 3
        pts = np.zeros((n, 3))
        pts[np.arange(n), ax] = np.where(face < 3, 0.3, -0.3)
        others = np.stack([(ax + 1) % 3, (ax + 2) % 3], axis=1)
        others.sort(axis=1)
        pts[np.arange(n), others[:, 0]] = uv[:, 0]
        pts[np.arange(n), others[:, 1]] = uv[:, 1]
    return pts.astype(np.float32)


def _orbit_camera(azimuth: float, elevation: float, distance: float):
    """c2w rotation and w2c translation of a camera orbiting the origin,
    looking down +z at it."""
    ca, sa = math.cos(azimuth), math.sin(azimuth)
    ce, se = math.cos(elevation), math.sin(elevation)
    pos = np.array([distance * ce * sa, distance * se, distance * ce * ca])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right /= np.linalg.norm(right)
    up2 = np.cross(right, fwd)
    R = np.stack([right, -up2, fwd], axis=1)
    return R.astype(np.float32), (-R.T @ pos).astype(np.float32)


class SyntheticDataset:
    """Object-level synthetic dataset (ShapeNet schema), one split. GT views
    are rendered once, at construction, on ``device`` (the card by
    default)."""

    def __init__(self, cfg, split: str = "train", num_objects: int = 8,
                 num_views: int = 8, points_per_object: int = 1024,
                 render_points: int = 256, seed: int = 0, device=None):
        self.cfg = cfg
        self.split = split
        self.num_views = num_views
        self.imgs_per_obj = int(cfg.opt.get("imgs_per_obj", 4))
        self.input_images = int(cfg.data.input_images)
        self.base_seed = seed + SPLIT_SEED[split]
        res = int(cfg.data.training_resolution)
        fov = math.radians(float(cfg.data.fov))
        rng = np.random.default_rng(self.base_seed)

        clouds, colors, sels, cams = [], [], [], []
        for i in range(num_objects):
            pts = _shape_points(rng, i % 3, points_per_object)
            clouds.append(pts)
            colors.append((pts / 0.7 + 0.5).clip(0, 1).astype(np.float32))
            obj_cams = []
            for v in range(num_views):
                az = 2 * np.pi * v / num_views + rng.uniform(0, 0.3)
                R, t = _orbit_camera(az, rng.uniform(-0.5, 0.5), 1.5)
                obj_cams.append(cam_util.build_camera_tensors(
                    R, t, fov, fov, float(cfg.data.znear),
                    float(cfg.data.zfar)))
            cams.append(obj_cams)
            sels.append(rng.choice(points_per_object, render_points,
                                   replace=False))
        stack = lambda key: np.stack([[c[key] for c in oc] for oc in cams])
        self.cams = {k: stack(k) for k in (
            "world_view_transform", "view_to_world", "full_proj_transform",
            "camera_center")}
        self.clouds = clouds
        bg = [1.0, 1.0, 1.0] if cfg.data.white_background else [0.0] * 3
        self.gt_images = self._render_gt(
            np.stack([c[s] for c, s in zip(clouds, sels)]),
            np.stack([c[s] for c, s in zip(colors, sels)]), bg, res,
            math.tan(fov / 2), resolve_device(device))

    def _render_gt(self, means, colors, bg, res, tanfov, device):
        """All objects x views in one dense-splat launch -> [O, V, 3, H, W]."""
        O, n = means.shape[:2]
        t = lambda a: torch.as_tensor(a, device=device)
        sh = torch.zeros(O, 1, n, 4, 3, device=device)
        sh[..., 0, :] = rgb2sh(t(colors))[:, None]
        quat = torch.zeros(O, 1, n, 4, device=device)
        quat[..., 0] = 1.0
        with torch.no_grad():
            pg = preprocess_gaussians(
                t(means)[:, None], torch.full((O, 1, n), 0.9, device=device),
                torch.full((O, 1, n, 3), 0.025, device=device), quat, sh,
                t(self.cams["world_view_transform"]),
                t(self.cams["full_proj_transform"]),
                t(self.cams["camera_center"]), res, res, tanfov, tanfov, 1)
            V = pg.depth.shape[1]
            flat = lambda a: a.reshape(O * V, *a.shape[2:])
            img = rasterize_dense_batched(
                flat(pg.mean2d), flat(pg.conic), flat(pg.color),
                flat(pg.opacity), flat(pg.depth), flat(pg.valid), bg, res, res)
        return img.reshape(O, V, 3, res, res).cpu().numpy()

    def __len__(self):
        # train: a virtual length that keeps epochs non-empty at any batch
        # size
        if self.split == "train":
            return max(len(self.clouds), 128)
        return len(self.clouds)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        o = index % len(self.clouds)
        if self.split == "train":
            rng = np.random.default_rng((self.base_seed, index))
            sel = rng.permutation(self.num_views)[:self.imgs_per_obj]
            # conditioning views first, then every supervision view
            idx = np.concatenate([sel[:self.input_images], sel])
        else:
            idx = np.arange(self.num_views)
        pc = self.clouds[o]
        if int(self.cfg.model.in_channels) == 4:
            # gravity channel
            pc = np.concatenate([pc, pc[:, 1:2] - pc[:, 1].min()], axis=1)
        return {
            "gt_images": self.gt_images[o][idx],
            "world_view_transforms": self.cams["world_view_transform"][o][idx],
            "view_to_world_transforms": self.cams["view_to_world"][o][idx],
            "full_proj_transforms": self.cams["full_proj_transform"][o][idx],
            "camera_centers": self.cams["camera_center"][o][idx],
            "point_cloud": pc,
        }


def random_batch(cfg, batch: int, n_points: int = 256, n_views: int = 3,
                 seed: int = 0) -> Dict[str, np.ndarray]:
    """A random batch of the right shapes (uniform cloud and GT images,
    cameras on a ring), for step-level checks that need no rendering."""
    rng = np.random.default_rng(seed)
    res = int(cfg.data.training_resolution)
    fov = math.radians(float(cfg.data.fov))
    cams = []
    for v in range(n_views):
        az = 2 * np.pi * v / n_views
        R = np.array([[math.cos(az), 0, -math.sin(az)], [0, 1, 0],
                      [math.sin(az), 0, math.cos(az)]])
        cams.append(cam_util.build_camera_tensors(
            R, np.array([0.0, 0.0, 1.5]), fov, fov, float(cfg.data.znear),
            float(cfg.data.zfar)))
    ring = lambda k: np.broadcast_to(np.stack([c[k] for c in cams]),
                                     (batch, n_views) + cams[0][k].shape).copy()
    pc_ch = 4 if int(cfg.model.in_channels) == 4 else 3
    return {
        "point_cloud": rng.uniform(-0.4, 0.4, (batch, n_points, pc_ch))
        .astype(np.float32),
        "gt_images": rng.uniform(0, 1, (batch, n_views, 3, res, res))
        .astype(np.float32),
        "world_view_transforms": ring("world_view_transform"),
        "view_to_world_transforms": ring("view_to_world"),
        "full_proj_transforms": ring("full_proj_transform"),
        "camera_centers": ring("camera_center"),
    }
