"""The ``object_pool`` traffic kind: a pool of ``objects`` point clouds
of ``points`` points (superquadric surfaces of random radii, exponents and
pose), each seen from ``views`` orbit cameras at ``camera_distance``
around it, and one uint8 image per (object, view): the cloud's silhouette
from that camera (its points projected and dilated, drawn by the
benchmark itself) filled with a smooth random colour field on the black
background of the ShapeNet renders. Everything is drawn on the device in
a few large calls and kept on the host. Sample ``i`` of the virtual
dataset is the object and views that ``(seed, i)`` draw: its conditioning
view first, then ``imgs_per_obj`` distinct supervision views beginning
with the conditioning view again, in the ShapeNet reader's batch schema.
Over ``objects x views`` distinct conditioning images an LRU cache of C
slots hits about C / (objects x views) of its lookups.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from port_bench.generator import (VIRTUAL_LENGTH, camera_tensors,
                                   stream_seed)


def _clouds(gen, n_obj, n_pts, device):
    """Superquadric surfaces: random radii 0.15-0.4, exponents 0.3-1.5,
    a random rotation, 1% radial noise -> [n_obj, n_pts, 3]."""
    u = torch.rand(n_obj, n_pts, 2, generator=gen, device=device)
    eta = (u[..., 0] - 0.5) * math.pi
    omega = (u[..., 1] * 2 - 1) * math.pi
    r = 0.15 + 0.25 * torch.rand(n_obj, 1, 3, generator=gen, device=device)
    e = 0.3 + 1.2 * torch.rand(n_obj, 1, 2, generator=gen, device=device)
    sp = lambda x, p: torch.sign(x) * x.abs() ** p
    ce, se = sp(torch.cos(eta), e[..., 0]), sp(torch.sin(eta), e[..., 0])
    pts = torch.stack([ce * sp(torch.cos(omega), e[..., 1]),
                       ce * sp(torch.sin(omega), e[..., 1]), se], -1) * r
    pts = pts * (1 + 0.01 * torch.randn(n_obj, n_pts, 1, generator=gen,
                                        device=device))
    q, _ = torch.linalg.qr(torch.randn(n_obj, 3, 3, generator=gen,
                                       device=device))
    return pts @ q


def _images(gen, clouds, cams, res, device):
    """One uint8 image [3, res, res] per (object, view): the silhouette of
    the cloud's projected points, dilated 5x5, times a smooth colour
    field, on black."""
    n_obj, n_views = cams["world_view_transforms"].shape[:2]
    n = n_obj * n_views
    fp = torch.as_tensor(cams["full_proj_transforms"], device=device)
    pts = clouds[:, None].expand(n_obj, n_views, *clouds.shape[1:])
    hom = torch.cat([pts, torch.ones_like(pts[..., :1])], -1)
    clip = torch.einsum("ovpi,ovij->ovpj", hom, fp).reshape(n, -1, 4)
    px = ((clip[..., 0] / clip[..., 3] + 1) * res - 1) / 2
    py = ((clip[..., 1] / clip[..., 3] + 1) * res - 1) / 2
    ix, iy = px.round().long(), py.round().long()
    ok = (ix >= 0) & (ix < res) & (iy >= 0) & (iy < res)
    mask = torch.zeros(n, res * res, device=device)
    mask.scatter_reduce_(1, torch.where(ok, iy * res + ix, 0), ok.float(),
                         "amax")
    mask = torch.nn.functional.max_pool2d(mask.view(n, 1, res, res), 5, 1, 2)
    field = torch.rand(n, 3, 6, 6, generator=gen, device=device)
    field = torch.nn.functional.interpolate(field, size=(res, res),
                                            mode="bicubic",
                                            align_corners=False)
    img = (field.clamp(0.05, 1) * mask * 255).round().to(torch.uint8)
    return img.view(n_obj, n_views, 3, res, res)


class Dataset:
    """The ``object_pool`` mix over a ShapeNet-schema config."""

    def __init__(self, mix: dict, spec: dict, seed: int, device):
        self.seed = int(seed)
        self.n_in = int(spec["input_images"])
        self.n_sup = int(spec["imgs_per_obj"])
        n_obj, n_views = int(mix["objects"]), int(mix["views"])
        if n_views < self.n_sup:
            raise ValueError(f"{n_views} views cannot give {self.n_sup} "
                             f"distinct supervision views")
        res = int(spec["training_resolution"])
        gen = torch.Generator(device=device).manual_seed(stream_seed(seed, 1))
        rng = np.random.default_rng(stream_seed(seed, 2))
        clouds = _clouds(gen, n_obj, int(spec["num_points"]), device)
        az = rng.uniform(0, 2 * np.pi, n_obj * n_views)
        el = rng.uniform(*mix["elevation"], n_obj * n_views)
        cams = camera_tensors(az, el, float(mix["camera_distance"]),
                              float(spec["fov"]), float(spec["znear"]),
                              float(spec["zfar"]))
        self.cams = {k: v.reshape(n_obj, n_views, *v.shape[1:])
                     for k, v in cams.items()}
        # kept as the loader hands them on (float32 in [0, 1]), so that its
        # reading thread only indexes
        self.images = (_images(gen, clouds, self.cams, res, device).float()
                       / 255.0).cpu().numpy()
        self.clouds = clouds.float().cpu().numpy()
        self.n_obj, self.n_views = n_obj, n_views

    def __len__(self):
        return VIRTUAL_LENGTH

    def draw(self, index: int):
        """(object, views) of sample ``index``: the conditioning views, then
        the supervision views, the first of them the conditioning view."""
        rng = np.random.default_rng([self.seed, int(index)])
        o = int(rng.integers(self.n_obj))
        sel = rng.permutation(self.n_views)[:self.n_sup]
        return o, np.concatenate([sel[:self.n_in], sel])

    def __getitem__(self, index: int):
        o, idx = self.draw(index)
        out = {k: v[o][idx] for k, v in self.cams.items()}
        out["gt_images"] = self.images[o][idx]
        out["point_cloud"] = self.clouds[o]
        return out
