"""Brute-force reference renderer, differentiated by autograd; tile sizes.

Port of the reference part of unipre3d_tpu/ops/rasterizer/render.py
(``_alpha``, ``_composite``, ``_sorted_by_depth``,
``rasterize_projected_reference``, ``rasterize_reference``) and of
``auto_tile``. The tiled XLA renderer (``rasterize_projected``) is not
ported yet (ROADMAP.md item 14). In the reference renderer every pixel
composites every valid gaussian in depth order, O(N*P). It skips a pair at
``power > 0`` (the dense kernel skips at ``power > 1e-4``) and stops a
pixel once T after a gaussian would fall below 1e-4.
"""

from __future__ import annotations

import torch

from unipre3d_tpu_torch.ops.rasterizer.pack import ALPHA_MAX, ALPHA_MIN, T_EPS
from unipre3d_tpu_torch.ops.rasterizer.preprocess import (
    ProjectedGaussians, preprocess_gaussians)


def auto_tile(img_h: int, img_w: int) -> tuple:
    """Largest tile dims from {32, 16, 8, 4} dividing each image dim."""
    def pick(s):
        for t in (32, 16, 8, 4):
            if s % t == 0:
                return t
        return 1
    return pick(img_h), pick(img_w)


def binned_tile(img_h: int, img_w: int) -> tuple:
    """``auto_tile`` halved (the longer side first) down to at most 256
    pixels, the binned splat's tile (the JAX trainer's clamp,
    trainer.py:191-196)."""
    th, tw = auto_tile(img_h, img_w)
    while th * tw > 256:
        th, tw = (th // 2, tw) if th >= tw else (th, tw // 2)
    return th, tw


def _alpha(mean2d, conic, opacity, pix_x, pix_y):
    """mean2d [K,2], conic [K,3], opacity [K]; pix_x/pix_y [P] ->
    alpha [P, K] with the skip semantics above."""
    dx = mean2d[None, :, 0] - pix_x[:, None]
    dy = mean2d[None, :, 1] - pix_y[:, None]
    power = (-0.5 * (conic[None, :, 0] * dx * dx + conic[None, :, 2] * dy * dy)
             - conic[None, :, 1] * dx * dy)
    a = torch.clamp_max(opacity[None, :] * torch.exp(power), ALPHA_MAX)
    return torch.where((power > 0.0) | (a < ALPHA_MIN), torch.zeros_like(a), a)


def _composite(alpha, colors, bg_color):
    """Front-to-back blend. alpha [P, K] (depth-ordered), colors [K, 3],
    bg_color [3] -> (rgb [P, 3], final_T [P])."""
    log_1ma = torch.log1p(-alpha)
    cum = torch.cumsum(log_1ma, dim=1)
    T_after = torch.exp(cum)
    T_before = torch.exp(cum - log_1ma)
    contrib = T_after >= T_EPS
    w = torch.where(contrib, alpha * T_before, torch.zeros_like(alpha))
    rgb = w @ colors
    # T freezes at the stop point: only contributing gaussians update it
    log_T_final = torch.where(contrib, log_1ma,
                              torch.zeros_like(log_1ma)).sum(1)
    final_T = torch.exp(log_T_final)
    return rgb + final_T[:, None] * bg_color[None, :], final_T


def _sorted_by_depth(pg: ProjectedGaussians) -> ProjectedGaussians:
    """Invalid gaussians sort to the back (stable order)."""
    key = torch.where(pg.valid, pg.depth, torch.full_like(pg.depth, float("inf")))
    order = torch.argsort(key, stable=True)
    return ProjectedGaussians(*(t[order] for t in pg))


def rasterize_projected_reference(pg: ProjectedGaussians, bg_color,
                                  img_h: int, img_w: int) -> torch.Tensor:
    """One view's projected gaussians -> image [3, H, W]."""
    pg = _sorted_by_depth(pg)
    dev = pg.mean2d.device
    ys, xs = torch.meshgrid(torch.arange(img_h, dtype=torch.float32, device=dev),
                            torch.arange(img_w, dtype=torch.float32, device=dev),
                            indexing="ij")
    a = _alpha(pg.mean2d, pg.conic, pg.opacity, xs.reshape(-1), ys.reshape(-1))
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)
    rgb, _ = _composite(a, pg.color, bg)
    return rgb.reshape(img_h, img_w, 3).permute(2, 0, 1)


def rasterize_reference(means3d, opacities, scales, rotations, shs,
                        world_view, full_proj, cam_center,
                        *, img_h: int, img_w: int, tanfovx: float,
                        tanfovy: float, bg_color, sh_degree: int,
                        scale_modifier: float = 1.0,
                        antialiasing: bool = True,
                        gaussian_mask=None):
    """Preprocess + brute-force render of one view ->
    {"render" [3,H,W], "radii" [N], "visibility_filter" [N]}."""
    pg = preprocess_gaussians(
        means3d, opacities, scales, rotations, shs, world_view, full_proj,
        cam_center, img_h, img_w, tanfovx, tanfovy, sh_degree,
        scale_modifier, antialiasing, gaussian_mask)
    img = rasterize_projected_reference(pg, bg_color, img_h, img_w)
    return {"render": img, "radii": pg.radius,
            "visibility_filter": pg.radius > 0}
