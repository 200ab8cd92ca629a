"""Renderers of one view or of R views, and the ``raster_impl`` dispatch.

Port of unipre3d_tpu/ops/rasterizer/render.py:

* the brute-force reference (``_alpha``, ``_composite``,
  ``rasterize_projected_reference``, ``rasterize_reference``): every pixel
  composites every valid gaussian in depth order, O(N*P), skipping a pair at
  ``power > 0`` (the dense kernel skips at ``power > 1e-4``) and stopping a
  pixel once T after a gaussian would fall below 1e-4;
* the tiled renderer ``rasterize_projected`` (plain torch, as JAX computes
  it outside any Pallas kernel): each tile keeps the first ``capacity``
  depth-ordered gaussians whose bbox overlaps it (stable compaction; the
  farthest are dropped), gathered by ``_compact_gather``, and composites
  them in 256-wide K-chunks whose T re-arms (only contributing log(1 -
  alpha) are carried), with the linear-space stop test ``exp(cum) >=
  1e-4``. It is the route of ``raster_impl=xla`` and of the training step's
  ``auto`` above 4096 gaussians;
* ``rasterize`` (preprocess, then ``impl`` = ``xla`` (tiled), ``pallas``
  (the streaming splat, splat_stream.py) or ``pallas_binned`` (the binned
  splat, at most 4 x ``capacity`` duplicates a tile)) and
  ``render_predicted``, its wrapper over a predicted-gaussian dict;
  ``render_predicted_views``, the views of several cameras (the test
  videos): on the ``pallas`` route all of them through the streaming
  splat in one launch, on the others one ``render_predicted`` call a view;
* ``auto_tile``.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from unipre3d_tpu_torch.ops.rasterizer.pack import ALPHA_MAX, ALPHA_MIN, T_EPS
from unipre3d_tpu_torch.ops.rasterizer.preprocess import (
    ProjectedGaussians, preprocess_gaussians, sort_by_depth)
from unipre3d_tpu_torch.ops.rasterizer.splat_binned import (
    MAX_TILE_PIXELS as BINNED_TILE_PIXELS, rasterize_projected_binned)
from unipre3d_tpu_torch.ops.rasterizer.splat_stream import (
    rasterize_projected_stream, tile_origins, tile_overlap)
from unipre3d_tpu_torch.utils.camera import focal2fov

IMPLS = ("xla", "pallas", "pallas_binned")
K_CHUNK = 256     # gaussians of a tile composited per step of the tiled path


def auto_tile(img_h: int, img_w: int) -> tuple:
    """Largest tile dims from {32, 16, 8, 4} dividing each image dim."""
    def pick(s):
        for t in (32, 16, 8, 4):
            if s % t == 0:
                return t
        return 1
    return pick(img_h), pick(img_w)


def clamp_tile(tile_h: int, tile_w: int,
               max_pixels: int = BINNED_TILE_PIXELS) -> tuple:
    """Tile dims halved (the longer side first) down to at most
    ``max_pixels`` pixels (the JAX trainer's clamp, trainer.py:191-196)."""
    while tile_h * tile_w > max_pixels:
        tile_h, tile_w = ((tile_h // 2, tile_w) if tile_h >= tile_w
                          else (tile_h, tile_w // 2))
    return tile_h, tile_w


def binned_tile(img_h: int, img_w: int) -> tuple:
    """``auto_tile`` clamped to the binned splat's 256-pixel tile."""
    return clamp_tile(*auto_tile(img_h, img_w))


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


class _CompactGather(torch.autograd.Function):
    """Per-tile candidate gather: fields [N, F], cand [..., K] (indices into
    N), slot_ok [..., K] -> [..., K, F], 0 on dead slots. Backward: the
    segment sum of the slots' cotangents per gaussian, an ``index_add_``
    (the JAX package computes the same sum with a sort and run-boundary
    cumsum differences, a TPU device for it)."""

    @staticmethod
    def forward(ctx, fields, cand, slot_ok):
        ctx.save_for_backward(cand, slot_ok)
        ctx.n = fields.shape[0]
        g = fields[cand]
        return torch.where(slot_ok[..., None], g, torch.zeros_like(g))

    @staticmethod
    def backward(ctx, dg):
        cand, slot_ok = ctx.saved_tensors
        F = dg.shape[-1]
        dg = torch.where(slot_ok[..., None], dg, torch.zeros_like(dg))
        out = torch.zeros(ctx.n, F, dtype=dg.dtype, device=dg.device)
        out.index_add_(0, cand.reshape(-1), dg.reshape(-1, F))
        return out, None, None


def _compact_gather(fields, cand, slot_ok):
    return _CompactGather.apply(fields, cand, slot_ok)


def _chunk_step(rgb, log_t, mean2d, conic, color, opa, px, py):
    """One K-chunk of the tiled composite: tiles' gaussians [n, c, ...],
    pixels px/py [n, P]; carries rgb [n, P, 3] and log T [n, P]."""
    dx = mean2d[:, None, :, 0] - px[:, :, None]                # [n, P, c]
    dy = mean2d[:, None, :, 1] - py[:, :, None]
    power = (-0.5 * (conic[:, None, :, 0] * dx * dx
                     + conic[:, None, :, 2] * dy * dy)
             - conic[:, None, :, 1] * dx * dy)
    a = torch.clamp_max(opa[:, None, :] * torch.exp(power), ALPHA_MAX)
    a = torch.where((power > 0.0) | (a < ALPHA_MIN), torch.zeros_like(a), a)
    log_1ma = torch.log1p(-a)
    cum = torch.cumsum(log_1ma, dim=-1) + log_t[..., None]
    contrib = torch.exp(cum) >= T_EPS
    w = torch.where(contrib, a * torch.exp(cum - log_1ma), torch.zeros_like(a))
    rgb = rgb + torch.bmm(w, color)
    log_t = log_t + torch.where(contrib, log_1ma,
                                torch.zeros_like(log_1ma)).sum(-1)
    return rgb, log_t


def rasterize_projected(pg: ProjectedGaussians, bg_color, img_h: int,
                        img_w: int, tile_h: int = 16, tile_w: int = 16,
                        capacity: int = 1024) -> torch.Tensor:
    """The tiled renderer: projected gaussians (fields [N, ...] or
    [R, N, ...]) -> image [3, H, W] (or [R, 3, H, W]). Each K-chunk step is
    recomputed in the backward (``torch.utils.checkpoint``, as the JAX
    package's ``jax.checkpoint``), which bounds the residuals to one chunk's
    [tiles, P, 256] terms."""
    if img_h % tile_h or img_w % tile_w:
        raise ValueError(f"tiles {tile_h}x{tile_w} must divide "
                         f"{img_h}x{img_w}")
    single = pg.depth.ndim == 1
    if single:
        pg = ProjectedGaussians(*(t[None] for t in pg))
    pg = sort_by_depth(pg)
    R, N = pg.depth.shape
    K = min(capacity, N)
    dev = pg.depth.device
    x0, y0 = tile_origins(img_h, img_w, tile_h, tile_w, dev)
    n_tiles = x0.shape[0]
    overlap = tile_overlap(pg.mean2d.detach(), pg.radius, pg.valid, img_h,
                           img_w, tile_h, tile_w)               # [R, T, N]
    # stable compaction: depth-ordered overlapping indices first
    iota = torch.arange(N, device=dev)
    key = torch.where(overlap, iota, N + iota)
    cand = torch.sort(key, dim=-1).indices[..., :K]             # [R, T, K]
    count = overlap.sum(-1)
    slot_ok = torch.arange(K, device=dev) < torch.clamp_max(
        count, K)[..., None]

    fields = torch.cat([pg.mean2d, pg.conic, pg.color, pg.opacity[..., None]],
                       dim=-1).reshape(R * N, 9)
    cand = cand + (torch.arange(R, device=dev) * N)[:, None, None]
    g = _compact_gather(fields, cand, slot_ok).reshape(R * n_tiles, K, 9)

    t = torch.arange(tile_h * tile_w, device=dev)
    px = (x0[:, None] + t % tile_w).float().repeat(R, 1)       # [R*T, P]
    py = (y0[:, None] + t // tile_w).float().repeat(R, 1)
    kc = min(K_CHUNK, K)
    n_k = -(-K // kc)
    g = torch.nn.functional.pad(g, (0, 0, 0, n_k * kc - K))
    rgb = torch.zeros(R * n_tiles, tile_h * tile_w, 3, device=dev)
    log_t = torch.zeros(R * n_tiles, tile_h * tile_w, device=dev)
    for k in range(n_k):
        s = g[:, k * kc:(k + 1) * kc]
        args = (rgb, log_t, s[..., 0:2], s[..., 2:5], s[..., 5:8], s[..., 8],
                px, py)
        if torch.is_grad_enabled():
            rgb, log_t = checkpoint(_chunk_step, *args, use_reentrant=False)
        else:
            rgb, log_t = _chunk_step(*args)
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)
    tiles = rgb + torch.exp(log_t)[..., None] * bg
    img = tiles.reshape(R, img_h // tile_h, img_w // tile_w, tile_h, tile_w, 3)
    img = img.permute(0, 5, 1, 3, 2, 4).reshape(R, 3, img_h, img_w)
    return img[0] if single else img


def rasterize_projected_reference(pg: ProjectedGaussians, bg_color,
                                  img_h: int, img_w: int) -> torch.Tensor:
    """One view's projected gaussians -> image [3, H, W]."""
    pg = sort_by_depth(pg)
    dev = pg.mean2d.device
    ys, xs = torch.meshgrid(torch.arange(img_h, dtype=torch.float32, device=dev),
                            torch.arange(img_w, dtype=torch.float32, device=dev),
                            indexing="ij")
    a = _alpha(pg.mean2d, pg.conic, pg.opacity, xs.reshape(-1), ys.reshape(-1))
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)
    rgb, _ = _composite(a, pg.color, bg)
    return rgb.reshape(img_h, img_w, 3).permute(2, 0, 1)


def rasterize(means3d, opacities, scales, rotations, shs,
              world_view, full_proj, cam_center,
              *, img_h: int, img_w: int, tanfovx: float, tanfovy: float,
              bg_color, sh_degree: int, scale_modifier: float = 1.0,
              antialiasing: bool = True, gaussian_mask=None,
              tile_h: int = 16, tile_w: int = 16, capacity: int = 1024,
              impl: str = "xla", dup_budget: int = None) -> Dict[str, Any]:
    """Preprocess + render of one view -> {"render" [3,H,W], "radii" [N],
    "visibility_filter" [N]}. ``impl``: ``xla`` (the tiled renderer with
    ``capacity`` a tile), ``pallas`` (the streaming splat: no cap) or
    ``pallas_binned`` (the binned splat, at most 4 x ``capacity``
    duplicates a tile; its tiles clamped to 256 pixels, the largest its
    kernel takes)."""
    if impl not in IMPLS:
        raise ValueError(f"raster impl {impl!r}: one of {IMPLS}")
    pg = preprocess_gaussians(
        means3d, opacities, scales, rotations, shs, world_view, full_proj,
        cam_center, img_h, img_w, tanfovx, tanfovy, sh_degree,
        scale_modifier, antialiasing, gaussian_mask)
    if impl == "pallas_binned":
        th, tw = clamp_tile(tile_h, tile_w)
        img = rasterize_projected_binned(
            *(t[None] for t in pg), bg_color, img_h, img_w, th, tw,
            max_per_tile=capacity * 4, dup_budget=dup_budget)[0]
    elif impl == "pallas":
        img = rasterize_projected_stream(pg, bg_color, img_h, img_w, tile_h,
                                         tile_w)
    else:
        img = rasterize_projected(pg, bg_color, img_h, img_w, tile_h, tile_w,
                                  capacity)
    return {"render": img, "radii": pg.radius,
            "visibility_filter": pg.radius > 0}


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


def _predicted_inputs(pc: Dict[str, torch.Tensor], cfg,
                      focals_pixels=None) -> tuple:
    """A predicted-gaussian dict under the composed config -> (img_h,
    img_w, tanfovx, tanfovy, opacity [N], shs [N, K, 3])."""
    if focals_pixels is None:
        tanfovx = tanfovy = math.tan(float(cfg.data.fov) * math.pi / 360)
    else:
        res = int(cfg.data.training_resolution)
        tanfovx = math.tan(focal2fov(float(focals_pixels[0]), res) / 2)
        tanfovy = math.tan(focal2fov(float(focals_pixels[1]), res) / 2)
    if "training_resolution" in cfg.data:
        img_h = img_w = int(cfg.data.training_resolution)
    else:
        img_h, img_w = (int(cfg.data.training_height),
                        int(cfg.data.training_width))
    if "features_rest" in pc:
        shs = torch.cat([pc["features_dc"], pc["features_rest"]], dim=1)
    else:
        shs = pc["features_dc"]
    opacity = pc["opacity"].reshape(pc["xyz"].shape[:-1])    # [N] or [N, 1]
    return img_h, img_w, tanfovx, tanfovy, opacity, shs


def render_predicted(pc: Dict[str, torch.Tensor], world_view_transform,
                     full_proj_transform, camera_center, bg_color, cfg,
                     scaling_modifier: float = 1.0, focals_pixels=None,
                     gaussian_mask=None, use_reference: bool = False):
    """One view of a predicted-gaussian dict ``{"xyz", "opacity",
    "scaling", "rotation", "features_dc"[, "features_rest"]}`` (no batch
    axis) under the composed config: ``auto_tile`` tiles, capacity
    ``tpu.raster_tile_capacity`` and the renderer ``tpu.raster_impl``
    (default ``xla``), or the brute-force reference."""
    img_h, img_w, tanfovx, tanfovy, opacity, shs = _predicted_inputs(
        pc, cfg, focals_pixels)
    kwargs = dict(
        img_h=img_h, img_w=img_w, tanfovx=tanfovx, tanfovy=tanfovy,
        bg_color=bg_color, sh_degree=int(cfg.model.max_sh_degree),
        scale_modifier=scaling_modifier, gaussian_mask=gaussian_mask)
    args = (pc["xyz"], opacity, pc["scaling"], pc["rotation"],
            shs, world_view_transform, full_proj_transform, camera_center)
    if use_reference:
        return rasterize_reference(*args, **kwargs)
    tpu = cfg.get("tpu") or {}
    kwargs["tile_h"], kwargs["tile_w"] = auto_tile(img_h, img_w)
    return rasterize(*args, capacity=int(tpu.get("raster_tile_capacity", 1024)),
                     impl=str(tpu.get("raster_impl", "xla")), **kwargs)


def render_predicted_views(pc: Dict[str, torch.Tensor], world_view_transforms,
                           full_proj_transforms, camera_centers, bg_color,
                           cfg, gaussian_mask=None) -> torch.Tensor:
    """The views of V cameras (``world_view_transforms`` and
    ``full_proj_transforms`` [V, 4, 4], ``camera_centers`` [V, 3]) of one
    predicted-gaussian dict (no batch axis) -> [V, 3, H, W]. On the
    ``pallas`` route all V views go through the streaming splat in one
    launch: the gaussians [N] are preprocessed against all V cameras at
    once, as ``trainer.render_supervision_views`` does, then
    ``rasterize_projected_stream`` renders them as R = V renders at
    ``auto_tile`` tiles. Each view then equals ``render_predicted``'s bit
    for bit: the preprocess is elementwise, and every render is sorted and
    composited on its own. On the other routes one ``render_predicted``
    call a view (the tiled renderer's chunk terms grow with the renders of
    a call)."""
    tpu = cfg.get("tpu") or {}
    if str(tpu.get("raster_impl", "xla")) != "pallas":
        return torch.stack([render_predicted(
            pc, wv, fp, cc, bg_color, cfg,
            gaussian_mask=gaussian_mask)["render"]
            for wv, fp, cc in zip(world_view_transforms,
                                  full_proj_transforms, camera_centers)])
    img_h, img_w, tanfovx, tanfovy, opacity, shs = _predicted_inputs(pc, cfg)
    pg = preprocess_gaussians(
        pc["xyz"], opacity, pc["scaling"], pc["rotation"], shs,
        world_view_transforms, full_proj_transforms, camera_centers, img_h,
        img_w, tanfovx, tanfovy, int(cfg.model.max_sh_degree),
        gaussian_mask=gaussian_mask)                 # fields [V, N, ...]
    return rasterize_projected_stream(pg, bg_color, img_h, img_w,
                                      *auto_tile(img_h, img_w))
