"""Test renders: the rotating orbit and the render | GT test views.

Port of unipre3d_tpu/training/video.py. The render half needs only torch:
``predict_example`` (the eval-mode gaussians of one example, from the EMA
parameters), ``test_view_frames`` (every view of the example, render beside
ground truth) and ``render_orbit`` (the reference's two-phase orbit), both
through ``render_views``: on the ``pallas`` route all views of a call in
one streaming-splat launch, on the others one render a view
(``render_predicted_views``).
``write_video`` imports ``imageio`` when it writes (mp4 when an ffmpeg
backend imports, else GIF), so a machine without it still renders.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from unipre3d_tpu_torch.data import batch_to
from unipre3d_tpu_torch.ops.rasterizer.render import render_predicted_views
from unipre3d_tpu_torch.training.trainer import bg_color_of, predict
from unipre3d_tpu_torch.utils import camera as cam_util

CAMERA_DISTANCE = 1.75  # reference dataset/shapenet.py:36


def orbit_pose(roll_deg: float, pitch_deg: float,
               distance_ratio: float = 1.0) -> np.ndarray:
    """c2w 4x4 of the reference orbit parameterisation
    (dataset/shapenet.py:671-745)."""
    az = math.radians(-roll_deg)
    el = math.radians(pitch_deg - 90)
    R = np.array([
        [math.cos(az), math.cos(el) * math.sin(az),
         math.sin(el) * math.sin(az)],
        [-math.sin(az), math.cos(el) * math.cos(az),
         math.sin(el) * math.cos(az)],
        [0.0, -math.sin(el), math.cos(el)],
    ])
    t = np.array([
        -CAMERA_DISTANCE * math.sin(el) * math.sin(az) * distance_ratio,
        -CAMERA_DISTANCE * math.sin(el) * math.cos(az) * distance_ratio,
        -CAMERA_DISTANCE * math.cos(el) * distance_ratio,
    ])
    tf = np.eye(4)
    tf[:3, :3] = R
    tf[:3, 3] = t
    return tf


def continuous_orbit_poses(num: int = 160) -> List[np.ndarray]:
    """The reference's two-phase orbit: a full spin rising 0 -> 20 deg,
    then 20 -> 90 deg (dataset/shapenet.py:747-764). Returns 2*num c2w."""
    rolls = np.linspace(-180, 180, num)
    p1 = np.linspace(0, 20, num)
    p2 = np.linspace(20, 90, num)
    return [orbit_pose(r, p) for r, p in
            list(zip(rolls, p1)) + list(zip(rolls, p2))]


def orbit_camera_tensors(cfg, num: int = 80) -> Dict[str, np.ndarray]:
    """Camera tensor stacks of an orbit (ShapeNet intrinsics)."""
    fov = math.radians(float(cfg.data.fov))
    proj = cam_util.get_projection_matrix(
        float(cfg.data.znear), float(cfg.data.zfar), fov, fov).T
    wv, fp, cc = [], [], []
    for c2w in continuous_orbit_poses(num // 2):
        w2c = np.linalg.inv(c2w)
        wvt = cam_util.get_world2view(w2c[:3, :3].T, w2c[:3, 3]).T
        wv.append(wvt)
        fp.append((wvt @ proj).astype(np.float32))
        cc.append(np.linalg.inv(wvt.astype(np.float64))[3, :3]
                  .astype(np.float32))
    return {"world_view_transforms": np.stack(wv).astype(np.float32),
            "full_proj_transforms": np.stack(fp),
            "camera_centers": np.stack(cc)}


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[..., 3, H, W] float -> [..., H, W, 3] uint8 (clipped, truncated)."""
    img = np.clip(img, 0, 1)
    return (np.moveaxis(img, -3, -1) * 255).astype(np.uint8)


CAMERA_KEYS = ("world_view_transforms", "full_proj_transforms",
               "camera_centers")


def render_views(gaussians, cams, cfg, gaussian_mask) -> np.ndarray:
    """Every camera of ``cams`` (numpy stacks [V, ...]) -> [V, 3, H, W] on
    the CPU, through ``render_predicted_views`` (on the ``pallas`` route in
    one streaming-splat launch)."""
    dev = gaussians["xyz"].device
    with torch.no_grad():
        wv, fp, cc = (torch.as_tensor(cams[k], device=dev)
                      for k in CAMERA_KEYS)
        return render_predicted_views(
            gaussians, wv, fp, cc, bg_color_of(cfg), cfg,
            gaussian_mask=gaussian_mask).cpu().numpy()


def render_orbit(gaussians: Dict[str, torch.Tensor], cfg,
                 num_frames: int = 80,
                 gaussian_mask: Optional[torch.Tensor] = None) -> np.ndarray:
    """An orbit around ONE example's gaussian dict (no batch axis) ->
    frames [F, H, W, 3] uint8."""
    cams = orbit_camera_tensors(cfg, num_frames)
    return to_uint8(render_views(gaussians, cams, cfg, gaussian_mask))


def predict_example(model, state, cfg, batch, use_ema: bool = True):
    """The eval-mode gaussians of the first example of a numpy batch, from
    the EMA parameters -> (gaussian dict without the batch axis, its mask
    or None)."""
    dev = next(model.parameters()).device
    model.eval()
    with torch.no_grad():
        g = predict(model, batch_to(batch, dev), int(cfg.data.input_images),
                    params=state.ema if use_ema else None)
    one = {k: v[0] for k, v in g.items()}
    return one, one.pop("mask", None)


def test_view_frames(gaussians, mask, cfg, batch) -> np.ndarray:
    """Every view of the first example of a numpy batch, its render beside
    its ground truth -> [V, H, 2W, 3] uint8."""
    cams = {k: batch[k][0] for k in CAMERA_KEYS}
    rendered = render_views(gaussians, cams, cfg, mask)
    pair = np.concatenate([np.clip(rendered, 0, 1),
                           np.clip(batch["gt_images"][0], 0, 1)], axis=3)
    return to_uint8(pair)


def write_video(frames: np.ndarray, path_base: str, fps: int = 20) -> str:
    """Write frames [F, H, W, 3] uint8: mp4 if an ffmpeg backend imports,
    else GIF. Returns the written path."""
    import imageio
    try:
        import imageio_ffmpeg  # noqa: F401
        path = path_base + ".mp4"
        imageio.mimwrite(path, frames, fps=fps, codec="libx264")
        return path
    except Exception:
        path = path_base + ".gif"
        imageio.mimwrite(path, frames, duration=1000 / fps, loop=0)
        return path


def generate_test_examples(model, state, cfg, test_loader, out_dir: str,
                           iteration: int, num_examples: int = 1,
                           use_ema: bool = True,
                           orbit_frames: int = 80) -> List[str]:
    """For each of the first ``num_examples`` test examples: a video of
    every view, render beside ground truth, and at object level an orbit
    video. Everything is rendered before the first write."""
    videos = []
    for i, batch in enumerate(test_loader.epoch(0)):
        if i >= num_examples:
            break
        one, mask = predict_example(model, state, cfg, batch, use_ema)
        videos.append((f"test_views_{iteration}_{i}",
                       test_view_frames(one, mask, cfg, batch), 4))
        if cfg.opt.level == "object":
            videos.append((f"test_orbit_{iteration}_{i}",
                           render_orbit(one, cfg, orbit_frames, mask), 20))
    return [write_video(frames, os.path.join(out_dir, name), fps)
            for name, frames, fps in videos]
