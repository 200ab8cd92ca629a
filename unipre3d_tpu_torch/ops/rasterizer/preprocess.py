"""Per-Gaussian screen-space preprocessing for the differentiable splatter.

Port of unipre3d_tpu/ops/rasterizer/preprocess.py: world->view transform,
near cull at view z 0.2, EWA projection of the 3D covariance, the 0.3 px
low-pass with its anti-aliasing opacity compensation, conic and radius,
NDC->pixel and clamped SH->RGB. Every Gaussian is processed at once over
any leading batch dims (the JAX version is vmapped instead); outputs keep
a validity mask rather than culling dynamically.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from unipre3d_tpu_torch.utils.camera import ndc2pix
from unipre3d_tpu_torch.utils.sh import sh_to_rgb_clamped

NEAR_CULL_Z = 0.2
AA_BLUR = 0.3  # low-pass filter variance added to the 2D covariance (px^2)


class ProjectedGaussians(NamedTuple):
    """Screen-space Gaussians, all [..., N, ...]."""
    mean2d: torch.Tensor      # [..., N, 2] pixel coords (x, y)
    conic: torch.Tensor       # [..., N, 3] inverse 2D covariance (a, b, c)
    color: torch.Tensor       # [..., N, 3] RGB from SH (clamped >= 0)
    opacity: torch.Tensor     # [..., N] after AA compensation
    depth: torch.Tensor       # [..., N] view-space z
    radius: torch.Tensor      # [..., N] int32 pixel radius (0 = culled)
    valid: torch.Tensor       # [..., N] bool


def _rot_columns(rotations: torch.Tensor):
    """Columns of the rotation matrix of wxyz quaternions, three [..., 3]."""
    w, x, y, z = (rotations[..., 0], rotations[..., 1], rotations[..., 2],
                  rotations[..., 3])
    r0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y + w * z),
                      2 * (x * z - w * y)], dim=-1)
    r1 = torch.stack([2 * (x * y - w * z), 1 - 2 * (x * x + z * z),
                      2 * (y * z + w * x)], dim=-1)
    r2 = torch.stack([2 * (x * z + w * y), 2 * (y * z - w * x),
                      1 - 2 * (x * x + y * y)], dim=-1)
    return r0, r1, r2


def preprocess_gaussians(
    means3d: torch.Tensor,        # [..., N, 3] world positions
    opacities: torch.Tensor,      # [..., N]
    scales: torch.Tensor,         # [..., N, 3]
    rotations: torch.Tensor,      # [..., N, 4] normalized (w, x, y, z)
    shs: torch.Tensor,            # [..., N, K, 3] SH coeffs (dc first)
    world_view: torch.Tensor,     # [..., 4, 4] transposed world->view
    full_proj: torch.Tensor,      # [..., 4, 4] transposed full projection
    cam_center: torch.Tensor,     # [..., 3]
    img_h: int, img_w: int,
    tanfovx: float, tanfovy: float,
    sh_degree: int,
    scale_modifier: float = 1.0,
    antialiasing: bool = True,
    gaussian_mask: Optional[torch.Tensor] = None,  # [..., N] bool
) -> ProjectedGaussians:
    """Leading dims of the Gaussians and of the cameras broadcast against
    each other (e.g. Gaussians [B, 1, N, ...] with cameras [B, V, ...])."""
    means3d = means3d.float()
    opacities = opacities.float()
    wv = world_view.float()
    fp4 = full_proj.float()

    def xform(m):  # rows of p_hom . m, with the implicit 1 * m[3]
        m = m[..., None, :, :]
        return [means3d[..., 0] * m[..., 0, j] + means3d[..., 1] * m[..., 1, j]
                + means3d[..., 2] * m[..., 2, j] + m[..., 3, j]
                for j in range(4)]

    pv = xform(wv)
    pc = xform(fp4)
    p_w = 1.0 / (pc[3] + 1e-7)

    depth = pv[2]
    in_front = depth > NEAR_CULL_Z

    mean2d = torch.stack([ndc2pix(pc[0] * p_w, img_w),
                          ndc2pix(pc[1] * p_w, img_h)], dim=-1)

    focal_x = img_w / (2.0 * tanfovx)
    focal_y = img_h / (2.0 * tanfovy)

    tz = torch.where(depth.abs() > 1e-6, depth, torch.full_like(depth, 1e-6))
    limx, limy = 1.3 * tanfovx, 1.3 * tanfovy
    txtz = torch.clamp(pv[0] / tz, -limx, limx)
    tytz = torch.clamp(pv[1] / tz, -limy, limy)
    tx = txtz * tz
    ty = tytz * tz

    # world->view rotation in the column-vector convention: the stored
    # matrix is transposed, so R_wc = WV[:3, :3]^T
    W = wv[..., :3, :3].transpose(-1, -2)[..., None, :, :]
    j00 = focal_x / tz
    j02 = -focal_x * tx / (tz * tz)
    j11 = focal_y / tz
    j12 = -focal_y * ty / (tz * tz)
    a1 = [j00 * W[..., 0, j] + j02 * W[..., 2, j] for j in range(3)]
    a2 = [j11 * W[..., 1, j] + j12 * W[..., 2, j] for j in range(3)]

    r0, r1, r2 = _rot_columns(rotations.float())
    s2 = (scales.float() * scale_modifier) ** 2
    c_xx = torch.zeros_like(tz)
    c_xy = torch.zeros_like(tz)
    c_yy = torch.zeros_like(tz)
    for k, rk in enumerate((r0, r1, r2)):
        u = rk[..., 0] * a1[0] + rk[..., 1] * a1[1] + rk[..., 2] * a1[2]
        v = rk[..., 0] * a2[0] + rk[..., 1] * a2[1] + rk[..., 2] * a2[2]
        c_xx = c_xx + s2[..., k] * u * u
        c_xy = c_xy + s2[..., k] * u * v
        c_yy = c_yy + s2[..., k] * v * v
    det_orig = c_xx * c_yy - c_xy * c_xy
    c_xx = c_xx + AA_BLUR
    c_yy = c_yy + AA_BLUR
    det_blur = c_xx * c_yy - c_xy * c_xy

    if antialiasing:
        # where the 2D covariance overflows (det_orig / det_blur = inf / inf
        # or NaN) the ratio takes its limit, 1, on both sides of the
        # division, so that no NaN reaches the opacity's gradient through
        # the mask below; JAX (preprocess.py:157-158) gives NaN there, and
        # equals this wherever it is finite
        ok = torch.isfinite(det_orig) & torch.isfinite(det_blur) \
            & (det_blur > 0.0)
        one = torch.ones_like(det_blur)
        ratio = torch.where(ok, torch.where(ok, det_orig, one)
                            / torch.where(ok, det_blur, one), one)
        h_scale = torch.sqrt(torch.clamp_min(ratio, 2.5e-5))
        opacities = opacities * h_scale

    det_ok = det_blur > 0.0
    safe_det = torch.where(det_ok, det_blur, torch.ones_like(det_blur))
    inv_det = torch.where(det_ok, 1.0 / safe_det, torch.zeros_like(det_blur))
    conic = torch.stack([c_yy * inv_det, -c_xy * inv_det, c_xx * inv_det],
                        dim=-1)

    # screen-space extent: 3 sigma of the major eigenvalue
    mid = 0.5 * (c_xx + c_yy)
    lambda1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det_blur, 0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(lambda1))

    valid = in_front & det_ok
    if gaussian_mask is not None:
        valid = valid & gaussian_mask
    on_screen = ((mean2d[..., 0] + radius_f >= 0)
                 & (mean2d[..., 0] - radius_f < img_w)
                 & (mean2d[..., 1] + radius_f >= 0)
                 & (mean2d[..., 1] - radius_f < img_h))
    valid = valid & on_screen
    radius = torch.where(valid, radius_f,
                         torch.zeros_like(radius_f)).to(torch.int32)

    # SH -> RGB with a safe norm (NaN-free gradient at dirs == 0)
    dirs = means3d - cam_center.float()[..., None, :]
    dirs = dirs / torch.sqrt((dirs ** 2).sum(-1, keepdim=True) + 1e-12)
    color = sh_to_rgb_clamped(sh_degree, shs.float(), dirs)
    # at degree 0 the colour does not see the cameras: one per render still
    color = color.expand(*mean2d.shape[:-1], 3)

    return ProjectedGaussians(
        mean2d=mean2d, conic=conic, color=color,
        opacity=torch.where(valid, opacities, torch.zeros_like(opacities)),
        depth=depth, radius=radius, valid=valid)


def sort_by_depth(pg: ProjectedGaussians) -> ProjectedGaussians:
    """Stable depth sort of every render's gaussians along the last gaussian
    axis of fields [..., N, ...]; invalid gaussians go to the back."""
    key = torch.where(pg.valid, pg.depth,
                      torch.full_like(pg.depth, float("inf")))
    order = torch.argsort(key, dim=-1, stable=True)
    lead = order.ndim

    def take(t):
        idx = order.reshape(*order.shape, *([1] * (t.ndim - lead)))
        return torch.take_along_dim(t, idx, dim=lead - 1)
    return ProjectedGaussians(*(take(t) for t in pg))
