"""Scale-adaptive 2D->3D feature fusion, object level.

Port of unipre3d_tpu/models/fusion.py: project the point-token centres into
the conditioning view, z-buffer them per pixel (a scatter-min), gather the
image feature at each surviving pixel, concatenate with the point features
and run the fusion MLP.

Axis convention (kept from the reference): the *x* projection indexes image
rows, i.e. features are read at ``image_features[b, :, x, y]`` and bounds
are ``x < H``, ``y < W``.
"""

from __future__ import annotations

import torch


def project_points_to_image(center: torch.Tensor, c2w: torch.Tensor,
                            intrinsic: torch.Tensor):
    """center [B, N, 3]; c2w [B, 4, 4] transposed camera-to-world;
    intrinsic [3, 4] -> (pix [B, N, 2] rounded int64, depth [B, N])."""
    B, N, _ = center.shape
    hom = torch.cat([center, torch.ones(B, N, 1, dtype=center.dtype,
                                        device=center.device)], dim=-1)
    w2c = torch.linalg.inv(c2w.transpose(-1, -2))
    cam_pts = torch.einsum("bij,bnj->bni", w2c, hom)
    z = cam_pts[..., 2]
    px = cam_pts[..., 0] * intrinsic[0, 0] / z + intrinsic[0, 2]
    py = cam_pts[..., 1] * intrinsic[1, 1] / z + intrinsic[1, 2]
    pix = torch.round(torch.stack([px, py], dim=-1)).long()
    return pix, z


def feature_fusion_gather(center, image_features, c2w, intrinsic,
                          image_proj=None) -> torch.Tensor:
    """Occlusion-aware per-point image features: center [B, N, 3],
    image_features [B, C, H, W], c2w [B, 4, 4] (or [B, V, 4, 4], first view
    used), intrinsic [3, 4] -> [B, N, C'] (zero for occluded or out-of-view
    points). ``image_proj`` (optional) maps the N gathered rows (the
    trainable per-pixel affine + 1x1 conv, applied after the gather)."""
    if c2w.ndim == 4:
        c2w = c2w[:, 0]
    B, N = center.shape[:2]
    C, H, W = image_features.shape[1:]

    pix, depth = project_points_to_image(center, c2w, intrinsic)
    x, y = pix[..., 0], pix[..., 1]
    inside = (x >= 0) & (y >= 0) & (x < H) & (y < W) & (depth >= 0)

    # z-buffer: scatter-min of the depth into the pixel grid
    flat_id = y.clamp(0, W - 1) * H + x.clamp(0, H - 1)
    masked_depth = torch.where(inside, depth,
                               torch.full_like(depth, float("inf")))
    min_depth = torch.full((B, H * W), float("inf"), dtype=depth.dtype,
                           device=depth.device)
    min_depth = min_depth.scatter_reduce(1, flat_id, masked_depth, "amin",
                                         include_self=True)
    # exact float equality: the closest point of each pixel wins
    winner = inside & (masked_depth == torch.gather(min_depth, 1, flat_id))

    feats = image_features.reshape(B, C, H * W).transpose(1, 2)  # [B,HW,C]
    rows = x.clamp(0, H - 1) * W + y.clamp(0, W - 1)
    gathered = torch.gather(feats, 1, rows[..., None].expand(-1, -1, C))
    if image_proj is not None:
        gathered = image_proj(gathered)
    return torch.where(winner[..., None], gathered,
                       torch.zeros_like(gathered))


def feature_fusion(x, center, image_features, c2w, intrinsic, fusion_mlp,
                   image_proj=None) -> torch.Tensor:
    """x: tokens [B, N(+1 with CLS), C_pt]; center [B, N, 3]. A leading CLS
    token gets zero image features. -> fusion_mlp([x || mapped])."""
    B, N = center.shape[:2]
    mapped = feature_fusion_gather(center, image_features, c2w, intrinsic,
                                   image_proj)
    if x.shape[1] > N:
        mapped = torch.cat([mapped.new_zeros(B, x.shape[1] - N,
                                             mapped.shape[-1]), mapped], 1)
    return fusion_mlp(torch.cat([x, mapped.to(x.dtype)], dim=-1))
