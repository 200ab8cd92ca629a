"""Batched point-cloud primitives: FPS, kNN, ball query, grouping,
three-NN interpolation.

Port of unipre3d_tpu/ops/point_ops.py (``square_distance``,
``furthest_point_sample``, ``knn``, ``ball_query``, ``index_points``,
``group_points``, ``three_nn``, ``three_interpolate``,
``subsample_group``) with the same pointnet2-CUDA semantics:

* FPS seeds with index 0 and picks the point maximizing the min-distance to
  the selected set; ties go to the first index. Distances are formed as
  ``|x|^2 - 2 x.last + |last|^2`` exactly as the JAX version does, since a
  near-tie that flips one centre changes everything downstream.
* FPS, kNN and ``three_nn`` take every channel of their points: PointMLP
  groups over 4 channels, the gravity channel included;
* ``ball_query`` returns the first ``nsample`` in-radius indices in point
  order (strict ``d2 < r^2``), padding with the first one found; a centre
  with no neighbour gets index 0;
* ``three_interpolate`` weighs the 3 nearest points by 1/(d + 1e-8) on the
  *squared* distances ``knn`` returns, as the JAX version does.

FPS is a plain loop of tensor ops over the samples.
"""

from __future__ import annotations

import torch

from unipre3d_tpu_torch.telemetry import span


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances: src [B, N, C], dst [B, M, C] -> [B, N, M]."""
    dist = -2.0 * torch.einsum("bnc,bmc->bnm", src, dst)
    dist = dist + (src.float() ** 2).sum(-1, keepdim=True)
    return dist + (dst.float() ** 2).sum(-1)[:, None, :]


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Iterative farthest point sampling: xyz [B, N, C] (any C) ->
    [B, npoint] int64 indices; the first index is always 0."""
    B, N, C = xyz.shape
    with span("point_ops/fps"):
        xyz = xyz.float()
        sq_norm = (xyz * xyz).sum(-1)                               # [B, N]
        min_dist = torch.full((B, N), 1e10, device=xyz.device)
        idx = torch.zeros(B, npoint, dtype=torch.long, device=xyz.device)
        last = torch.zeros(B, dtype=torch.long, device=xyz.device)
        for i in range(1, npoint):
            p = torch.gather(xyz, 1, last[:, None, None].expand(B, 1, C))
            p_sq = torch.gather(sq_norm, 1, last[:, None])             # [B,1]
            d = sq_norm - 2.0 * torch.einsum("bnc,bmc->bn", xyz, p) + p_sq
            min_dist = torch.minimum(min_dist, d)
            last = torch.argmax(min_dist, dim=-1)
            idx[:, i] = last
    return idx


def knn(query: torch.Tensor, support: torch.Tensor, k: int):
    """k nearest support points per query: -> (dists [B, M, k] ascending,
    idx [B, M, k])."""
    d2 = square_distance(query, support)
    dist, idx = torch.topk(d2, k, dim=-1, largest=False, sorted=True)
    return dist, idx


def ball_query(radius: float, nsample: int, support: torch.Tensor,
               query: torch.Tensor) -> torch.Tensor:
    """support [B, N, 3], query [B, M, 3] -> idx [B, M, nsample]."""
    N = support.shape[1]
    d2 = square_distance(query, support)                        # [B, M, N]
    inball = d2 < radius * radius
    iota = torch.arange(N, device=support.device)
    # stable compaction: in-ball indices first, in index order
    order_key = torch.where(inball, iota, N + iota)
    sorted_idx = torch.argsort(order_key, dim=-1)[..., :nsample]
    count = inball.sum(-1, keepdim=True)                        # [B, M, 1]
    first = torch.where(count > 0, sorted_idx[..., 0:1],
                        torch.zeros_like(sorted_idx[..., 0:1]))
    slot = torch.arange(sorted_idx.shape[-1], device=support.device)
    return torch.where(slot < count, sorted_idx, first)


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather: points [B, N, C], idx [B, ...] -> [B, ..., C]
    (differentiable through the gather)."""
    B, C = points.shape[0], points.shape[-1]
    flat = idx.reshape(B, -1)
    out = torch.gather(points, 1, flat[..., None].expand(-1, -1, C))
    return out.reshape(*idx.shape, C)


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C], idx [B, M, K] -> [B, M, K, C]."""
    return index_points(points, idx)


def three_nn(query: torch.Tensor, support: torch.Tensor):
    """The 3 nearest support points of each query: -> (squared distances
    [B, M, 3], idx [B, M, 3])."""
    return knn(query, support, 3)


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      dists: torch.Tensor) -> torch.Tensor:
    """Inverse-distance weighted interpolation: features [B, N, C], idx and
    dists [B, M, 3] -> [B, M, C]; weights 1/(d + 1e-8), normalized."""
    w = 1.0 / (dists + 1e-8)
    w = w / w.sum(-1, keepdim=True)
    return (index_points(features, idx) * w[..., None]).sum(2)


def subsample_group(pts: torch.Tensor, num_groups: int, group_size: int,
                    radius: float = 0.1, use_knn: bool = False):
    """FPS centres + neighbourhoods relative to them: pts [B, N, 3] ->
    (neighborhood [B, G, K, 3], centers [B, G, 3])."""
    fps_idx = furthest_point_sample(pts, num_groups)
    centers = index_points(pts, fps_idx)
    if use_knn:
        _, idx = knn(centers, pts, group_size)
    else:
        idx = ball_query(radius, group_size, pts, centers)
    grouped = index_points(pts, idx)
    return grouped - centers[:, :, None, :], centers
