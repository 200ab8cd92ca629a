"""3D set losses: Chamfer distance and an approximate EMD.

Port of unipre3d_tpu/ops/losses3d.py: both reduce the dense pairwise
distance matrix (``point_ops.square_distance``), differentiable through
autograd. The EMD is an entropic Sinkhorn of ``iters`` iterations over
``exp(-d / eps)``; it returns the transport-weighted mean distance.
"""

from __future__ import annotations

from typing import Tuple

import torch

from unipre3d_tpu_torch.ops.point_ops import square_distance


def chamfer_distance(xyz1: torch.Tensor, xyz2: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xyz1 [B, N, 3], xyz2 [B, M, 3] -> (dist1 [B, N], dist2 [B, M]): the
    least squared distance of each point to the other set."""
    d2 = square_distance(xyz1, xyz2)
    return d2.min(2).values, d2.min(1).values


def chamfer_loss(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    d1, d2 = chamfer_distance(xyz1, xyz2)
    return d1.mean() + d2.mean()


def emd_approx(xyz1: torch.Tensor, xyz2: torch.Tensor, eps: float = 0.02,
               iters: int = 50) -> torch.Tensor:
    """Approximate Earth Mover's Distance: xyz1, xyz2 [B, N, 3] (equal N)
    -> [B]."""
    B, N, _ = xyz1.shape
    d = torch.sqrt(square_distance(xyz1, xyz2).clamp_min(1e-12))
    K = torch.exp(-d / eps)
    u = torch.ones(B, N, dtype=xyz1.dtype, device=xyz1.device)
    v = torch.ones_like(u)
    for _ in range(iters):
        u = 1.0 / (torch.einsum("bnm,bm->bn", K, v) + 1e-12)
        v = 1.0 / (torch.einsum("bnm,bn->bm", K, u) + 1e-12)
    T = u[:, :, None] * K * v[:, None, :]
    T = T / T.sum(2, keepdim=True).clamp_min(1e-12)
    return (T * d).sum(2).mean(1)
