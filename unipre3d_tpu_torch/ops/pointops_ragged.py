"""Offset-based (ragged) point ops over concatenated clouds.

Port of unipre3d_tpu/ops/pointops_ragged.py: clouds of several scenes
concatenated into one [N_total, 3] array with a cumulative ``offset``
vector. A per-point batch id masks the pairwise distances so that no query
crosses a scene boundary.

Rules held to JAX's:

* the masked squared distances are ``|q|^2 + |s|^2 - 2 q.s`` in float32,
  the product without TF32 (JAX computes it at ``Precision.HIGHEST``);
* ``knn_query`` orders by (distance, index): ``jax.lax.top_k`` gives the
  lower index among equal distances, ``torch.topk`` promises no order, so
  the port takes a stable sort;
* ``farthest_point_sampling`` takes ``argmax``'s first index.
"""

from __future__ import annotations

from typing import Tuple

import torch


def offset2batch(offset: torch.Tensor, n_total: int) -> torch.Tensor:
    """Cumulative offsets [B] -> per-point batch id [n_total] int32."""
    idx = torch.arange(n_total, device=offset.device)
    return (idx[:, None] >= offset[None, :]).sum(1).to(torch.int32)


def _masked_d2(query, q_batch, support, s_batch):
    """Pairwise squared distances, cross-scene pairs at +inf."""
    query, support = query.float(), support.float()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dot = query @ support.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    d2 = (query ** 2).sum(1)[:, None] + (support ** 2).sum(1)[None] - 2.0 * dot
    same = q_batch[:, None] == s_batch[None, :]
    return torch.where(same, d2, torch.full_like(d2, float("inf")))


def _d2(support, s_offset, query, q_offset):
    qb = offset2batch(q_offset, query.shape[0])
    sb = offset2batch(s_offset, support.shape[0])
    return _masked_d2(query[:, :3], qb, support[:, :3], sb)


def knn_query(nsample: int, support: torch.Tensor, s_offset: torch.Tensor,
              query: torch.Tensor, q_offset: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ragged kNN: (idx [Nq, k] int32 flat support indices, dist [Nq, k]),
    ascending, ties to the lower index, never across offsets."""
    d2 = _d2(support, s_offset, query, q_offset)
    srt = torch.sort(d2, dim=1, stable=True)
    idx = srt.indices[:, :nsample].to(torch.int32)
    return idx, torch.sqrt(srt.values[:, :nsample].clamp_min(0.0))


def ball_query(radius: float, nsample: int, support: torch.Tensor,
               s_offset: torch.Tensor, query: torch.Tensor,
               q_offset: torch.Tensor) -> torch.Tensor:
    """Ragged fixed-radius query: the first ``nsample`` in-radius support
    indices of each query in index order, padded with the first hit (0
    where there is none)."""
    d2 = _d2(support, s_offset, query, q_offset)
    inball = d2 < radius * radius
    Ns = support.shape[0]
    iota = torch.arange(Ns, device=d2.device).expand_as(d2)
    key = torch.where(inball, iota, Ns + iota)
    srt = torch.sort(key, dim=1).indices.to(torch.int32)[:, :nsample]
    count = inball.sum(1, dtype=torch.int32)
    first = torch.where(count[:, None] > 0, srt[:, :1],
                        torch.zeros_like(srt[:, :1]))
    slot = torch.arange(srt.shape[1], device=d2.device)[None, :]
    return torch.where(slot < count[:, None], srt, first)


def grouping(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Flat gather: feats [N, C], idx [M, K] -> [M, K, C]."""
    return feats[idx.reshape(-1).long()].reshape(*idx.shape, feats.shape[-1])


def interpolation(support: torch.Tensor, s_offset: torch.Tensor,
                  query: torch.Tensor, q_offset: torch.Tensor,
                  feats: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Ragged k-NN inverse-squared-distance interpolation: feats [Ns, C]
    -> [Nq, C]."""
    idx, dist = knn_query(k, support, s_offset, query, q_offset)
    w = 1.0 / dist.clamp_min(1e-8) ** 2
    w = w / w.sum(1, keepdim=True)
    return (grouping(feats, idx) * w[..., None]).sum(1)


def farthest_point_sampling(coords: torch.Tensor, offset: torch.Tensor,
                            new_offset: torch.Tensor, n_max: int
                            ) -> torch.Tensor:
    """Ragged FPS: for each scene, ``new_offset``'s count of flat indices
    by FPS from the scene's first point, padded to ``n_max`` with that
    first index -> [B, n_max] int32."""
    n_total = coords.shape[0]
    dev = coords.device
    batch = offset2batch(offset, n_total)
    zero = torch.zeros(1, dtype=offset.dtype, device=dev)
    starts = torch.cat([zero, offset[:-1]])
    counts_out = new_offset - torch.cat([zero.to(new_offset.dtype),
                                         new_offset[:-1]])
    xyz = coords[:, :3].float()
    out = []
    for b in range(offset.shape[0]):
        in_scene = batch == b
        big = torch.where(in_scene, 0.0, float("inf"))
        start = starts[b].long()
        min_d = torch.full((n_total,), float("inf"), device=dev)
        last = start
        picks = [start]
        for _ in range(n_max - 1):
            d = ((xyz - xyz[last]) ** 2).sum(1) + big
            min_d = torch.minimum(min_d, d)
            last = torch.argmax(torch.where(in_scene, min_d,
                                            torch.full_like(min_d, -1.0)))
            picks.append(last)
        picks = torch.stack(picks).to(torch.int32)
        valid = torch.arange(n_max, device=dev) < counts_out[b]
        out.append(torch.where(valid, picks, start.to(torch.int32)))
    return torch.stack(out)
