"""Precomputed batch geometry of the SparseUNet scene backbone.

Port of unipre3d_tpu/models/scene_geometry.py. Every index structure of
one SpUNet forward (canonical voxel order, PointFusion pixel-voxel merge,
per-level stride-2 parent maps, submanifold neighbour tables) is a pure
function of the batch geometry, independent of features and parameters.
The trainer builds it once per batch, before the step, and hands it in the
batch. A loop over the scenes replaces the JAX package's ``vmap``; every
field is integer or boolean (or the world coords the merge permutes), and
equals the JAX one exactly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from unipre3d_tpu_torch.ops import sparse as sp


class SpUNetGeometry(NamedTuple):
    """All index structures of one SpUNet forward, batched [B, ...]:
    order0 [B, M] canonical permutation of the input rows; mask0 [B, M];
    nbr5 [B, M, 125] stem table; pix_rep [B, P] pixel row feeding each fused
    voxel (-1) and merge_order [B, M+P] (None without fusion); world
    [B, Mf, 3] and fine_mask [B, Mf] of the final set; nbr3_fine
    [B, Mf, 27]; downs per stage; nbrs per stage [B, Mc, 27]."""
    order0: torch.Tensor
    mask0: torch.Tensor
    nbr5: torch.Tensor
    pix_rep: Optional[torch.Tensor]
    merge_order: Optional[torch.Tensor]
    world: torch.Tensor
    fine_mask: torch.Tensor
    nbr3_fine: torch.Tensor
    downs: Tuple[sp.DownStructure, ...]
    nbrs: Tuple[torch.Tensor, ...]


def _no_feats(m: int, device) -> torch.Tensor:
    return torch.zeros(m, 0, device=device)


def _geometry_one(grid_coord, mask, coord, min_coord, unproj, *,
                  grid_size: float, pixel_capacity: int,
                  level_caps: Sequence[int], use_fusion: bool
                  ) -> SpUNetGeometry:
    """Geometry of ONE scene (unbatched fields), for the gather executor
    (the JAX package's ``conv_impl="gather"``)."""
    dev = grid_coord.device
    M = grid_coord.shape[0]
    offs3 = sp.kernel_offsets(3)

    order0 = sp._argsort(sp.pack_code(grid_coord, mask))
    coords_c, mask0, world_c = grid_coord[order0], mask[order0], coord[order0]
    nbr5 = sp.find_neighbors(
        sp.SparseVoxels(coords_c, _no_feats(M, dev), mask0),
        sp.kernel_offsets(5))

    pix_rep = merge_order = None
    if use_fusion:
        # PointFusion: bbox-filter the unprojected pixels to the valid 3D
        # cloud's extent, voxelize at the shared min_coord, concat
        pix_world = unproj[..., :3].reshape(-1, 3)
        pix_valid = unproj[..., 3].reshape(-1) > 0
        big = torch.tensor(1e9, device=dev)
        lo = torch.where(mask0[:, None], world_c, big).amin(0)
        hi = torch.where(mask0[:, None], world_c, -big).amax(0)
        pix_valid = pix_valid & ((pix_world >= lo) & (pix_world <= hi)).all(-1)
        sv2d, pix_rep, world2d = sp.voxelize(
            pix_world, _no_feats(pix_world.shape[0], dev), pix_valid,
            grid_size, min_coord, pixel_capacity)
        merged, merge_order = sp.merge_voxel_sets(
            coords_c, _no_feats(M, dev), mask0, sv2d.coords,
            _no_feats(pixel_capacity, dev), sv2d.mask)
        fine_coords, fine_mask = merged.coords, merged.mask
        world = torch.cat([world_c, world2d])[merge_order]
    else:
        fine_coords, fine_mask, world = coords_c, mask0, world_c

    nbr3_fine = sp.find_neighbors(
        sp.SparseVoxels(fine_coords, _no_feats(fine_coords.shape[0], dev),
                        fine_mask), offs3)
    downs, nbrs = [], []
    cur_coords, cur_mask = fine_coords, fine_mask
    for cap in level_caps:
        ds = sp.downsample_structure(cur_coords, cur_mask, cap)
        nbrs.append(sp.find_neighbors(
            sp.SparseVoxels(ds.coords, _no_feats(cap, dev), ds.mask), offs3))
        downs.append(ds)
        cur_coords, cur_mask = ds.coords, ds.mask
    return SpUNetGeometry(
        order0=order0, mask0=mask0, nbr5=nbr5, pix_rep=pix_rep,
        merge_order=merge_order, world=world, fine_mask=fine_mask,
        nbr3_fine=nbr3_fine, downs=tuple(downs), nbrs=tuple(nbrs))


def _stack(items):
    """Stack a list of per-scene (nested) tuples of tensors along dim 0."""
    first = items[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    parts = [_stack(list(x)) for x in zip(*items)]
    return type(first)(*parts) if hasattr(first, "_fields") else tuple(parts)


def build_spunet_geometry(data, unprojected, *, grid_size: float,
                          pixel_capacity: int, level_divs: Sequence[int],
                          n_stages: int, use_fusion: bool) -> SpUNetGeometry:
    """Batched SpUNet geometry. data: dict with ``grid_coord`` [B, M, 3],
    ``mask`` [B, M], ``coord`` [B, M, 3], ``min_coord`` [B, 3];
    unprojected [B, V, H, W, 4] (ignored without fusion). Level capacities
    are ``max(M // level_divs[s], 64)`` of the pre-merge M, as in the JAX
    package."""
    M = data["mask"].shape[1]
    level_caps = tuple(max(M // int(level_divs[s]), 64)
                       for s in range(n_stages))
    scenes = []
    for b in range(data["mask"].shape[0]):
        scenes.append(_geometry_one(
            data["grid_coord"][b], data["mask"][b], data["coord"][b],
            data["min_coord"][b] if use_fusion else None,
            unprojected[b] if use_fusion else None,
            grid_size=grid_size, pixel_capacity=pixel_capacity,
            level_caps=level_caps, use_fusion=use_fusion))
    return _stack(scenes)
