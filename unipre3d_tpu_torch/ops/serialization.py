"""Space-filling-curve serialization codes (z-order, Hilbert, axis orders).

Port of unipre3d_tpu/ops/serialization.py (``z_order_encode``/``decode``,
``hilbert_encode``/``decode``, ``encode``, ``grid_coord_from_points``):
a point cloud is sorted by the code of its voxel coordinate so that a
sequence model (PCM's Mamba orders, PTv3's patches) sees a spatially
coherent 1D order.

Codes are 3 * depth bits (depth <= 10, so at most 30 bits) with x most
significant in each bit triple, the batch kept as an explicit ``[B, N]``
axis as in the JAX package. The JAX package keeps them in uint32; here
they are int64, whose shifts and bitwise operations every torch build has
(uint32's are missing in many): the values are the same, and so is the
order a sort gives them. Hilbert codes follow Skilling's "Programming the
Hilbert curve" axes-to-transpose algorithm, as the JAX package and the
reference do. Orders: ``z``, ``z-trans``, ``hilbert``, ``hilbert-trans``
(``-trans``: x and y swapped before encoding) and the six axis
permutations ``xyz, xzy, yxz, yzx, zxy, zyx``.
"""

from __future__ import annotations

import torch

MAX_DEPTH = 10

ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans",
          "xyz", "xzy", "yxz", "yzx", "zxy", "zyx")

_PERMS = {
    "xyz": (0, 1, 2), "xzy": (0, 2, 1), "yxz": (1, 0, 2),
    "yzx": (1, 2, 0), "zxy": (2, 0, 1), "zyx": (2, 1, 0),
}


def _swap_xy(grid_coord: torch.Tensor) -> torch.Tensor:
    """[..., (y, x, z)] of [..., (x, y, z)], by slices on the device (an
    index list would be copied from the host, which waits for the copy)."""
    return torch.cat([grid_coord[..., 1:2], grid_coord[..., :1],
                      grid_coord[..., 2:]], -1)


def _check_depth(depth: int) -> None:
    if not (0 < depth <= MAX_DEPTH):
        raise ValueError(f"depth must be in [1, {MAX_DEPTH}], got {depth}")


def z_order_encode(grid_coord: torch.Tensor,
                   depth: int = MAX_DEPTH) -> torch.Tensor:
    """Morton code: [..., 3] ints -> [...] int64. Bit i of x lands at
    3i + 2, of y at 3i + 1, of z at 3i."""
    _check_depth(depth)
    g = grid_coord.long()
    x, y, z = g[..., 0], g[..., 1], g[..., 2]
    code = torch.zeros_like(x)
    for i in range(depth):
        code |= ((x >> i) & 1) << (3 * i + 2)
        code |= ((y >> i) & 1) << (3 * i + 1)
        code |= ((z >> i) & 1) << (3 * i)
    return code


def z_order_decode(code: torch.Tensor, depth: int = MAX_DEPTH) -> torch.Tensor:
    """Inverse of ``z_order_encode``: [...] -> [..., 3] int32."""
    _check_depth(depth)
    c = code.long()
    x, y, z = (torch.zeros_like(c) for _ in range(3))
    for i in range(depth):
        x |= ((c >> (3 * i + 2)) & 1) << i
        y |= ((c >> (3 * i + 1)) & 1) << i
        z |= ((c >> (3 * i)) & 1) << i
    return torch.stack([x, y, z], -1).int()


def hilbert_encode(grid_coord: torch.Tensor,
                   depth: int = MAX_DEPTH) -> torch.Tensor:
    """3D Hilbert index of voxel coordinates in [0, 2^depth): [..., 3] ->
    [...] int64 in [0, 2^(3 depth))."""
    _check_depth(depth)
    g = grid_coord.long()
    X = [g[..., 0], g[..., 1], g[..., 2]]
    n = 3
    # axes -> transpose (Skilling), one bit plane at a time
    Q = 1 << (depth - 1)
    while Q > 1:
        P = Q - 1
        for i in range(n):
            hi = (X[i] & Q) != 0
            t = (X[0] ^ X[i]) & P
            x0_inv, x0_exc, xi_exc = X[0] ^ P, X[0] ^ t, X[i] ^ t
            X[0] = torch.where(hi, x0_inv, x0_exc)
            if i != 0:
                X[i] = torch.where(hi, X[i], xi_exc)
        Q >>= 1
    # Gray encode
    for i in range(1, n):
        X[i] = X[i] ^ X[i - 1]
    t = torch.zeros_like(X[0])
    Q = 1 << (depth - 1)
    while Q > 1:
        t = torch.where((X[n - 1] & Q) != 0, t ^ (Q - 1), t)
        Q >>= 1
    for i in range(n):
        X[i] = X[i] ^ t
    # interleave: bit b of X[i] -> code bit 3b + (2 - i)
    code = torch.zeros_like(X[0])
    for b in range(depth):
        for i in range(n):
            code |= ((X[i] >> b) & 1) << (n * b + (n - 1 - i))
    return code


def hilbert_decode(code: torch.Tensor, depth: int = MAX_DEPTH) -> torch.Tensor:
    """Inverse Hilbert: [...] -> [..., 3] int32."""
    _check_depth(depth)
    c = code.long()
    n = 3
    X = [torch.zeros_like(c) for _ in range(n)]
    for b in range(depth):
        for i in range(n):
            X[i] |= ((c >> (n * b + (n - 1 - i))) & 1) << b
    # Gray decode by H ^ (H / 2)
    t = X[n - 1] >> 1
    for i in range(n - 1, 0, -1):
        X[i] = X[i] ^ X[i - 1]
    X[0] = X[0] ^ t
    # undo excess work
    Q = 2
    while Q != (1 << depth):
        P = Q - 1
        for i in range(n - 1, -1, -1):
            hi = (X[i] & Q) != 0
            tt = (X[0] ^ X[i]) & P
            x0_inv, x0_exc, xi_exc = X[0] ^ P, X[0] ^ tt, X[i] ^ tt
            X[0] = torch.where(hi, x0_inv, x0_exc)
            if i != 0:
                X[i] = torch.where(hi, X[i], xi_exc)
        Q <<= 1
    return torch.stack(X, -1).int()


def encode(grid_coord: torch.Tensor, order: str = "z",
           depth: int = MAX_DEPTH) -> torch.Tensor:
    """The serialization code of one order: [..., 3] non-negative ints
    < 2^depth -> [...] int64."""
    if order == "z":
        return z_order_encode(grid_coord, depth)
    if order == "z-trans":
        return z_order_encode(_swap_xy(grid_coord), depth)
    if order == "hilbert":
        return hilbert_encode(grid_coord, depth)
    if order == "hilbert-trans":
        return hilbert_encode(_swap_xy(grid_coord), depth)
    if order in _PERMS:
        p = _PERMS[order]
        g = grid_coord.long()
        return (g[..., p[0]] << (2 * depth)) | (g[..., p[1]] << depth) \
            | g[..., p[2]]
    raise ValueError(f"unknown serialization order: {order}")


def grid_coord_from_points(points: torch.Tensor, grid_size: float,
                           depth: int = MAX_DEPTH) -> torch.Tensor:
    """Voxel coordinates anchored at each cloud's minimum, clipped to the
    depth's range: points [B, N, 3] -> [B, N, 3] int32. Divides by a tensor:
    a division by a Python float runs as a product with its reciprocal on
    CUDA and would move points across voxel boundaries."""
    mins = points.amin(-2, keepdim=True)
    g = torch.floor((points - mins) / points.new_tensor(grid_size)).int()
    return g.clamp(0, (1 << depth) - 1)
