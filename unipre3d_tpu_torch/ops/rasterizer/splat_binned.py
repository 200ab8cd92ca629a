"""Binned splat: duplicate-and-sort by (tile, depth), per-tile render.

Port of unipre3d_tpu/ops/rasterizer/pallas_splat_binned.py, the structure
of the CUDA rasterizer the upstream UniPre3D trains with
(diff_gaussian_rasterization: duplicate with keys, sort by (tile, depth),
per-tile ranges, front-to-back blend). All R = B*V renders of a step go
through one forward and one backward launch of the hand-written CUDA
kernels in ``csrc/splat_binned.cu``; beside them sit their plain PyTorch
versions (``binned_fwd_ref``, ``binned_bwd_ref``), which the CPU takes and
which the kernels are held against on the card.

Prep (torch, ``prep_duplicates``): the gaussians of each render are
stably depth-sorted once; each valid gaussian emits one duplicate per tile
of its clamped 3-sigma bbox within ``dup_budget`` slots per render (the
duplicates of the highest depth ranks are dropped first); the duplicates
are sorted by one int64 key (render, tile, depth rank) and each tile's
range of the sorted list is its segment ``seg[b] .. seg[b+1]``. The JAX
package pads every segment to a 1024 boundary for its TPU block layout; a
CUDA block reads its own range, so the port keeps the raw list.

Semantics are the JAX kernels':
* only the first ``maxn`` = ceil(max_per_tile / 1024) * 1024 duplicates of
  a tile are composited (the farthest are dropped);
* a pair is skipped at ``power > 0`` or ``alpha < 1/255``; alpha <= 0.99;
  blending is in log space, a duplicate contributing iff log T after it
  stays >= log(1e-4);
* chunk re-arm: a tile's list is walked in chunks of 1024 and only
  contributing log(1 - alpha) are carried, so a pixel that stopped inside
  one chunk starts the next at its last contributing T and can take
  small-alpha duplicates there again;
* backward: ``tot = sum_c g (out - bg T_final)`` from the forward's
  outputs; per duplicate, s_i = tot - inclusive prefix of w (g . c) and
  dL/dalpha = (g . c) T_before - (s_i + T_final (g . bg)) / max(1 - alpha,
  1e-6), through alpha only where it is < 0.99; each duplicate's row sums
  its tile's pixels; per-gaussian gradients are an ``index_add_`` of the
  rows (the JAX package's scatter-add and unpermute in one).

Where the port differs from the JAX package on purpose: a duplicate
dropped past a tile's cap gets a zero gradient row (the derivative of the
forward that drops it). The JAX backward never writes those rows
(``out_blk_map``, pallas_splat_binned.py:404-411) and scatter-adds the
uninitialised memory into real gaussians (ROADMAP.md section C).

The walk is sequential per pixel (each kernel thread owns a pixel), and
the plain version walks in the same order with the same operations, so the
two take the same stop decisions and agree on T bit for bit. T before a
duplicate is ``exp(log T)`` of the running sum (the JAX kernel's
``exp(cum - log1m)`` is the same value up to rounding).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from unipre3d_tpu_torch import kernels
from unipre3d_tpu_torch.ops.rasterizer.pack import (
    ALPHA_MAX, ALPHA_MIN, LOG_T_EPS)

CHUNK = 1024       # duplicates of a tile per chunk (the T re-arm boundary)
DUP_FACTOR = 6     # default duplicate budget: 6 slots per gaussian
MAX_TILE_PIXELS = 256

# the kernels' C entry points, with their launch counts
BINNED_FWD = kernels.CudaKernel("splat_binned", "binned_splat_fwd", 5, 7)
BINNED_BWD = kernels.CudaKernel("splat_binned", "binned_splat_bwd", 7, 7)


def default_dup_budget(n: int, n_tiles: int) -> int:
    """DUP_FACTOR slots per gaussian, at most n * n_tiles, rounded up to a
    multiple of 1024 (per render)."""
    return -(-min(DUP_FACTOR * n, n * n_tiles) // CHUNK) * CHUNK


def max_per_tile_cap(max_per_tile: int) -> int:
    """The per-tile cap the kernels apply: whole 1024-chunks."""
    return -(-int(max_per_tile) // CHUNK) * CHUNK


class Duplicates(NamedTuple):
    """The sorted duplicate list of R renders.

    gid  [D] int64: flat gaussian (r * N + original id) of each duplicate
    rank [D] int64: its depth rank within its render
    seg  [R * n_tiles + 1] int32: tile b's duplicates are seg[b]..seg[b+1]
    d_ids [R, N] int64: original gaussian id of each depth rank
    span_sum [R] int64: duplicates wanted before the budget
    """
    gid: torch.Tensor
    rank: torch.Tensor
    seg: torch.Tensor
    d_ids: torch.Tensor
    span_sum: torch.Tensor


def prep_duplicates(mean2d, radius, depth, valid, img_h: int, img_w: int,
                    tile_h: int, tile_w: int, dup_budget: int) -> Duplicates:
    """Duplicate-and-sort of R renders (no gradient: indices only).
    mean2d [R, N, 2], radius/depth/valid [R, N]."""
    R, N = depth.shape
    dev = depth.device
    ty, tx = img_h // tile_h, img_w // tile_w
    n_tiles = ty * tx
    d_ids = torch.sort(depth.float(), dim=1, stable=True).indices   # [R, N]

    def by_rank(a):
        return torch.gather(a, 1, d_ids)

    r = by_rank(radius).float()
    gx, gy = by_rank(mean2d[..., 0].float()), by_rank(mean2d[..., 1].float())

    def tile_of(v, size, n):
        return torch.clamp(torch.floor(v / size), 0, n - 1).long()

    tx0, tx1 = tile_of(gx - r, tile_w, tx), tile_of(gx + r, tile_w, tx)
    ty0, ty1 = tile_of(gy - r, tile_h, ty), tile_of(gy + r, tile_h, ty)
    sx = tx1 - tx0 + 1
    c = torch.where(by_rank(valid), sx * (ty1 - ty0 + 1),
                    torch.zeros_like(sx))                           # [R, N]
    offs = torch.cumsum(c, 1) - c              # exclusive, per render
    kept = torch.minimum(c, (dup_budget - offs).clamp(min=0)).reshape(-1)
    n_dups = int(kept.sum())                   # host sync: the list's size
    owner = torch.repeat_interleave(torch.arange(R * N, device=dev), kept,
                                    output_size=n_dups)
    k = torch.arange(n_dups, device=dev) - (torch.cumsum(kept, 0) - kept)[owner]
    sx_o = sx.reshape(-1)[owner]
    tile = (ty0.reshape(-1)[owner] + k // sx_o) * tx \
        + tx0.reshape(-1)[owner] + k % sx_o
    rr = owner // N
    key = (rr * n_tiles + tile) * N + owner % N
    key, perm = torch.sort(key)
    owner = owner[perm]
    rank = owner % N
    seg = torch.searchsorted(key // N, torch.arange(
        R * n_tiles + 1, device=dev)).to(torch.int32)
    gid = (owner // N) * N + d_ids.reshape(-1)[owner]
    return Duplicates(gid=gid, rank=rank, seg=seg, d_ids=d_ids,
                      span_sum=c.sum(1))


def _tile_pixels(R, img_h, img_w, tile_h, tile_w, device):
    """Pixel coords of every (render, tile) block: (px, py) each
    [R * n_tiles, P] float, and the flat pixel index [R * n_tiles, P]."""
    tx = img_w // tile_w
    n_tiles = (img_h // tile_h) * tx
    t = torch.arange(tile_h * tile_w, device=device)
    tiles = torch.arange(n_tiles, device=device)[:, None]
    x = (tiles % tx) * tile_w + t % tile_w
    y = (tiles // tx) * tile_h + t // tile_w
    flat = (y * img_w + x).repeat(R, 1)
    return x.float().repeat(R, 1), y.float().repeat(R, 1), flat


def _to_tiles(img, tile_h, tile_w):
    """[R, C, H, W] -> [R * n_tiles, C, P] (tile blocks of the image)."""
    R, C, H, W = img.shape
    t = img.reshape(R, C, H // tile_h, tile_h, W // tile_w, tile_w)
    return t.permute(0, 2, 4, 1, 3, 5).reshape(-1, C, tile_h * tile_w)


def _from_tiles(t, R, H, W, tile_h, tile_w):
    """Inverse of :func:`_to_tiles`."""
    C = t.shape[1]
    img = t.reshape(R, H // tile_h, W // tile_w, C, tile_h, tile_w)
    return img.permute(0, 3, 1, 4, 2, 5).reshape(R, C, H, W)


# --------------------------------------------------------------------------
# plain PyTorch versions (the CPU path; the reference for the kernels)
# --------------------------------------------------------------------------

def _walk(seg, table, px, py, maxn):
    """The kernels' walk, vectorised over (render, tile, pixel): yields per
    duplicate position j of every tile's list (j, column of each tile
    [n_blocks] (the dump column D where the tile's list has ended), its
    table rows [9, n_blocks], and the pixel terms (alpha, e, dx, dy,
    contrib, t_before, log T after)); ``state`` carries log T."""
    start = seg[:-1].long()
    count = (seg[1:] - seg[:-1]).long().clamp(max=maxn)
    dump = table.shape[1] - 1
    log_t = torch.zeros_like(px)
    stopped = torch.zeros_like(px, dtype=torch.bool)
    zero = torch.zeros((), device=px.device)
    for j in range(int(count.max()) if count.numel() else 0):
        if j % CHUNK == 0:        # chunk re-arm
            stopped = torch.zeros_like(stopped)
        live = (j < count)[:, None]
        col = torch.where(live[:, 0], start + j, torch.full_like(start, dump))
        g = table[:, col]                                       # [9, nb]
        dx = g[0][:, None] - px
        dy = g[1][:, None] - py
        power = -0.5 * (g[2][:, None] * dx * dx + g[4][:, None] * dy * dy) \
            - g[3][:, None] * dx * dy
        e = torch.exp(power)
        a = torch.clamp_max(g[5][:, None] * e, ALPHA_MAX)
        skip = (power > 0.0) | (a < ALPHA_MIN) | ~live
        alpha = torch.where(skip, zero, a)
        incl = log_t + torch.log1p(-alpha)
        ok = incl >= LOG_T_EPS
        contrib = ~skip & ~stopped & ok
        stopped = stopped | (~skip & ~ok)
        t_before = torch.exp(log_t)
        log_t = torch.where(contrib, incl, log_t)
        yield col, g, (alpha, e, dx, dy, skip, contrib, t_before), log_t


def _padded(table):
    """table [9, D] plus a zero dump column (opacity 0: always skipped)."""
    return torch.nn.functional.pad(table, (0, 1))


def binned_fwd_ref(seg, table, bg, R: int, img_h: int, img_w: int,
                   tile_h: int, tile_w: int, maxn: int):
    """seg [R*n_tiles+1] int32, table [9, D], bg [3] -> (out [R,3,H,W],
    log T final [R,H,W])."""
    px, py, _ = _tile_pixels(R, img_h, img_w, tile_h, tile_w, table.device)
    rgb = torch.zeros(px.shape[0], 3, px.shape[1], device=table.device)
    log_t = torch.zeros_like(px)
    for _, g, (alpha, _, _, _, _, contrib, t_before), log_t in _walk(
            seg, _padded(table), px, py, maxn):
        w = torch.where(contrib, alpha * t_before, torch.zeros_like(alpha))
        rgb = rgb + w[:, None, :] * g[6:9].t()[:, :, None]
    out = rgb + bg.reshape(1, 3, 1) * torch.exp(log_t)[:, None, :]
    return (_from_tiles(out, R, img_h, img_w, tile_h, tile_w),
            _from_tiles(log_t[:, None], R, img_h, img_w, tile_h, tile_w)[:, 0])


def binned_bwd_ref(seg, table, bg, logt, tot, g_out, R: int, img_h: int,
                   img_w: int, tile_h: int, tile_w: int, maxn: int):
    """Analytic backward: + logt/tot [R,H,W], g_out [R,3,H,W] -> dgrad
    [9, D], one row per duplicate (zero for those never composited)."""
    px, py, _ = _tile_pixels(R, img_h, img_w, tile_h, tile_w, table.device)
    gp = _to_tiles(g_out, tile_h, tile_w)                       # [nb, 3, P]
    tot_t = _to_tiles(tot[:, None], tile_h, tile_w)[:, 0]
    tfin = torch.exp(_to_tiles(logt[:, None], tile_h, tile_w)[:, 0])
    tb = tfin * (bg.reshape(1, 3, 1) * gp).sum(1)
    u_incl = torch.zeros_like(px)
    D = table.shape[1]
    dgrad = torch.zeros(9, D + 1, device=table.device)
    zero = torch.zeros((), device=table.device)
    for col, g, (alpha, e, dx, dy, skip, contrib, t_before), _ in _walk(
            seg, _padded(table), px, py, maxn):
        w = torch.where(contrib, alpha * t_before, zero)
        cg = (gp * g[6:9].t()[:, :, None]).sum(1)              # [nb, P]
        u_incl = u_incl + w * cg
        one_m = torch.clamp_min(1.0 - alpha, 1e-6)
        dalpha = torch.where(
            contrib, cg * t_before - ((tot_t - u_incl) + tb) / one_m, zero)
        live = ~skip & (alpha < ALPHA_MAX)
        dpow = torch.where(live, dalpha * alpha, zero)
        A, B, C = (g[k][:, None] for k in (2, 3, 4))
        dgrad[:, col] = torch.stack([
            (-dpow * (A * dx + B * dy)).sum(1),
            (-dpow * (C * dy + B * dx)).sum(1),
            (-0.5 * dpow * dx * dx).sum(1),
            (-dpow * dx * dy).sum(1),
            (-0.5 * dpow * dy * dy).sum(1),
            torch.where(live, dalpha * e, zero).sum(1),
            *(gp * w[:, None, :]).sum(2).t(),
        ])
    return dgrad[:, :D]


# --------------------------------------------------------------------------
# wrappers: kernel on CUDA tensors, plain version on CPU tensors
# --------------------------------------------------------------------------

def _check_shapes(seg, table, R, img_h, img_w, tile_h, tile_w, maxn):
    n_tiles = (img_h // tile_h) * (img_w // tile_w)
    if img_h % tile_h or img_w % tile_w or \
            tile_h * tile_w > MAX_TILE_PIXELS or maxn % CHUNK or maxn <= 0:
        raise ValueError(f"binned splat: tiles {tile_h}x{tile_w} must divide "
                         f"{img_h}x{img_w} and hold <= {MAX_TILE_PIXELS} px; "
                         f"maxn {maxn} must be a positive multiple of {CHUNK}")
    kernels.check_tensor("seg", seg, (R * n_tiles + 1,), torch.int32)
    kernels.check_tensor("table", table, (9, table.shape[1]))


def binned_fwd(seg, table, bg, R: int, img_h: int, img_w: int, tile_h: int,
               tile_w: int, maxn: int):
    """Forward: (out [R,3,H,W], log T final [R,H,W])."""
    if not kernels.use_kernel("binned splat", seg, table, bg):
        return binned_fwd_ref(seg, table, bg, R, img_h, img_w, tile_h,
                              tile_w, maxn)
    _check_shapes(seg, table, R, img_h, img_w, tile_h, tile_w, maxn)
    kernels.check_tensor("bg", bg, (3,))
    out = torch.empty(R, 3, img_h, img_w, device=table.device)
    logt = torch.empty(R, img_h, img_w, device=table.device)
    BINNED_FWD(seg.data_ptr(), table.data_ptr(), bg.data_ptr(),
               out.data_ptr(), logt.data_ptr(), table.shape[1], R, img_h,
               img_w, tile_h, tile_w, maxn)
    return out, logt


def binned_bwd(seg, table, bg, logt, tot, g_out, R: int, img_h: int,
               img_w: int, tile_h: int, tile_w: int, maxn: int):
    """Backward: dgrad [9, D] (zero rows for duplicates never composited)."""
    if not kernels.use_kernel("binned splat", seg, table, bg, logt, tot,
                              g_out):
        return binned_bwd_ref(seg, table, bg, logt, tot, g_out, R, img_h,
                              img_w, tile_h, tile_w, maxn)
    _check_shapes(seg, table, R, img_h, img_w, tile_h, tile_w, maxn)
    for name, t, shape in (("bg", bg, (3,)), ("logt", logt, (R, img_h, img_w)),
                           ("tot", tot, (R, img_h, img_w)),
                           ("g_out", g_out, (R, 3, img_h, img_w))):
        kernels.check_tensor(name, t, shape)
    dgrad = torch.zeros_like(table)
    BINNED_BWD(seg.data_ptr(), table.data_ptr(), bg.data_ptr(),
               logt.data_ptr(), tot.data_ptr(), g_out.data_ptr(),
               dgrad.data_ptr(), table.shape[1], R, img_h, img_w, tile_h,
               tile_w, maxn)
    return dgrad


def gaussian_rows(mean2d, conic, color, opacity, valid):
    """The table rows of every gaussian of R renders, [R*N, 9]: mean x, y,
    conic A, B, C, opacity (0 where invalid), r, g, b."""
    R, N = opacity.shape
    opa = torch.where(valid, opacity, torch.zeros_like(opacity))
    return torch.cat([mean2d, conic, opa[..., None], color], -1).reshape(
        R * N, 9).float()


class BinnedSplat(torch.autograd.Function):
    """Per-gaussian rows g9 [R*N, 9] (mean x, y, conic A, B, C, opacity,
    r, g, b) + bg [3] -> images [R, 3, H, W], through the sorted duplicate
    list (gid, seg); forward and backward each one kernel launch on CUDA
    tensors."""

    @staticmethod
    def forward(ctx, g9, bg, gid, seg, R, img_h, img_w, tile_h, tile_w, maxn):
        table = g9[gid].t().contiguous()                       # [9, D]
        out, logt = binned_fwd(seg, table, bg, R, img_h, img_w, tile_h,
                               tile_w, maxn)
        ctx.save_for_backward(table, gid, seg, bg, out, logt)
        ctx.shape = (g9.shape[0], R, img_h, img_w, tile_h, tile_w, maxn)
        return out

    @staticmethod
    def backward(ctx, g_out):
        table, gid, seg, bg, out, logt = ctx.saved_tensors
        n, R, img_h, img_w, tile_h, tile_w, maxn = ctx.shape
        g_out = g_out.contiguous()
        tfin = torch.exp(logt)
        # tot = sum_c g (out - bg T_final): the colour share of dL/dalpha
        tot = (g_out * (out - bg.reshape(1, 3, 1, 1) * tfin[:, None])).sum(1)
        dgrad = binned_bwd(seg, table, bg, logt, tot, g_out, R, img_h, img_w,
                           tile_h, tile_w, maxn)
        dg9 = torch.zeros(n, 9, device=table.device).index_add_(
            0, gid, dgrad.t())
        dbg = torch.einsum("rhw,rchw->c", tfin, g_out)
        return dg9, dbg, None, None, None, None, None, None, None, None


def duplicate_stats(dup: Duplicates, maxn: int) -> dict:
    """Scalar tensors of a duplicate list: ``dups`` kept, ``budget_dropped``
    (wanted past the budget), ``cap_dropped`` (kept but past their tiles'
    cap of ``maxn``, never composited)."""
    counts = (dup.seg[1:] - dup.seg[:-1]).long()
    n = torch.tensor(dup.gid.shape[0], device=counts.device)
    return dict(dups=n, budget_dropped=dup.span_sum.sum() - n,
                cap_dropped=(counts - maxn).clamp(min=0).sum())


def rasterize_projected_binned(mean2d, conic, color, opacity, depth, radius,
                               valid, bg_color, img_h: int, img_w: int,
                               tile_h: int, tile_w: int,
                               max_per_tile: int = 16384,
                               dup_budget: int = None,
                               stats: dict = None) -> torch.Tensor:
    """Rasterize R renders in one launch each way. Inputs carry a leading
    render axis R (= B*V): mean2d [R,N,2], conic [R,N,3], color [R,N,3],
    opacity/depth/radius/valid [R,N] -> images [R, 3, H, W]. ``dup_budget``
    (per render) defaults to :func:`default_dup_budget`; ``max_per_tile``
    is rounded up to whole 1024-chunks. A ``stats`` dict, if given, receives
    :func:`duplicate_stats` of this call."""
    R, N = opacity.shape
    n_tiles = (img_h // tile_h) * (img_w // tile_w)
    if dup_budget is None:
        dup_budget = default_dup_budget(N, n_tiles)
    dup_budget = -(-int(dup_budget) // CHUNK) * CHUNK
    maxn = max_per_tile_cap(max_per_tile)
    dup = prep_duplicates(mean2d.detach(), radius, depth.detach(), valid,
                          img_h, img_w, tile_h, tile_w, dup_budget)
    if stats is not None:
        stats.update(duplicate_stats(dup, maxn))
    g9 = gaussian_rows(mean2d, conic, color, opacity, valid)
    bg = torch.as_tensor(bg_color, dtype=torch.float32,
                         device=g9.device).reshape(3)
    return BinnedSplat.apply(g9, bg, dup.gid, dup.seg, R, img_h, img_w,
                             tile_h, tile_w, maxn)
