"""Streaming splat: global depth order, per-(tile, chunk) skip bitmap.

Port of unipre3d_tpu/ops/rasterizer/pallas_splat.py, the splat behind
``rasterize(impl="pallas")`` (the eval and test-video renders). All R
renders of a call go through one forward and one backward launch of the
hand-written CUDA kernels in ``csrc/splat_stream.cu``; beside them sit their
plain PyTorch versions (``stream_fwd_ref``, ``stream_bwd_ref``), which the
CPU takes and which the kernels are held against on the card.

Semantics are the JAX kernels':
* no binning and no capacity cap: the gaussians of a render are stably
  depth-sorted once (invalid ones last, at opacity 0) and packed into the
  table [R, 16, N_pad], N_pad a multiple of 512;
* ``chunk_flags``: (tile, 512-column chunk) is flagged when any valid
  gaussian of the chunk has a radius bbox that overlaps the tile. A flagged
  chunk is composited whole for every pixel of the tile, gaussians whose
  own bbox misses the tile included (at 3 sigma alpha can still be ~0.011 >
  1/255); an unflagged chunk adds nothing. A per-tile culled list is not
  this function;
* a pair is skipped at ``power > 0`` (the dense splat's 1e-4 does not apply
  here) or ``alpha < 1/255``; alpha <= 0.99; a gaussian contributes iff log
  T after it stays >= log(1e-4);
* T re-arms at each 512-column chunk: only contributing log(1 - alpha) are
  carried, so a pixel that stopped in one chunk takes small-alpha gaussians
  again in the next flagged one. The JAX kernel's tile-level test (enter a
  chunk only while max log T >= log(1e-4)) always holds: log T only takes
  values that passed the per-gaussian test;
* backward: dL/dalpha = (g . c) T_before - (s_i + T_final (g . bg)) /
  max(1 - alpha, 1e-6), through alpha only where the pair is live and
  alpha < 0.99; ``dbg = sum T_final g`` in torch.

Arithmetic order: the JAX kernel sums a chunk's log(1 - alpha) with a
log-step (Hillis-Steele) scan; the port sums them one gaussian at a time in
depth order, in the kernel and the plain version alike, so the two agree on
T bit for bit and the port agrees with JAX to rounding (a pixel whose log T
lands within rounding of log(1e-4) may take the other stop decision). The
backward's suffix s_i (JAX: a back-to-front carry over chunks) is formed
front to back as tot - the inclusive prefix of w (g . c), with tot = sum_c
g (out - bg T_final) from the forward's output, as the binned port does.

The kernels run one warp an 8x8 patch of a tile (two pixels a lane) and
cull each group of 32 columns against the patch before walking it
(csrc/splat_stream.cu); ``patch_survivors_ref`` is the plain twin of that
cull, and the plain forward's tally (``stats``) counts the warp-column
iterations with and without it.
"""

from __future__ import annotations

import torch

from unipre3d_tpu_torch import kernels
from unipre3d_tpu_torch.ops.rasterizer.pack import (
    ALPHA_MAX, ALPHA_MIN, LOG_T_EPS, ROWS, pack)
from unipre3d_tpu_torch.ops.rasterizer.preprocess import (
    ProjectedGaussians, sort_by_depth)
from unipre3d_tpu_torch.ops.rasterizer.splat_binned import warp_rects
from unipre3d_tpu_torch.ops.rasterizer.splat_dense import cull_keeps

CHUNK = 512              # table columns per chunk (T re-arm, flag width)
MAX_TILE_PIXELS = 1024
PATCH = 8                # a kernel warp's 8x8 patch, two pixels a lane

# the kernels' C entry points, with their launch counts
STREAM_FWD = kernels.CudaKernel("splat_stream", "stream_splat_fwd", 5, 6)
STREAM_BWD = kernels.CudaKernel("splat_stream", "stream_splat_bwd", 7, 6)


def padded_n(n: int) -> int:
    """Table width: N rounded up to whole 512-chunks."""
    return -(-n // CHUNK) * CHUNK


def tile_origins(img_h: int, img_w: int, tile_h: int, tile_w: int, device):
    """Top-left pixel (x0, y0) of every tile, row-major, each [n_tiles]."""
    tx = img_w // tile_w
    ids = torch.arange((img_h // tile_h) * tx, device=device)
    return (ids % tx) * tile_w, (ids // tx) * tile_h


def tile_overlap(mean2d, radius, valid, img_h: int, img_w: int, tile_h: int,
                 tile_w: int) -> torch.Tensor:
    """[R, n_tiles, N] bool: valid gaussian n (mean2d [R, N, 2], radius and
    valid [R, N]) has its bbox (mean +- radius) overlapping tile t's
    pixels."""
    x0, y0 = (t.float()[None, :, None] for t in tile_origins(
        img_h, img_w, tile_h, tile_w, mean2d.device))
    r = radius.float()[:, None, :]
    gx, gy = mean2d[..., 0][:, None, :], mean2d[..., 1][:, None, :]
    return ((gx + r >= x0) & (gx - r <= x0 + (tile_w - 1))
            & (gy + r >= y0) & (gy - r <= y0 + (tile_h - 1))
            & valid[:, None, :])


def chunk_flags(mean2d, radius, valid, img_h: int, img_w: int, tile_h: int,
                tile_w: int, n_pad: int) -> torch.Tensor:
    """[R, n_tiles, n_pad / 512] int32 bitmap of depth-sorted gaussians: a
    (tile, chunk) is set when any gaussian of the chunk overlaps the tile
    (``tile_overlap``)."""
    ov = tile_overlap(mean2d, radius, valid, img_h, img_w, tile_h, tile_w)
    ov = torch.nn.functional.pad(ov, (0, n_pad - ov.shape[-1]))
    R, T = ov.shape[:2]
    return ov.reshape(R, T, n_pad // CHUNK, CHUNK).any(-1).to(torch.int32)


def warp_of_pixel(tile_h: int, tile_w: int) -> torch.Tensor:
    """The kernels' warp of each pixel of a tile, [tile_h * tile_w] int64
    in row-major pixel order: 8x8 patches, row by row, where 8 divides the
    tile's height and width, else 64 consecutive pixels (two a lane)."""
    t = torch.arange(tile_h * tile_w)
    y, x = t // tile_w, t % tile_w
    if tile_h % PATCH == 0 and tile_w % PATCH == 0:
        return (y // PATCH) * (tile_w // PATCH) + x // PATCH
    return t // (2 * 32)


def patch_survivors_ref(data, flags, img_h: int, img_w: int, tile_h: int,
                        tile_w: int) -> torch.Tensor:
    """Plain twin of the kernels' per-warp cull: [R, n_tiles, N_pad] int64,
    bit w set where warp w of the tile (``warp_of_pixel``) keeps the table
    column (its pixel rectangle survives ``splat_dense.cull_keeps``); 0 in
    the chunks the tile does not flag (never walked)."""
    R, _, n_pad = data.shape
    dev = data.device
    x0, y0 = (t.double()[:, None] for t in tile_origins(
        img_h, img_w, tile_h, tile_w, dev))
    rx0, rx1, ry0, ry1 = warp_rects(warp_of_pixel(tile_h, tile_w).to(dev),
                                    tile_w)
    rect = (x0 + rx0, x0 + rx1, y0 + ry0, y0 + ry1)   # each [T, warps, 1]
    rect = tuple(v[:, :, None] for v in rect)
    shift = torch.arange(rx0.shape[0], device=dev)[:, None]
    out = torch.zeros(R, flags.shape[1], n_pad, dtype=torch.int64,
                      device=dev)
    for r in range(R):
        on = flags[r].bool()                                 # [T, chunks]
        for c in on.any(0).nonzero().flatten().tolist():
            cols = slice(c * CHUNK, (c + 1) * CHUNK)
            keep = cull_keeps(data[r, :6, None, None, cols], *rect)
            bits = (keep.long() << shift).sum(1)             # [T, 512]
            out[r, :, cols] = torch.where(on[:, c, None], bits, 0)
    return out


# --------------------------------------------------------------------------
# plain PyTorch versions (the CPU path; the reference for the kernels)
# --------------------------------------------------------------------------

def _tile_pixels(img_h, img_w, tile_h, tile_w, device):
    """Pixel coords of every tile, (px, py) each [n_tiles, P] float."""
    x0, y0 = tile_origins(img_h, img_w, tile_h, tile_w, device)
    t = torch.arange(tile_h * tile_w, device=device)
    return ((x0[:, None] + t % tile_w).float(),
            (y0[:, None] + t // tile_w).float())


def _to_tiles(img, tile_h, tile_w):
    """[R, C, H, W] -> [R, n_tiles, C, P]."""
    R, C, H, W = img.shape
    t = img.reshape(R, C, H // tile_h, tile_h, W // tile_w, tile_w)
    return t.permute(0, 2, 4, 1, 3, 5).reshape(R, -1, C, tile_h * tile_w)


def _from_tiles(t, H, W, tile_h, tile_w):
    """Inverse of :func:`_to_tiles`."""
    R, _, C, _ = t.shape
    img = t.reshape(R, H // tile_h, W // tile_w, C, tile_h, tile_w)
    return img.permute(0, 3, 1, 4, 2, 5).reshape(R, C, H, W)


def _walk(data, flags, px, py, stats=None):
    """The kernels' walk over the table columns, vectorised over (render,
    tile, pixel): yields per column i (i, its rows [R, 9], and the pixel
    terms (alpha, e, dx, dy, skip, contrib, t_before), each [R, n_tiles,
    P]) and log T after it. Columns of chunks that no tile has flagged are
    passed over (they change nothing).

    ``stats``, a dict if given, receives what the data makes the kernels
    do, tallied once per chunk: ``pairs`` (contributing (pixel, gaussian)
    pairs), ``evaluated`` (pairs of flagged chunks up to and including each
    pixel's stop in the chunk, of gaussians with opacity >= 1/255: what the
    function must test), ``rearm``
    (contributions of pixels that stopped in an earlier chunk), each an
    int64 tensor, and ``hit`` [R, n_tiles, N_pad] bool (the column adds
    colour to a pixel of the tile). Given ``stats["survivors"]`` (the
    twin's bits, :func:`patch_survivors_ref`) and ``stats["tile"]`` (the
    tile's (height, width)), it also counts warp-column iterations, a warp
    walking a column of a flagged chunk while one of its pixels has not
    stopped in the chunk: ``iters_rows``, warps of 32 consecutive pixels
    walking every column (the first port's kernels), and
    ``iters_patches``, the kernels' warps (``warp_of_pixel``) walking the
    columns the twin keeps for them; ``groups``, the 32-column groups those
    warps load and cull; ``live``, the pairs the walk does not skip (alpha
    != 0), and ``missed``, those of them the twin drops for the pixel's
    warp."""
    R, _, n_pad = data.shape
    shape = (R, px.shape[0], px.shape[1])
    log_t = torch.zeros(shape, device=data.device)
    stopped = torch.zeros(shape, dtype=torch.bool, device=data.device)
    zero = torch.zeros((), device=data.device)
    cull = stats is not None and "survivors" in stats
    if stats is not None:
        stats.update({k: torch.zeros((), dtype=torch.int64,
                                     device=data.device)
                      for k in ("pairs", "evaluated", "rearm")
                      + (("iters_rows", "iters_patches", "groups", "live",
                          "missed") if cull else ())})
        stats["hit"] = torch.zeros(*shape[:2], n_pad, dtype=torch.bool,
                                   device=data.device)
        earlier = stopped                       # stopped in an earlier chunk
    if cull:
        warp = warp_of_pixel(*stats["tile"]).to(data.device)
        n_px = warp.shape[0]
        rows = torch.nn.functional.one_hot(
            torch.arange(n_px, device=data.device) // 32).float()
        patches = torch.nn.functional.one_hot(warp).float()
        shift = torch.arange(patches.shape[1], device=data.device)
    for c in range(n_pad // CHUNK):
        on = flags[:, :, c].bool()                              # [R, T]
        if not bool(on.any()):
            continue
        off = ~on[..., None]
        stopped = torch.zeros_like(stopped)                     # re-arm
        contribs, befores, lives = [], [], []
        for i in range(c * CHUNK, (c + 1) * CHUNK):
            g = data[:, :9, i]                                  # [R, 9]
            col = g[:, :, None, None]
            dx = col[:, 0] - px
            dy = col[:, 1] - py
            power = -0.5 * (col[:, 2] * dx * dx + col[:, 4] * dy * dy) \
                - col[:, 3] * dx * dy
            e = torch.exp(power)
            a = torch.clamp_max(col[:, 5] * e, ALPHA_MAX)
            skip = (power > 0.0) | (a < ALPHA_MIN) | off
            alpha = torch.where(skip, zero, a)
            incl = log_t + torch.log1p(-alpha)
            ok = incl >= LOG_T_EPS
            contrib = ~skip & ~stopped & ok
            if stats is not None:
                contribs.append(contrib)
                befores.append(stopped)
            if cull:
                lives.append(~skip)
            stopped = stopped | (~skip & ~ok)
            t_before = torch.exp(log_t)
            log_t = torch.where(contrib, incl, log_t)
            yield i, g, (alpha, e, dx, dy, skip, contrib, t_before), log_t
        if stats is not None:
            hit = torch.stack(contribs)                   # [512, R, T, P]
            stats["pairs"] += hit.sum()
            stats["rearm"] += (hit & earlier).sum()
            can = data[:, 5, c * CHUNK:(c + 1) * CHUNK] >= ALPHA_MIN
            stats["evaluated"] += (~torch.stack(befores) & on[None, ..., None]
                                   & can.t()[..., None, None]).sum()
            stats["hit"][..., c * CHUNK:(c + 1) * CHUNK] = \
                hit.any(-1).permute(1, 2, 0)
            earlier = earlier | stopped
            if cull:
                walking = (~torch.stack(befores) & on[None, ..., None]
                           ).float()                      # [512, R, T, P]
                bits = stats["survivors"][..., c * CHUNK:(c + 1) * CHUNK
                                          ].permute(2, 0, 1)  # [512, R, T]
                kept = (bits[..., None] >> shift) & 1     # [512, R, T, w]
                in_patch = (walking @ patches) > 0
                stats["iters_rows"] += ((walking @ rows) > 0).sum()
                stats["iters_patches"] += (in_patch & (kept == 1)).sum()
                stats["groups"] += in_patch[::32].sum()
                live = torch.stack(lives)
                stats["live"] += live.sum()
                stats["missed"] += (live & ((bits[..., None] >> warp) & 1
                                            == 0)).sum()


def stream_fwd_ref(data, flags, bg, img_h: int, img_w: int, tile_h: int,
                   tile_w: int, stats=None):
    """data [R,16,N_pad], flags [R,n_tiles,n_chunks], bg [3] -> (out
    [R,3,H,W], log T final [R,H,W]); ``stats`` as in :func:`_walk`."""
    px, py = _tile_pixels(img_h, img_w, tile_h, tile_w, data.device)
    R = data.shape[0]
    rgb = torch.zeros(R, px.shape[0], 3, px.shape[1], device=data.device)
    log_t = torch.zeros(R, *px.shape, device=data.device)
    for _, g, (alpha, _, _, _, _, contrib, t_before), log_t in _walk(
            data, flags, px, py, stats):
        w = torch.where(contrib, alpha * t_before, torch.zeros_like(alpha))
        rgb = rgb + w[:, :, None, :] * g[:, None, 6:9, None]
    out = rgb + bg.reshape(1, 1, 3, 1) * torch.exp(log_t)[:, :, None, :]
    return (_from_tiles(out, img_h, img_w, tile_h, tile_w),
            _from_tiles(log_t[:, :, None], img_h, img_w, tile_h,
                        tile_w)[:, 0])


def stream_bwd_ref(data, flags, bg, logt, tot, g_out, img_h: int, img_w: int,
                   tile_h: int, tile_w: int):
    """Analytic backward: + logt/tot [R,H,W], g_out [R,3,H,W] -> dgrad
    [R,16,N_pad] (rows 0-8)."""
    px, py = _tile_pixels(img_h, img_w, tile_h, tile_w, data.device)
    gp = _to_tiles(g_out, tile_h, tile_w)                       # [R,T,3,P]
    tot_t = _to_tiles(tot[:, None], tile_h, tile_w)[:, :, 0]
    tfin = torch.exp(_to_tiles(logt[:, None], tile_h, tile_w)[:, :, 0])
    tb = tfin * (bg.reshape(1, 1, 3, 1) * gp).sum(2)
    u_incl = torch.zeros_like(tb)
    dgrad = torch.zeros_like(data)
    zero = torch.zeros((), device=data.device)
    for i, g, (alpha, e, dx, dy, skip, contrib, t_before), _ in _walk(
            data, flags, px, py):
        w = torch.where(contrib, alpha * t_before, zero)
        cg = (gp * g[:, None, 6:9, None]).sum(2)                # [R,T,P]
        u_incl = u_incl + w * cg
        one_m = torch.clamp_min(1.0 - alpha, 1e-6)
        dalpha = torch.where(
            contrib, cg * t_before - ((tot_t - u_incl) + tb) / one_m, zero)
        live = ~skip & (alpha < ALPHA_MAX)
        dpow = torch.where(live, dalpha * alpha, zero)
        A, B, C = (g[:, k, None, None] for k in (2, 3, 4))
        dgrad[:, 0:9, i] = torch.stack([
            (-dpow * (A * dx + B * dy)).sum((1, 2)),
            (-dpow * (C * dy + B * dx)).sum((1, 2)),
            (-0.5 * dpow * dx * dx).sum((1, 2)),
            (-dpow * dx * dy).sum((1, 2)),
            (-0.5 * dpow * dy * dy).sum((1, 2)),
            torch.where(live, dalpha * e, zero).sum((1, 2)),
            *(gp * w[:, :, None, :]).sum((1, 3)).t(),
        ], dim=1)
    return dgrad


# --------------------------------------------------------------------------
# wrappers: kernel on CUDA tensors, plain version on CPU tensors
# --------------------------------------------------------------------------

def _check_shapes(data, flags, img_h, img_w, tile_h, tile_w):
    R, _, n_pad = data.shape
    if img_h % tile_h or img_w % tile_w or \
            tile_h * tile_w > MAX_TILE_PIXELS or n_pad % CHUNK:
        raise ValueError(f"stream splat: tiles {tile_h}x{tile_w} must divide "
                         f"{img_h}x{img_w} and hold <= {MAX_TILE_PIXELS} px; "
                         f"N_pad {n_pad} must be a multiple of {CHUNK}")
    n_tiles = (img_h // tile_h) * (img_w // tile_w)
    kernels.check_tensor("data", data, (R, ROWS, n_pad))
    kernels.check_tensor("flags", flags, (R, n_tiles, n_pad // CHUNK),
                         torch.int32)


def stream_fwd(data, flags, bg, img_h: int, img_w: int, tile_h: int,
               tile_w: int):
    """Forward: (out [R,3,H,W], log T final [R,H,W])."""
    if not kernels.use_kernel("stream splat", data, flags, bg):
        return stream_fwd_ref(data, flags, bg, img_h, img_w, tile_h, tile_w)
    _check_shapes(data, flags, img_h, img_w, tile_h, tile_w)
    kernels.check_tensor("bg", bg, (3,))
    R, _, n_pad = data.shape
    out = torch.empty(R, 3, img_h, img_w, device=data.device)
    logt = torch.empty(R, img_h, img_w, device=data.device)
    STREAM_FWD(data.data_ptr(), flags.data_ptr(), bg.data_ptr(),
               out.data_ptr(), logt.data_ptr(), R, n_pad, img_h, img_w,
               tile_h, tile_w)
    return out, logt


def stream_bwd(data, flags, bg, logt, tot, g_out, img_h: int, img_w: int,
               tile_h: int, tile_w: int):
    """Backward: dgrad [R,16,N_pad] (rows 0-8; rows 9-15 zero)."""
    if not kernels.use_kernel("stream splat", data, flags, bg, logt, tot,
                              g_out):
        return stream_bwd_ref(data, flags, bg, logt, tot, g_out, img_h,
                              img_w, tile_h, tile_w)
    _check_shapes(data, flags, img_h, img_w, tile_h, tile_w)
    R, _, n_pad = data.shape
    for name, t, shape in (("bg", bg, (3,)), ("logt", logt, (R, img_h, img_w)),
                           ("tot", tot, (R, img_h, img_w)),
                           ("g_out", g_out, (R, 3, img_h, img_w))):
        kernels.check_tensor(name, t, shape)
    dgrad = torch.zeros_like(data)
    STREAM_BWD(data.data_ptr(), flags.data_ptr(), bg.data_ptr(),
               logt.data_ptr(), tot.data_ptr(), g_out.data_ptr(),
               dgrad.data_ptr(), R, n_pad, img_h, img_w, tile_h, tile_w)
    return dgrad


class StreamSplat(torch.autograd.Function):
    """Packed tables [R,16,N_pad] + bg [3] (+ the chunk bitmap) -> images
    [R,3,H,W]; forward and backward each one kernel launch on CUDA
    tensors, the backward analytic (pallas_splat.py:_splat_vjp_bwd)."""

    @staticmethod
    def forward(ctx, data, bg, flags, img_h, img_w, tile_h, tile_w):
        out, logt = stream_fwd(data, flags, bg, img_h, img_w, tile_h, tile_w)
        ctx.save_for_backward(data, flags, bg, out, logt)
        ctx.shape = (img_h, img_w, tile_h, tile_w)
        return out

    @staticmethod
    def backward(ctx, g_out):
        data, flags, bg, out, logt = ctx.saved_tensors
        g_out = g_out.contiguous()
        tfin = torch.exp(logt)
        # tot = sum_c g (out - bg T_final): the colour share of dL/dalpha
        tot = (g_out * (out - bg.reshape(1, 3, 1, 1) * tfin[:, None])).sum(1)
        dgrad = stream_bwd(data, flags, bg, logt, tot, g_out, *ctx.shape)
        dbg = torch.einsum("rhw,rchw->c", tfin, g_out)
        return dgrad, dbg, None, None, None, None, None


def stream_inputs(pg: ProjectedGaussians, img_h: int, img_w: int,
                  tile_h: int, tile_w: int):
    """Projected gaussians of R renders (fields [R, N, ...]) -> (table
    [R, 16, N_pad] of the stably depth-sorted gaussians, invalid ones last
    at opacity 0; its chunk bitmap; the sorted gaussians)."""
    s = sort_by_depth(pg)
    opa = torch.where(s.valid, s.opacity, torch.zeros_like(s.opacity))
    table = pack(s.mean2d, s.conic, s.color, opa,
                 padded_n(opa.shape[-1])).contiguous()
    flags = chunk_flags(s.mean2d.detach(), s.radius, s.valid, img_h, img_w,
                        tile_h, tile_w, table.shape[-1])
    return table, flags, s


def rasterize_projected_stream(pg, bg_color, img_h: int, img_w: int,
                               tile_h: int = 16, tile_w: int = 16
                               ) -> torch.Tensor:
    """Counterpart of ``rasterize_projected_pallas``: projected gaussians
    (ProjectedGaussians, fields [N, ...] or [R, N, ...]) -> image [3, H, W]
    (or [R, 3, H, W]); every depth-ordered gaussian is composited (no
    capacity cap)."""
    if img_h % tile_h or img_w % tile_w:
        raise ValueError(f"tiles {tile_h}x{tile_w} must divide "
                         f"{img_h}x{img_w}")
    single = pg.depth.ndim == 1
    if single:
        pg = ProjectedGaussians(*(t[None] for t in pg))
    table, flags, _ = stream_inputs(pg, img_h, img_w, tile_h, tile_w)
    bg = torch.as_tensor(bg_color, dtype=torch.float32,
                         device=table.device).reshape(3)
    img = StreamSplat.apply(table, bg, flags, img_h, img_w, tile_h, tile_w)
    return img[0] if single else img
