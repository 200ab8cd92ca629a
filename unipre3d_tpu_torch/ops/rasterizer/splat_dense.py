"""Batched dense splat: the object-level training renderer.

Port of unipre3d_tpu/ops/rasterizer/pallas_splat_dense.py. All R = B*V
renders of a step go through one forward and one backward launch of the
hand-written CUDA kernels in ``csrc/splat_dense.cu``; beside them sit
their plain PyTorch versions (``dense_splat_fwd_ref``,
``dense_splat_bwd_ref``), which the CPU takes and which the kernels are
held against on the card.

Semantics are the JAX kernel's (``pallas_splat_dense.py``): alpha capped
at 0.99, a pair skipped at ``power > 1e-4`` or ``alpha < 1/255``, a
gaussian contributing iff T after it stays >= 1e-4, T frozen at the stop
and carried between 512-column chunks (so a pixel may take small-alpha
gaussians again after a stop in an earlier chunk), and a backward that
flows through alpha only where the pair is live and alpha < 0.99 with
``1 - alpha`` clamped at 1e-6.

The kernels cull each chunk of a render's table against each 16x16 tile
before they walk it; ``tile_survivors_ref`` is the plain twin of that test
(used by the tests and ``chip_smoke.py`` only: the cull drops only pairs
the walk skips at every pixel of the tile, so the plain versions need no
cull).
"""

from __future__ import annotations

import torch

from unipre3d_tpu_torch import kernels
from unipre3d_tpu_torch.ops.rasterizer.pack import (
    ALPHA_MAX, ALPHA_MIN, LOG_T_EPS, ROWS, pack)

CHUNK = 512   # table columns composited per chunk (the T carry boundary)
POWER_SKIP = 1e-4
# renders per block of the plain versions: bounds their intermediates to
# ~2**26 elements each
_REF_ELEMS = 1 << 26

# the kernels' per-tile cull (csrc/splat_common.cuh, rect_keeps): tile side,
# deflation of the conic, slack of the threshold 2 ln(255 o), magnitudes of
# mean and conic above which a column is kept undecided
TILE = 16
CULL_DEFLATE = 1e-5
CULL_TAU_SLACK = 1e-3
CULL_MAX_MEAN = 1e9
CULL_MAX_CONIC = 1e18

# the kernels' C entry points, with their launch counts
DENSE_FWD = kernels.CudaKernel("splat_dense", "dense_splat_fwd", 4, 5)
DENSE_BWD = kernels.CudaKernel("splat_dense", "dense_splat_bwd", 4, 5)


def chunk_of(n_pad: int) -> int:
    chunk_n = min(n_pad, CHUNK)
    # n_pad is padded to a chunk multiple by rasterize_dense_batched; a
    # floored chunk count would silently drop trailing gaussians
    if n_pad % chunk_n:
        raise ValueError(f"n_pad {n_pad} is not a multiple of {chunk_n}")
    return chunk_n


# --------------------------------------------------------------------------
# plain PyTorch versions (the CPU path; the reference for the kernels)
# --------------------------------------------------------------------------

def _pixels(img_h, img_w, device):
    flat = torch.arange(img_h * img_w, device=device)
    return (flat % img_w).float(), (flat // img_w).float()


def _walk(d, px, py, chunk_n, keep_columns=False):
    """Front-to-back walk over the columns of tables d [r, 16, N_pad] for
    pixels px/py [P], one column at a time in the kernel's own arithmetic
    order, so the stop decisions agree with the kernel bit for bit wherever
    exp and log do. Returns (rgb [r,3,P] without background, final log T
    [r,P], columns): with ``keep_columns`` the list of per-column
    (alpha, e, live, contrib, w, t_before, dx, dy), each [r, P]."""
    zero = torch.zeros(d.shape[0], px.shape[0], device=d.device)
    rgb = torch.zeros(d.shape[0], 3, px.shape[0], device=d.device)
    pe = zero.clone()              # log T before the next gaussian
    stopped = zero.bool()
    columns = []
    for i in range(d.shape[-1]):
        if i % chunk_n == 0:
            # chunk carry: every pixel re-enters a chunk at its frozen T
            stopped = torch.zeros_like(stopped)
        g = d[:, :, i, None]                                   # [r, 16, 1]
        dx = g[:, 0] - px
        dy = g[:, 1] - py
        power = -0.5 * (g[:, 2] * dx * dx + g[:, 4] * dy * dy) \
            - g[:, 3] * dx * dy
        e = torch.exp(power)
        a = torch.clamp_max(g[:, 5] * e, ALPHA_MAX)
        skip = (power > POWER_SKIP) | (a < ALPHA_MIN)
        alpha = torch.where(skip, zero, a)
        incl = pe + torch.log(1.0 - alpha)
        ok = incl >= LOG_T_EPS
        contrib = ~skip & ~stopped & ok
        stopped = stopped | (~skip & ~ok)
        t_before = torch.exp(pe)
        w = torch.where(contrib, alpha * t_before, zero)
        rgb = rgb + w[:, None, :] * g[:, 6:9]
        pe = torch.where(contrib, incl, pe)
        if keep_columns:
            columns.append((alpha, e, ~skip & (alpha < ALPHA_MAX), contrib, w,
                            t_before, dx, dy))
    return rgb, pe, columns


def cull_keeps(rows, x0, x1, y0, y1) -> torch.Tensor:
    """Plain twin of the kernels' cull of a column against a pixel
    rectangle (``rect_keeps`` in csrc/splat_common.cuh), in float64 as
    there. rows [6, ...] float32: mean x, mean y, conic A, B, C, opacity;
    x0 <= x1, y0 <= y1 (pixel coordinates) broadcast against rows[0].
    False only where the minimum over the rectangle of the deflated
    quadratic d' M d (M the conic less 1e-5 diag(|A| + |B|, |C| + |B|), d
    mean minus pixel) exceeds 2 ln(255 o) + 1e-3, i.e. where the walk's
    float32 arithmetic skips the pair (alpha < 1/255) at every pixel;
    opacity <= 0 drops; a non-finite row, a deflated form that is not
    positive definite and magnitudes at which the float32 power could
    overflow are kept."""
    d = rows.double()
    mx, my, A, B, C, o = d
    a = A - CULL_DEFLATE * (A.abs() + B.abs())
    c = C - CULL_DEFLATE * (C.abs() + B.abs())
    finite = torch.isfinite(d).all(0)
    huge = (torch.maximum(mx.abs(), my.abs()) >= CULL_MAX_MEAN) \
        | (torch.maximum(torch.maximum(A.abs(), B.abs()), C.abs())
           >= CULL_MAX_CONIC)
    pos_def = (a > 0) & (a * c - B * B > 0)
    # as the kernels: the log of 255 o in float32, the rest in float64
    tau = 2.0 * torch.log(255.0 * rows[5]).double() + CULL_TAU_SLACK
    lx, hx, ly, hy = mx - x1, mx - x0, my - y1, my - y0

    def edge_min(a, b, c, X, lo, hi):
        y = torch.minimum(torch.maximum(-b * X / c, lo), hi)
        return a * X * X + 2.0 * b * X * y + c * y * y

    m = torch.minimum(
        torch.minimum(edge_min(a, B, c, lx, ly, hy),
                      edge_min(a, B, c, hx, ly, hy)),
        torch.minimum(edge_min(c, B, a, ly, lx, hx),
                      edge_min(c, B, a, hy, lx, hx)))
    centre_in = (lx <= 0) & (hx >= 0) & (ly <= 0) & (hy >= 0)
    hit = (tau >= 0) & (centre_in | (m <= tau))
    return ~finite | ((o > 0) & (huge | ~pos_def | hit))


def tile_survivors_ref(data, img_h: int, img_w: int) -> torch.Tensor:
    """Plain twin of the dense kernels' per-tile cull: data [R,16,N_pad]
    -> [R, n_tiles, N_pad] bool, tiles of 16x16 pixels in row-major order
    (clipped to the image), True where the column survives the tile's cull
    (:func:`cull_keeps`)."""
    tiles_x, tiles_y = -(-img_w // TILE), -(-img_h // TILE)
    dev = data.device
    x0 = (torch.arange(tiles_x, device=dev) * TILE).double().repeat(tiles_y)
    y0 = (torch.arange(tiles_y, device=dev) * TILE).double() \
        .repeat_interleave(tiles_x)
    x1 = torch.clamp_max(x0 + TILE, img_w) - 1
    y1 = torch.clamp_max(y0 + TILE, img_h) - 1
    x0, x1, y0, y1 = (t[None, :, None] for t in (x0, x1, y0, y1))
    rows = data[:, :6].transpose(0, 1)[:, :, None, :]     # [6, R, 1, N]
    return cull_keeps(rows, x0, x1, y0, y1)


def _render_blocks(R, n_elems):
    """Render ranges whose [r, *] intermediates of n_elems per render stay
    under _REF_ELEMS elements."""
    step = max(1, _REF_ELEMS // max(1, n_elems))
    return [(r0, min(R, r0 + step)) for r0 in range(0, R, step)]


def dense_splat_fwd_ref(data, bg, img_h: int, img_w: int):
    """data [R,16,N_pad], bg [3] -> (out [R,3,H*W], tfin [R,1,H*W])."""
    R, _, n_pad = data.shape
    chunk_n = chunk_of(n_pad)
    px, py = _pixels(img_h, img_w, data.device)
    outs, tfins = [], []
    for r0, r1 in _render_blocks(R, 4 * img_h * img_w):
        rgb, log_t, _ = _walk(data[r0:r1], px, py, chunk_n)
        t = torch.exp(log_t)[:, None, :]
        outs.append(rgb + bg.reshape(1, 3, 1) * t)
        tfins.append(t)
    return torch.cat(outs), torch.cat(tfins)


def dense_splat_bwd_ref(data, bg, tfin, g_out, img_h: int, img_w: int):
    """Analytic backward with the JAX kernel's formulation: dL/dalpha_i =
    (g . c_i) T_before_i - (S_i + T_final (g . bg)) / max(1 - alpha_i,
    1e-6), S_i the suffix sum of w_j (g . c_j) over later gaussians.
    -> (dgrad [R,16,N_pad] (rows 0-8), dbg [3])."""
    R, _, n_pad = data.shape
    chunk_n = chunk_of(n_pad)
    px, py = _pixels(img_h, img_w, data.device)
    dgrad = torch.zeros_like(data)
    for r0, r1 in _render_blocks(R, img_h * img_w * n_pad):
        d = data[r0:r1]
        g_pix = g_out[r0:r1]                                   # [r, 3, P]
        _, log_t, columns = _walk(d, px, py, chunk_n, keep_columns=True)
        alpha, e, live, contrib, w, t_before, dx, dy = (
            torch.stack(t, -1) for t in zip(*columns))
        del columns
        tb = torch.exp(log_t) * (bg.reshape(1, 3, 1) * g_pix).sum(1)
        cg = torch.einsum("rkp,rkc->rpc", g_pix, d[:, 6:9])   # [r, P, N]
        u = w * cg
        suffix = torch.flip(torch.cumsum(torch.flip(u, [-1]), -1), [-1]) - u
        one_m = torch.clamp_min(1.0 - alpha, 1e-6)
        dalpha = torch.where(
            contrib, cg * t_before - (suffix + tb[..., None]) / one_m,
            torch.zeros_like(alpha))
        dpow = torch.where(live, dalpha * alpha, torch.zeros_like(alpha))
        A, B, C = d[:, None, 2], d[:, None, 3], d[:, None, 4]
        dgrad[r0:r1, 0:9] = torch.stack([
            (-dpow * (A * dx + B * dy)).sum(1),
            (-dpow * (C * dy + B * dx)).sum(1),
            (-0.5 * dpow * dx * dx).sum(1),
            (-dpow * dx * dy).sum(1),
            (-0.5 * dpow * dy * dy).sum(1),
            torch.where(live, dalpha * e, torch.zeros_like(e)).sum(1),
            *torch.einsum("rkp,rpc->krc", g_pix, w),
        ], dim=1)
    dbg = torch.einsum("rp,rcp->c", tfin[:, 0, :], g_out)
    return dgrad, dbg


# --------------------------------------------------------------------------
# wrappers: kernel on CUDA tensors, plain version on CPU tensors
# --------------------------------------------------------------------------

def dense_fwd(data, bg, img_h: int, img_w: int):
    """Forward: (out [R,3,H*W], tfin [R,1,H*W])."""
    R, _, n_pad = data.shape
    if not kernels.use_kernel("dense splat", data, bg):
        return dense_splat_fwd_ref(data, bg, img_h, img_w)
    kernels.check_tensor("data", data, (R, ROWS, n_pad))
    kernels.check_tensor("bg", bg, (3,))
    n_pix = img_h * img_w
    out = torch.empty(R, 3, n_pix, device=data.device)
    tfin = torch.empty(R, 1, n_pix, device=data.device)
    DENSE_FWD(data.data_ptr(), bg.data_ptr(), out.data_ptr(), tfin.data_ptr(),
              R, n_pad, chunk_of(n_pad), img_h, img_w)
    return out, tfin


def dense_bwd(data, bg, out, tfin, g_out, img_h: int, img_w: int):
    """Backward: (dgrad [R,16,N_pad], dbg [3])."""
    R, _, n_pad = data.shape
    if not kernels.use_kernel("dense splat", data, bg, out, tfin,
                              g_out):
        return dense_splat_bwd_ref(data, bg, tfin, g_out, img_h, img_w)
    n_pix = img_h * img_w
    kernels.check_tensor("data", data, (R, ROWS, n_pad))
    kernels.check_tensor("out", out, (R, 3, n_pix))
    kernels.check_tensor("g_out", g_out, (R, 3, n_pix))
    dgrad = torch.zeros_like(data)
    DENSE_BWD(data.data_ptr(), out.data_ptr(), g_out.data_ptr(),
              dgrad.data_ptr(), R, n_pad, chunk_of(n_pad), img_h, img_w)
    # bg cotangent: sum over renders and pixels of T_final * g (as JAX), as
    # R small matrix-vector products: the einsum of the plain version takes
    # 3x as long on the card
    dbg = torch.bmm(g_out, tfin.transpose(1, 2)).sum((0, 2))
    return dgrad, dbg


class DenseSplat(torch.autograd.Function):
    """Packed tables [R,16,N_pad] + bg [3] -> images [R,3,H*W]; forward and
    backward each one launch of the hand kernels on CUDA tensors."""

    @staticmethod
    def forward(ctx, data, bg, img_h: int, img_w: int):
        out, tfin = dense_fwd(data, bg, img_h, img_w)
        ctx.save_for_backward(data, bg, out, tfin)
        ctx.img_hw = (img_h, img_w)
        return out

    @staticmethod
    def backward(ctx, g_out):
        data, bg, out, tfin = ctx.saved_tensors
        dgrad, dbg = dense_bwd(data, bg, out, tfin, g_out.contiguous(),
                               *ctx.img_hw)
        return dgrad, dbg, None, None


def sorted_table(mean2d, conic, color, opacity, depth, valid) -> torch.Tensor:
    """Per-render depth sort (invalid gaussians last, opacity 0) and pack
    into the kernels' table [R, 16, N_pad]: N padded to 128, or to a
    multiple of 512 above 512 so the 512-column chunk divides it."""
    R, N = opacity.shape
    n_pad = -(-N // 128) * 128
    if n_pad > CHUNK:
        n_pad = -(-n_pad // CHUNK) * CHUNK
    key = torch.where(valid, depth, torch.full_like(depth, float("inf")))
    order = torch.argsort(key, dim=1, stable=True)

    def take(a):
        return torch.take_along_dim(
            a, order.reshape(R, N, *([1] * (a.ndim - 2))), dim=1)

    opa = take(torch.where(valid, opacity, torch.zeros_like(opacity)))
    return pack(take(mean2d), take(conic), take(color), opa,
                n_pad).contiguous()


def rasterize_dense_batched(mean2d, conic, color, opacity, depth, valid,
                            bg_color, img_h: int, img_w: int) -> torch.Tensor:
    """Rasterize R renders in one launch. Inputs carry a leading render
    axis R (= B*V): mean2d [R,N,2], conic [R,N,3], color [R,N,3],
    opacity/depth/valid [R,N] -> images [R, 3, H, W]."""
    data = sorted_table(mean2d, conic, color, opacity, depth, valid)
    bg = torch.as_tensor(bg_color, dtype=torch.float32,
                         device=data.device).reshape(3)
    out = DenseSplat.apply(data, bg, img_h, img_w)
    return out.reshape(-1, 3, img_h, img_w)
