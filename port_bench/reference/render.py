"""Plain reference of the supervision render and the photometric loss.

A frozen copy of the port's screen-space preprocessing
(unipre3d_tpu_torch/ops/rasterizer/preprocess.py, utils/sh.py at degree
<= 1), its depth-sorted table (splat_dense.py ``sorted_table``, pack.py)
and the plain versions of its dense splat pair (``dense_splat_fwd_ref``,
``dense_splat_bwd_ref``: alpha capped at 0.99, a pair skipped at power >
1e-4 or alpha < 1/255, T frozen at 1e-4 within a 512-column chunk), with
the loss (utils/losses.py ``focal_l2_loss``). Float32 throughout, as the
program's renderer.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

NEAR_CULL_Z = 0.2
AA_BLUR = 0.3
T_EPS = 1e-4
LOG_T_EPS = math.log(T_EPS)
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
POWER_SKIP = 1e-4
CHUNK = 512
ROWS = 16
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
# renders per block of the plain splat: bounds its intermediates
_REF_ELEMS = 1 << 26


def preprocess(means3d, opacities, scales, rotations, shs, world_view,
               full_proj, cam_center, img_h, img_w, tanfov, mask=None):
    """Gaussians [B, 1, N, ...] (``mask`` [B, 1, N]: the valid ones)
    against cameras [B, V, ...] -> screen-space (mean2d, conic, color,
    opacity, depth, valid, radius), each [B, V, N, ...]."""
    means3d, opacities = means3d.float(), opacities.float()
    wv, fp4 = world_view.float(), full_proj.float()

    def xform(m):
        m = m[..., None, :, :]
        return [means3d[..., 0] * m[..., 0, j] + means3d[..., 1] * m[..., 1, j]
                + means3d[..., 2] * m[..., 2, j] + m[..., 3, j]
                for j in range(4)]

    pv, pc = xform(wv), xform(fp4)
    p_w = 1.0 / (pc[3] + 1e-7)
    depth = pv[2]
    in_front = depth > NEAR_CULL_Z
    ndc2pix = lambda v, s: ((v + 1.0) * s - 1.0) * 0.5
    mean2d = torch.stack([ndc2pix(pc[0] * p_w, img_w),
                          ndc2pix(pc[1] * p_w, img_h)], dim=-1)
    focal_x, focal_y = img_w / (2.0 * tanfov), img_h / (2.0 * tanfov)
    tz = torch.where(depth.abs() > 1e-6, depth, torch.full_like(depth, 1e-6))
    lim = 1.3 * tanfov
    tx = torch.clamp(pv[0] / tz, -lim, lim) * tz
    ty = torch.clamp(pv[1] / tz, -lim, lim) * tz
    W = wv[..., :3, :3].transpose(-1, -2)[..., None, :, :]
    j00, j02 = focal_x / tz, -focal_x * tx / (tz * tz)
    j11, j12 = focal_y / tz, -focal_y * ty / (tz * tz)
    a1 = [j00 * W[..., 0, j] + j02 * W[..., 2, j] for j in range(3)]
    a2 = [j11 * W[..., 1, j] + j12 * W[..., 2, j] for j in range(3)]
    r = rotations.float()
    w, x, y, z = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
    cols = (torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y + w * z),
                         2 * (x * z - w * y)], dim=-1),
            torch.stack([2 * (x * y - w * z), 1 - 2 * (x * x + z * z),
                         2 * (y * z + w * x)], dim=-1),
            torch.stack([2 * (x * z + w * y), 2 * (y * z - w * x),
                         1 - 2 * (x * x + y * y)], dim=-1))
    s2 = scales.float() ** 2
    c_xx = c_xy = c_yy = torch.zeros_like(tz)
    for k, rk in enumerate(cols):
        u = rk[..., 0] * a1[0] + rk[..., 1] * a1[1] + rk[..., 2] * a1[2]
        v = rk[..., 0] * a2[0] + rk[..., 1] * a2[1] + rk[..., 2] * a2[2]
        c_xx = c_xx + s2[..., k] * u * u
        c_xy = c_xy + s2[..., k] * u * v
        c_yy = c_yy + s2[..., k] * v * v
    det_orig = c_xx * c_yy - c_xy * c_xy
    c_xx, c_yy = c_xx + AA_BLUR, c_yy + AA_BLUR
    det_blur = c_xx * c_yy - c_xy * c_xy
    ok = torch.isfinite(det_orig) & torch.isfinite(det_blur) \
        & (det_blur > 0.0)
    one = torch.ones_like(det_blur)
    ratio = torch.where(ok, torch.where(ok, det_orig, one)
                        / torch.where(ok, det_blur, one), one)
    opacities = opacities * torch.sqrt(torch.clamp_min(ratio, 2.5e-5))
    det_ok = det_blur > 0.0
    safe = torch.where(det_ok, det_blur, torch.ones_like(det_blur))
    inv_det = torch.where(det_ok, 1.0 / safe, torch.zeros_like(det_blur))
    conic = torch.stack([c_yy * inv_det, -c_xy * inv_det, c_xx * inv_det],
                        dim=-1)
    mid = 0.5 * (c_xx + c_yy)
    lambda1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det_blur, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lambda1))
    if mask is not None:
        in_front = in_front & mask
    valid = in_front & det_ok & (mean2d[..., 0] + radius >= 0) \
        & (mean2d[..., 0] - radius < img_w) \
        & (mean2d[..., 1] + radius >= 0) & (mean2d[..., 1] - radius < img_h)
    dirs = means3d - cam_center.float()[..., None, :]
    dirs = dirs / torch.sqrt((dirs ** 2).sum(-1, keepdim=True) + 1e-12)
    sh = shs.float().transpose(-1, -2)              # [..., 3, K]
    dx, dy, dz = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
    rgb = (SH_C0 * sh[..., 0] - SH_C1 * dy * sh[..., 1]
           + SH_C1 * dz * sh[..., 2] - SH_C1 * dx * sh[..., 3]) + 0.5
    color = torch.clamp_min(rgb, 0.0).expand(*mean2d.shape[:-1], 3)
    opacity = torch.where(valid, opacities, torch.zeros_like(opacities))
    radius = torch.where(valid, radius, torch.zeros_like(radius))
    return mean2d, conic, color, opacity, depth, valid, radius


def sorted_table(mean2d, conic, color, opacity, depth, valid):
    """Per-render depth sort (invalid last, opacity 0), packed [R, 16,
    N_pad]: mean x, y, conic a, b, c, opacity, r, g, b."""
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
    rows = torch.cat([take(mean2d).transpose(-1, -2),
                      take(conic).transpose(-1, -2), opa.unsqueeze(-2),
                      take(color).transpose(-1, -2)], dim=-2).float()
    return torch.nn.functional.pad(rows, (0, n_pad - N, 0, ROWS - 9))


def _pixels(img_h, img_w, device):
    flat = torch.arange(img_h * img_w, device=device)
    return (flat % img_w).float(), (flat // img_w).float()


def _walk(d, px, py, chunk_n, keep_columns=False):
    zero = torch.zeros(d.shape[0], px.shape[0], device=d.device)
    rgb = torch.zeros(d.shape[0], 3, px.shape[0], device=d.device)
    pe = zero.clone()
    stopped = zero.bool()
    columns, live_pairs = [], 0
    for i in range(d.shape[-1]):
        if i % chunk_n == 0:
            stopped = torch.zeros_like(stopped)
        g = d[:, :, i, None]
        dx, dy = g[:, 0] - px, g[:, 1] - py
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
        live_pairs = live_pairs + contrib.sum()
        if keep_columns:
            columns.append((alpha, e, ~skip & (alpha < ALPHA_MAX), contrib, w,
                            t_before, dx, dy))
    return rgb, pe, columns, live_pairs


def _blocks(R, n_elems):
    step = max(1, _REF_ELEMS // max(1, n_elems))
    return [(r0, min(R, r0 + step)) for r0 in range(0, R, step)]


def splat_fwd(data, bg, img_h, img_w, counter=None):
    """-> (out [R, 3, H*W], tfin [R, 1, H*W]); ``counter``, a dict, gains
    the walk's contributing (render, pixel, gaussian) pairs under
    ``pairs``."""
    R, _, n_pad = data.shape
    px, py = _pixels(img_h, img_w, data.device)
    outs, tfins = [], []
    for r0, r1 in _blocks(R, 4 * img_h * img_w):
        rgb, log_t, _, pairs = _walk(data[r0:r1], px, py, min(n_pad, CHUNK))
        if counter is not None:
            counter["pairs"] = counter.get("pairs", 0) + int(pairs)
        t = torch.exp(log_t)[:, None, :]
        outs.append(rgb + bg.reshape(1, 3, 1) * t)
        tfins.append(t)
    return torch.cat(outs), torch.cat(tfins)


def splat_bwd(data, bg, tfin, g_out, img_h, img_w):
    R, _, n_pad = data.shape
    px, py = _pixels(img_h, img_w, data.device)
    dgrad = torch.zeros_like(data)
    for r0, r1 in _blocks(R, img_h * img_w * n_pad):
        d, g_pix = data[r0:r1], g_out[r0:r1]
        _, log_t, columns, _ = _walk(d, px, py, min(n_pad, CHUNK), True)
        alpha, e, live, contrib, w, t_before, dx, dy = (
            torch.stack(t, -1) for t in zip(*columns))
        del columns
        tb = torch.exp(log_t) * (bg.reshape(1, 3, 1) * g_pix).sum(1)
        cg = torch.einsum("rkp,rkc->rpc", g_pix, d[:, 6:9])
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


class Splat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, bg, img_h, img_w, counter):
        out, tfin = splat_fwd(data, bg, img_h, img_w, counter)
        ctx.save_for_backward(data, bg, tfin)
        ctx.img_hw = (img_h, img_w)
        return out

    @staticmethod
    def backward(ctx, g_out):
        data, bg, tfin = ctx.saved_tensors
        dgrad, dbg = splat_bwd(data, bg, tfin, g_out.contiguous(),
                               *ctx.img_hw)
        return dgrad, dbg, None, None, None


def render_views(g, batch, n_in, img_h, img_w, fov_deg, bg, counter=None):
    """Supervision views [B, V_sup, 3, H, W] of gaussians ``g`` (the
    predictor's dict) against the batch's cameras after the ``n_in``
    conditioning views, in one splat over every (element, view)."""
    tanfov = math.tan(fov_deg * math.pi / 360)
    shs = torch.cat([g["features_dc"], g["features_rest"]], dim=2)
    pg = preprocess(g["xyz"][:, None], g["opacity"][:, None, :, 0],
                    g["scaling"][:, None], g["rotation"][:, None],
                    shs[:, None], batch["world_view_transforms"][:, n_in:],
                    batch["full_proj_transforms"][:, n_in:],
                    batch["camera_centers"][:, n_in:], img_h, img_w, tanfov)
    B, Vs = pg[4].shape[:2]
    flat = [t.expand(B, Vs, *t.shape[2:]).reshape(B * Vs, *t.shape[2:])
            for t in pg]
    data = sorted_table(*flat[:6])
    bg_t = torch.as_tensor(bg, dtype=torch.float32, device=data.device)
    out = Splat.apply(data, bg_t, img_h, img_w, counter)
    return out.reshape(B, Vs, 3, img_h, img_w)


def focal_l2(pred, gt, bg, non_bg_rate, bg_rate):
    bg_t = torch.as_tensor(bg, dtype=gt.dtype, device=gt.device).reshape(
        1, 3, 1, 1)
    pred = pred.reshape(-1, *pred.shape[-3:])
    gt = gt.reshape(-1, *gt.shape[-3:])
    is_bg = ((gt - bg_t).abs() <= 1e-6).all(dim=1, keepdim=True)
    w = torch.where(is_bg, 2.0 * bg_rate / (bg_rate + non_bg_rate),
                    2.0 * non_bg_rate / (bg_rate + non_bg_rate))
    return (((pred - gt) ** 2) * w).mean()


# --------------------------------------------------------------------------
# the tiled renderer (the scene level's route above 4,096 gaussians), a
# frozen copy of the port's plain-PyTorch rasterize_projected
# --------------------------------------------------------------------------

K_CHUNK = 256


def auto_tile(img_h, img_w):
    def pick(s):
        for t in (32, 16, 8, 4):
            if s % t == 0:
                return t
        return 1
    return pick(img_h), pick(img_w)


def tile_origins(img_h, img_w, tile_h, tile_w, device):
    tx = img_w // tile_w
    ids = torch.arange((img_h // tile_h) * tx, device=device)
    return (ids % tx) * tile_w, (ids // tx) * tile_h


def tile_overlap(mean2d, radius, valid, img_h, img_w, tile_h, tile_w):
    x0, y0 = (t.float()[None, :, None] for t in tile_origins(
        img_h, img_w, tile_h, tile_w, mean2d.device))
    r = radius.float()[:, None, :]
    gx, gy = mean2d[..., 0][:, None, :], mean2d[..., 1][:, None, :]
    return ((gx + r >= x0) & (gx - r <= x0 + (tile_w - 1))
            & (gy + r >= y0) & (gy - r <= y0 + (tile_h - 1))
            & valid[:, None, :])


class CompactGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fields, cand, slot_ok):
        ctx.save_for_backward(cand, slot_ok)
        ctx.n = fields.shape[0]
        g = fields[cand]
        return torch.where(slot_ok[..., None], g, torch.zeros_like(g))

    @staticmethod
    def backward(ctx, dg):
        cand, slot_ok = ctx.saved_tensors
        dg = torch.where(slot_ok[..., None], dg, torch.zeros_like(dg))
        out = torch.zeros(ctx.n, dg.shape[-1], dtype=dg.dtype,
                          device=dg.device)
        out.index_add_(0, cand.reshape(-1), dg.reshape(-1, dg.shape[-1]))
        return out, None, None


def chunk_step(rgb, log_t, mean2d, conic, color, opa, px, py):
    dx = mean2d[:, None, :, 0] - px[:, :, None]
    dy = mean2d[:, None, :, 1] - py[:, :, None]
    power = (-0.5 * (conic[:, None, :, 0] * dx * dx
                     + conic[:, None, :, 2] * dy * dy)
             - conic[:, None, :, 1] * dx * dy)
    a = torch.clamp_max(opa[:, None, :] * torch.exp(power), ALPHA_MAX)
    a = torch.where((power > 0.0) | (a < ALPHA_MIN), torch.zeros_like(a), a)
    log_1ma = torch.log1p(-a)
    cum = torch.cumsum(log_1ma, dim=-1) + log_t[..., None]
    contrib = torch.exp(cum) >= T_EPS
    w = torch.where(contrib, a * torch.exp(cum - log_1ma), torch.zeros_like(a))
    rgb = rgb + torch.bmm(w, color)
    log_t = log_t + torch.where(contrib, log_1ma,
                                torch.zeros_like(log_1ma)).sum(-1)
    return rgb, log_t


def rasterize_tiled(mean2d, conic, color, opacity, depth, valid, radius, bg,
                    img_h, img_w, tile_h, tile_w, capacity, counter=None):
    """Renders [R, 3, H, W]: each tile composites the first ``capacity``
    depth-ordered gaussians whose box overlaps it, in 256-wide chunks (each
    chunk recomputed in the backward). ``counter`` gains the (tile,
    gaussian) overlaps past the capacity under ``tile_dropped``."""
    key = torch.where(valid, depth, torch.full_like(depth, float("inf")))
    order = torch.argsort(key, dim=-1, stable=True)

    def take(t):
        return torch.take_along_dim(
            t, order.reshape(*order.shape, *([1] * (t.ndim - 2))), dim=1)
    mean2d, conic, color, opacity, valid, radius = (
        take(t) for t in (mean2d, conic, color, opacity, valid, radius))
    R, N = opacity.shape
    K = min(capacity, N)
    dev = opacity.device
    x0, y0 = tile_origins(img_h, img_w, tile_h, tile_w, dev)
    n_tiles = x0.shape[0]
    overlap = tile_overlap(mean2d.detach(), radius, valid, img_h, img_w,
                           tile_h, tile_w)
    iota = torch.arange(N, device=dev)
    cand = torch.sort(torch.where(overlap, iota, N + iota),
                      dim=-1).indices[..., :K]
    count = overlap.sum(-1)
    if counter is not None:
        counter["tile_dropped"] = counter.get("tile_dropped", 0) + int(
            torch.clamp_min(count - K, 0).sum())
    slot_ok = torch.arange(K, device=dev) < torch.clamp_max(
        count, K)[..., None]
    fields = torch.cat([mean2d, conic, color, opacity[..., None]],
                       dim=-1).reshape(R * N, 9)
    cand = cand + (torch.arange(R, device=dev) * N)[:, None, None]
    g = CompactGather.apply(fields, cand, slot_ok).reshape(R * n_tiles, K, 9)
    t = torch.arange(tile_h * tile_w, device=dev)
    px = (x0[:, None] + t % tile_w).float().repeat(R, 1)
    py = (y0[:, None] + t // tile_w).float().repeat(R, 1)
    kc = min(K_CHUNK, K)
    n_k = -(-K // kc)
    g = torch.nn.functional.pad(g, (0, 0, 0, n_k * kc - K))
    rgb = torch.zeros(R * n_tiles, tile_h * tile_w, 3, device=dev)
    log_t = torch.zeros(R * n_tiles, tile_h * tile_w, device=dev)
    for k in range(n_k):
        s = g[:, k * kc:(k + 1) * kc]
        args = (rgb, log_t, s[..., 0:2], s[..., 2:5], s[..., 5:8], s[..., 8],
                px, py)
        if torch.is_grad_enabled():
            rgb, log_t = checkpoint(chunk_step, *args, use_reentrant=False)
        else:
            rgb, log_t = chunk_step(*args)
    bg_t = torch.as_tensor(bg, dtype=torch.float32, device=dev)
    tiles = rgb + torch.exp(log_t)[..., None] * bg_t
    img = tiles.reshape(R, img_h // tile_h, img_w // tile_w, tile_h, tile_w, 3)
    return img.permute(0, 5, 1, 3, 2, 4).reshape(R, 3, img_h, img_w)


def render_scene_views(g, batch, n_in, img_h, img_w, fov_deg, bg, capacity,
                       counter=None):
    """Supervision views [B, V_sup, 3, H, W] of a scene's gaussians through
    the tiled renderer (``auto_tile`` tiles, ``capacity`` a tile)."""
    tanfov = math.tan(fov_deg * math.pi / 360)
    shs = torch.cat([g["features_dc"], g["features_rest"]], dim=2)
    pg = preprocess(g["xyz"][:, None], g["opacity"][:, None, :, 0],
                    g["scaling"][:, None], g["rotation"][:, None],
                    shs[:, None], batch["world_view_transforms"][:, n_in:],
                    batch["full_proj_transforms"][:, n_in:],
                    batch["camera_centers"][:, n_in:], img_h, img_w, tanfov,
                    mask=g["mask"][:, None])
    B, Vs = pg[4].shape[:2]
    flat = [t.expand(B, Vs, *t.shape[2:]).reshape(B * Vs, *t.shape[2:])
            for t in pg]
    mean2d, conic, color, opacity, depth, valid, radius = flat
    out = rasterize_tiled(mean2d, conic, color, opacity, depth, valid,
                          radius, bg, img_h, img_w,
                          *auto_tile(img_h, img_w), capacity, counter)
    return out.reshape(B, Vs, 3, img_h, img_w)
