#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, all of them, in order; any failure exits non-zero:

1. device: the card's name, the device count, and ``nvidia-smi``'s name and
   power limit.
2. build: compiles the hand-written kernels from ``unipre3d_tpu_torch/csrc``
   and prints ptxas' register, shared-memory and spill report.
3. kernels: holds each kernel to its plain PyTorch version on the card,
   forward and all gradients, at the main-path shape and the other shapes
   its route takes, and times both with CUDA events: the dense splat
   (object path; T and images bit for bit, also on a case built to meet
   the edges of its per-tile cull, whose plain twin must keep every pair
   the card's plain walk does not skip), the binned splat (scene path; T
   and images bit for bit, also on a case built to meet the edges of its
   per-warp cull, whose plain twin must keep every pair the card's plain
   walk does not skip; the warp-column iterations of the first port's
   rows and of the culled patches at the scene shape) and the streaming
   splat (eval and test-video path: the scene load of 16 test views and the
   object orbit's 80 frames, each in one launch, a purpose case of its
   chunk rules and a case built to meet the edges of
   its per-warp cull; T and images bit for bit; the cull's plain twin must
   keep every pair the card's plain walk does not skip; the warp-column
   iterations of the first port's rows and of the culled patches).
4. train: on synthetic data through ``unipre3d_tpu_torch.train_network``,
   each under its own output directory: three full-width
   ``transformer_pretraining`` steps with their val loop, checkpoints and
   test videos (``tpu.raster_impl=pallas``), then ``eval.main`` over that
   run; three full-width ``sparseunet_pretraining`` steps on each of the
   binned route and the ``auto`` route (the tiled renderer). Each path's
   kernel launch counts are set to 0 just before it and read just after,
   and every kernel of the path must have launched. No
   scene step may have a non-finite gradient norm or be skipped by the NaN
   skip.
5. test renders: the object orbit (80 frames) and the test views of a
   test example from the trained run's checkpoint, and the 16 test views of
   a full-width scene at 84,096 slots, through the streaming splat, each
   set of views in one launch, that launch held bit for bit against the
   plain version on its own inputs, and its frames equal bit for bit to one
   launch a view (the scene's also through the tiled renderer), each timed.
6. parity: one train step of a small object and a small scene configuration
   on the card (kernels) against the same step on the CPU (plain versions),
   same weights and batch; for the scene also each SparseUNet/PointFusion
   op over the step's geometry; the streaming splat with its gradients,
   ``render_predicted`` on the ``xla`` and ``pallas`` routes and a small
   object eval step, card against CPU. The streaming backward, which no
   training route runs, takes its launch count from the card-side call of
   the streaming splat with its gradients.

It prints a ``{"kernels": [...]}`` line, then the card's name and power
limit, then as its last line ``{"ok": true, "device": {...}}``. Without a
CUDA device, or without the repository beside it, it exits non-zero and
prints no result. TF32 is off for every phase (``allow_tf32 = False`` for
matmuls and cuDNN), so the float32 comparisons are float32.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

# peak rates of one H100 SXM (NVIDIA data sheet; see PERF.md): float32
# outside the tensor cores, HBM3, and the special-function units
# (16 exp2/log2/rcp per clock per SM x 132 SMs x 1.98 GHz)
PEAK_F32 = 67e12
PEAK_SFU = 16 * 132 * 1.98e9
PEAK_BYTES = 3.35e12

# operations per contributing (pixel, gaussian) pair, counted from
# csrc/splat_dense.cu: (float32 ops, special-function ops)
FWD_OPS_PER_PAIR = (22, 3)     # power 11, alpha/T 5, rgb 3 FMA; exp, log, exp
BWD_OPS_PER_PAIR = (60, 4)     # forward 16 + gradient terms 35 + sums 9; +rcp
# the same count for csrc/splat_binned.cu (its power is evaluated op by op
# without FMA: 2 more), backward with the warp sums of nine rows
BINNED_FWD_OPS_PER_PAIR = (24, 3)
BINNED_BWD_OPS_PER_PAIR = (62, 4)
# csrc/splat_stream.cu does the binned kernels' per-pair arithmetic. Its
# bound counts the contributing pairs only: the pairs a flagged chunk makes
# the plain walk test without compositing are what its per-warp cull
# drops, so the function does not need them
STREAM_FWD_OPS_PER_PAIR = BINNED_FWD_OPS_PER_PAIR
STREAM_BWD_OPS_PER_PAIR = BINNED_BWD_OPS_PER_PAIR

TOL_IMAGE = 1e-4   # max abs error of images and T (pixel values in [0, 1])
TOL_GRAD = 1e-4    # max abs error over max |reference|, per gradient row
# whole step, card vs CPU, per parameter tensor: cuBLAS/cuDNN float32 and
# the kernels' atomics sum in other orders than the CPU
TOL_STEP_GRAD = 1e-3
# the scene step's parameter gradients, card vs CPU, relative L2 over all
# of them. Not entry by entry: the card's float32 forward differs from the
# CPU's (the predicted gaussians by up to ~1e-4 relative), and a random
# SparseUNet holds ReLU inputs within ~1e-6 of their layer's largest, so a
# few flip and move the gradients below them by 1-10% entry by entry
# (tools/scene_grad_sensitivity.py, PERF.md). Reading 1.1e-2 on an H100;
# each op of the backbone is held entry by entry instead.
TOL_SCENE_PARAM_L2 = 5e-2


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_timed(fn):
    """One call of ``fn`` between two CUDA events -> (its result, ms)."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def random_gaussians(R, N, H, W, g, invalid=0.1):
    """Random projected gaussians in pixel space, drawn from the generator
    ``g``: sizes from sub-pixel to a sixth of the image, 10% at opacity 1
    (the 0.99 cap), a share ``invalid`` invalid. Returns (mean2d, conic,
    color, opacity, depth, radius (3 sigma), valid), each [R, N, ...] on
    the CPU."""
    import torch
    u = lambda *s: torch.rand(*s, generator=g)
    mean2d = torch.stack([u(R, N) * 1.2 * W - 0.1 * W,
                          u(R, N) * 1.2 * H - 0.1 * H], -1)
    sig = torch.exp(math.log(0.5) + u(R, N, 2) * math.log(max(H, W) / 3.0))
    th = u(R, N) * math.pi
    c, s = torch.cos(th), torch.sin(th)
    sxx = (c * sig[..., 0]) ** 2 + (s * sig[..., 1]) ** 2 + 0.3
    syy = (s * sig[..., 0]) ** 2 + (c * sig[..., 1]) ** 2 + 0.3
    sxy = c * s * (sig[..., 0] ** 2 - sig[..., 1] ** 2)
    det = sxx * syy - sxy * sxy
    conic = torch.stack([syy / det, -sxy / det, sxx / det], -1)
    opacity = torch.where(u(R, N) < 0.1, torch.ones(R, N),
                          0.2 + 0.79 * u(R, N))
    color = u(R, N, 3)
    depth = u(R, N) + 0.5
    v = u(R, N)
    valid = v > invalid if invalid else torch.ones(R, N, dtype=torch.bool)
    mid = 0.5 * (sxx + syy)
    radius = torch.ceil(3.0 * torch.sqrt(
        mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))))
    return mean2d, conic, color, opacity, depth, radius, valid


def make_case(R, N, H, W, seed, device):
    """Random projected gaussians (``random_gaussians``), depth-sorted and
    packed for the dense splat. Returns (data [R,16,N_pad], bg [3],
    g_out)."""
    import torch
    from unipre3d_tpu_torch.ops.rasterizer.splat_dense import sorted_table
    g = torch.Generator().manual_seed(seed)
    mean2d, conic, color, opacity, depth, _, valid = random_gaussians(
        R, N, H, W, g)
    data = sorted_table(mean2d, conic, color, opacity, depth, valid)
    bg = torch.tensor([0.1, 0.2, 0.3])
    g_out = torch.randn(R, 3, H * W, generator=g)
    return data.to(device), bg.to(device), g_out.to(device)


def cull_edge_gaussians(R, N, H, W, g, cell=(16, 16)):
    """Projected gaussians built to meet the edges of the kernels' cull,
    drawn from the generator ``g``, one kind per render in turn: thin
    rotated ellipses (large |B|), opacity 1 (the 0.99 cap), sub-pixel
    sigmas, centres outside the image, and isotropic gaussians whose 1/255
    level set grazes a corner pixel of a ``cell`` (x, y) from outside (the
    dense kernels' 16x16 tile, the binned kernels' 8x4 warp patch, the
    streaming kernels' 8x8; radius jittered by +-1e-4). Returns (mean2d,
    conic, color, opacity, depth, radius (3 sigma), valid) like
    ``random_gaussians``."""
    import torch
    u = lambda lo, hi, *s: lo + (hi - lo) * torch.rand(*s, generator=g)
    lu = lambda lo, hi, *s: torch.exp(u(math.log(lo), math.log(hi), *s))
    mean2d = torch.stack([u(-8, W + 8, R, N), u(-8, H + 8, R, N)], -1)
    sig = lu(0.7, 20.0, R, N, 2)
    th = u(0, math.pi, R, N)
    opacity = u(0.02, 0.99, R, N)
    kind = torch.arange(R)[:, None].expand(R, N) % 5
    thin = torch.stack([lu(0.1, 0.5, R, N), lu(10.0, 60.0, R, N)], -1)
    sig = torch.where((kind == 0)[..., None], thin, sig)
    opacity = torch.where(kind == 1, torch.ones_like(opacity), opacity)
    sig = torch.where((kind == 2)[..., None], lu(0.05, 0.6, R, N, 2), sig)
    side = torch.randint(0, 4, (R, N), generator=g)
    off = u(1, 60, R, N)
    out_x = torch.where(side == 0, -off, torch.where(
        side == 1, W - 1 + off, mean2d[..., 0]))
    out_y = torch.where(side == 2, -off, torch.where(
        side == 3, H - 1 + off, mean2d[..., 1]))
    mean2d = torch.where((kind == 3)[..., None],
                         torch.stack([out_x, out_y], -1), mean2d)
    sig = torch.where((kind == 3)[..., None], 2 * sig, sig)
    # corner-grazed: the level set o exp(-r^2 / 2 s^2) = 1/255 through a
    # cell's corner pixel, the centre outside that cell
    graze = kind == 4
    sig = torch.where(graze[..., None], sig[..., :1].expand(R, N, 2), sig)
    th = torch.where(graze, torch.zeros_like(th), th)
    cell = torch.tensor(cell)
    lim = torch.tensor([W, H]) // cell
    corner = (torch.randint(1, 2 ** 20, (R, N, 2), generator=g) % lim) \
        * cell + torch.randint(0, 2, (R, N, 2), generator=g) * (cell - 1)
    sgn = torch.where(corner % cell == cell - 1, 1.0, -1.0)
    ang = u(0.05, math.pi / 2 - 0.05, R, N)
    rad = sig[..., 0] * torch.sqrt(2 * torch.log(255 * opacity)) \
        * u(1 - 1e-4, 1 + 1e-4, R, N)
    at_corner = corner + sgn * torch.stack(
        [torch.cos(ang), torch.sin(ang)], -1) * rad[..., None]
    mean2d = torch.where(graze[..., None], at_corner, mean2d)
    c, s = torch.cos(th), torch.sin(th)
    sxx = (c * sig[..., 0]) ** 2 + (s * sig[..., 1]) ** 2
    syy = (s * sig[..., 0]) ** 2 + (c * sig[..., 1]) ** 2
    sxy = c * s * (sig[..., 0] ** 2 - sig[..., 1] ** 2)
    det = sxx * syy - sxy * sxy
    conic = torch.stack([syy / det, -sxy / det, sxx / det], -1)
    mid = 0.5 * (sxx + syy)
    radius = torch.ceil(3.0 * torch.sqrt(
        mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))))
    return (mean2d, conic, u(0, 1, R, N, 3), opacity, u(0.5, 1.5, R, N),
            radius, torch.ones(R, N, dtype=torch.bool))


def cull_edge_case(R, H, W, seed, device):
    """A table [R,16,128] of ``cull_edge_gaussians`` aimed at the dense
    kernels' 16x16 tiles. Returns (data, bg, g_out) like ``make_case``."""
    import torch
    from unipre3d_tpu_torch.ops.rasterizer.splat_dense import sorted_table
    g = torch.Generator().manual_seed(seed)
    mean2d, conic, color, opacity, depth, _, valid = cull_edge_gaussians(
        R, 128, H, W, g)
    data = sorted_table(mean2d, conic, color, opacity, depth, valid)
    bg = torch.tensor([0.1, 0.2, 0.3])
    g_out = torch.randn(R, 3, H * W, generator=g)
    return data.to(device), bg.to(device), g_out.to(device)


def contributing_pairs(data, H, W):
    """(pixel, gaussian) pairs that contribute in this run's data (what any
    renderer must composite), from the plain version's walk."""
    import torch
    from unipre3d_tpu_torch.ops.rasterizer import splat_dense as sd
    px, py = sd._pixels(H, W, data.device)
    total = 0
    for r0, r1 in sd._render_blocks(data.shape[0], H * W * data.shape[-1]):
        n = torch.zeros((), dtype=torch.int64, device=data.device)
        _, _, cols = sd._walk(data[r0:r1], px, py,
                              sd.chunk_of(data.shape[-1]), keep_columns=True)
        for col in cols:
            n += col[3].sum()
        total += int(n)
        del cols
    return total


def bound(nbytes, pairs, per_pair):
    """Least time (ms) and what sets it: ``nbytes`` at the memory rate, or
    ``pairs`` contributing pairs at ``per_pair`` (float32, special-function)
    operations each, at the float32 and SFU peaks."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = max(pairs * per_pair[0] / PEAK_F32, pairs * per_pair[1] / PEAK_SFU)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernels(device):
    """Each dense kernel against its plain version at three shapes and a
    case built to meet the edges of the kernels' per-tile cull: T and
    images bit for bit, gradients to TOL_GRAD."""
    import torch
    from unipre3d_tpu_torch.ops.rasterizer import splat_dense as sd

    shapes = [  # (R, N, H, W): main path, multi-chunk, top of the route,
        # cull edges (N = 0: cull_edge_case)
        (128, 128, 128, 128), (8, 1000, 128, 128), (4, 4096, 128, 128),
        (8, 0, 128, 128)]
    results = {}
    for si, (R, N, H, W) in enumerate(shapes):
        if N:
            data, bg, g_out = make_case(R, N, H, W, seed=si, device=device)
        else:
            data, bg, g_out = cull_edge_case(R, H, W, seed=si, device=device)
        n_pad = data.shape[-1]
        out, tfin = sd.dense_fwd(data, bg, H, W)
        dgrad, dbg = sd.dense_bwd(data, bg, out, tfin, g_out, H, W)
        torch.cuda.synchronize()
        out_r, tfin_r = sd.dense_splat_fwd_ref(data, bg, H, W)
        dgrad_r, dbg_r = sd.dense_splat_bwd_ref(data, bg, tfin_r, g_out, H, W)
        err_out = float((out - out_r).abs().max())
        err_t = float((tfin - tfin_r).abs().max())
        t_mismatch = int((tfin != tfin_r).sum())
        img_mismatch = int((out != out_r).sum())
        row_err = [float((dgrad[:, k] - dgrad_r[:, k]).abs().max()
                         / (dgrad_r[:, k].abs().max() + 1e-12))
                   for k in range(9)]
        err_bg = float((dbg - dbg_r).abs().max() / (dbg_r.abs().max() + 1e-12))
        abs_bwd = max(float((dgrad - dgrad_r).abs().max()),
                      float((dbg - dbg_r).abs().max()))
        fwd_ok = err_out <= TOL_IMAGE and err_t <= TOL_IMAGE and \
            t_mismatch == 0 and img_mismatch == 0
        bwd_ok = max(row_err) <= TOL_GRAD and err_bg <= TOL_GRAD
        log(f"[kernels] {'' if N else 'cull edges: '}R={R} N={N} (N_pad "
            f"{n_pad}) {H}x{W}: fwd max|err| out {err_out:.3e} T {err_t:.3e} "
            f"(bit-mismatches T {t_mismatch}, images {img_mismatch}; "
            f"must be 0) tol {TOL_IMAGE:g}; bwd max rel err per row "
            f"{max(row_err):.3e} ({', '.join(f'{e:.1e}' for e in row_err)}) "
            f"dbg {err_bg:.3e} tol {TOL_GRAD:g}; bwd max|err| {abs_bwd:.3e}")
        if not (fwd_ok and bwd_ok):
            raise AssertionError(f"kernel disagrees with its plain version "
                                 f"at R={R} N={N}")
        if not N:
            # the cull's twin keeps every pair the card's plain walk does
            # not skip (alpha != 0) on the pair's tile
            surv = sd.tile_survivors_ref(data, H, W)
            px, py = sd._pixels(H, W, device)
            _, _, cols = sd._walk(data, px, py, sd.chunk_of(n_pad),
                                  keep_columns=True)
            live = torch.stack([col[0] != 0 for col in cols], -1)
            del cols
            tile = (py.long() // sd.TILE) * (-(-W // sd.TILE)) \
                + px.long() // sd.TILE
            missed = int((live & ~surv[:, tile, :]).sum())
            log(f"[kernels] cull edges: {int(live.sum())} live pairs, "
                f"{int(surv.sum())} (tile, column) survivors of "
                f"{surv.numel()}, live pairs outside them {missed} (must "
                f"be 0)")
            if missed:
                raise AssertionError("the per-tile cull drops live pairs")
            del surv, live
        if si == 0:  # the main-path shape: time and bound
            it_k, it_p = 50, 3
            ms_f = cuda_ms(lambda: sd.dense_fwd(data, bg, H, W), it_k)
            ms_b = cuda_ms(lambda: sd.dense_bwd(data, bg, out, tfin, g_out,
                                                H, W), it_k)
            pms_f = cuda_ms(lambda: sd.dense_splat_fwd_ref(data, bg, H, W),
                            it_p)
            pms_b = cuda_ms(lambda: sd.dense_splat_bwd_ref(
                data, bg, tfin_r, g_out, H, W), it_p)
            pairs = contributing_pairs(data, H, W)
            # the cull's survivors, counted on the card by its plain twin
            surv = sd.tile_survivors_ref(data, H, W).sum(-1)  # [R, tiles]
            evaluated = int(surv.sum()) * sd.TILE * sd.TILE
            log(f"[kernels] main shape: survivors of the per-tile cull "
                f"{float(surv.float().mean()):.2f} a tile (max "
                f"{int(surv.max())}) of {n_pad} columns; pairs evaluated "
                f"(survivors x tile pixels) {evaluated} against "
                f"{R * H * W * n_pad} unculled")
            del surv
            # bytes: only table rows 0-8 are read, and only rows 0-8 of
            # dgrad are written. Forward: table + bg in, out (3 planes) and
            # tfin (1) out. Backward: table, out and g_out in (dbg's T_final
            # follows from the table, so tfin is not counted), dgrad out.
            tab = R * 9 * n_pad * 4
            img = R * H * W * 4
            bf, byf = bound(tab + 12 + 4 * img, pairs, FWD_OPS_PER_PAIR)
            bb, byb = bound(2 * tab + 6 * img, pairs, BWD_OPS_PER_PAIR)
            log(f"[kernels] main shape: {pairs} contributing pairs; fwd "
                f"{ms_f:.4f} ms (plain {pms_f:.3f}, bound {bf:.4f} by {byf});"
                f" bwd {ms_b:.4f} ms (plain {pms_b:.3f}, bound {bb:.4f} by "
                f"{byb})")
            results["fwd"] = dict(ms=ms_f, plain_ms=pms_f, bound_ms=bf,
                                  bound_by=byf)
            results["bwd"] = dict(ms=ms_b, plain_ms=pms_b, bound_ms=bb,
                                  bound_by=byb)
        results.setdefault("fwd_err", 0.0)
        results["fwd_err"] = max(results["fwd_err"], err_out, err_t)
        results.setdefault("bwd_err", 0.0)
        results["bwd_err"] = max(results["bwd_err"], abs_bwd)
        del data, out, tfin, dgrad, out_r, tfin_r, dgrad_r
        torch.cuda.empty_cache()
    return results


def binned_case(R, N, H, W, seed, device, invalid=0.0, dup_budget=None,
                max_per_tile=4096, edges=False):
    """Random gaussians (``random_gaussians``, or with ``edges``
    ``cull_edge_gaussians`` aimed at the kernels' 4x8 warp patches) on the
    card, their sorted duplicate list and table at the binned route's
    tiles, bg and a random cotangent. Returns a dict."""
    import torch
    from unipre3d_tpu_torch.ops.rasterizer import splat_binned as sb
    from unipre3d_tpu_torch.ops.rasterizer.render import binned_tile
    g = torch.Generator().manual_seed(seed)
    gs = cull_edge_gaussians(R, N, H, W, g, (sb.PATCH_W, sb.PATCH_H)) \
        if edges else random_gaussians(R, N, H, W, g, invalid)
    gs = [t.to(device) for t in gs]
    mean2d, conic, color, opacity, depth, radius, valid = gs
    th, tw = binned_tile(H, W)
    n_tiles = (H // th) * (W // tw)
    budget = dup_budget or sb.default_dup_budget(N, n_tiles)
    maxn = sb.max_per_tile_cap(max_per_tile)
    dup = sb.prep_duplicates(mean2d, radius, depth, valid, H, W, th, tw,
                             budget)
    table = sb.gaussian_rows(mean2d, conic, color, opacity,
                             valid)[dup.gid].t().contiguous()
    return dict(gs=gs, dup=dup, table=table, th=th, tw=tw, maxn=maxn,
                budget=budget, bg=torch.tensor([0.1, 0.2, 0.3], device=device),
                g_out=torch.randn(R, 3, H, W, generator=g).to(device),
                **{k: int(v) for k, v in sb.duplicate_stats(dup, maxn).items()})


def binned_work(seg, table, R, H, W, th, tw, maxn):
    """What this run's data needs of the binned kernels, from the plain
    version's walk, and what their per-warp cull makes of it, as a dict:
    ``pairs`` contributing (pixel, duplicate) pairs; ``cols`` table columns
    a tile must read (in each 1024-chunk of its capped list those up to the
    one where its last pixel stops) of ``capped`` within the caps;
    warp-column iterations (a warp walks a column while some pixel of it
    has not stopped in the chunk) of 1x32 pixel rows walking every column
    (``iters_rows``, the first port's kernels) and of the kernels' warp
    patches walking the columns that the cull's plain twin keeps
    (``iters_patches``); ``live`` pairs the walk does not skip (alpha !=
    0), ``missed`` of them dropped by the twin for the pixel's warp."""
    import torch
    import torch.nn.functional as F
    from unipre3d_tpu_torch.ops.rasterizer import splat_binned as sb
    from unipre3d_tpu_torch.ops.rasterizer.pack import LOG_T_EPS
    dev = table.device
    px, py, _ = sb._tile_pixels(R, H, W, th, tw, dev)
    count = (seg[1:] - seg[:-1]).long().clamp(max=maxn)
    bits = F.pad(sb.patch_survivors_ref(seg, table, R, H, W, th, tw, maxn),
                 (0, 1))                                # + the dump column
    warp = sb.warp_of_pixel(th, tw).to(dev)
    shift = torch.arange(int(warp.max()) + 1, device=dev)
    rows = F.one_hot(torch.arange(th * tw, device=dev) // 32).float()
    patches = F.one_hot(warp).float()
    n = {k: torch.zeros((), dtype=torch.int64, device=dev) for k in (
        "pairs", "cols", "iters_rows", "iters_patches", "live", "missed")}
    log_t = torch.zeros_like(px)
    stopped = torch.zeros_like(px, dtype=torch.bool)
    for j, (col, _, terms, log_t_after) in enumerate(
            sb._walk(seg, sb._padded(table), px, py, maxn)):
        alpha, skip, contrib = terms[0], terms[4], terms[5]
        if j % sb.CHUNK == 0:
            stopped = torch.zeros_like(stopped)
        walking = (~stopped & (j < count)[:, None]).float()
        n["cols"] += ((j < count) & ~stopped.all(1)).sum()
        n["iters_rows"] += ((walking @ rows) > 0).sum()
        kept = (bits[col][:, None] >> shift) & 1
        n["iters_patches"] += (((walking @ patches) > 0) & (kept == 1)).sum()
        n["live"] += (~skip).sum()
        n["missed"] += (~skip & ((bits[col][:, None] >> warp) & 1 == 0)).sum()
        stopped = stopped | (~skip & (log_t + torch.log1p(-alpha) < LOG_T_EPS))
        log_t = log_t_after
        n["pairs"] += contrib.sum()
    return {"capped": int(count.sum()), **{k: int(v) for k, v in n.items()}}


def fully_dropped(dup, maxn, n_rows):
    """[n_rows] bool: gaussian rows of which no duplicate is composited
    (all dropped by the budget or past their tiles' caps)."""
    import torch
    D = dup.gid.shape[0]
    pos = torch.arange(D, device=dup.gid.device)
    tile = torch.searchsorted(dup.seg.long(), pos, right=True) - 1
    kept = dup.gid[pos - dup.seg.long()[tile] < maxn]
    hit = torch.zeros(n_rows, dtype=torch.bool, device=dup.gid.device)
    hit[kept] = True
    return ~hit


def phase_binned_kernels(device):
    """The binned kernels against their plain versions at four shapes: the
    scene renderer's load (8 views, 84,096 valid gaussians, 120x160), a
    case past the per-tile cap and the budget, a small case whose tiles
    hold more than 1024 duplicates (chunk re-arm), and a case built to meet
    the edges of the kernels' per-warp cull (``cull_edge_gaussians`` at the
    scene's shape, two renders of each kind), whose plain twin must keep
    every pair the card's plain walk does not skip. T and images bit for
    bit, gradients to TOL_GRAD."""
    import torch
    from unipre3d_tpu_torch.ops.rasterizer import splat_binned as sb

    shapes = [  # (label, R, N, H, W, invalid, budget, max_per_tile)
        ("scene", 8, 84096, 120, 160, 0.0, None, 4096),
        ("overflow", 2, 20000, 120, 160, 0.1, 160 * 1024, 1024),
        ("re-arm", 1, 3000, 32, 32, 0.1, None, 4096),
        ("cull edges", 10, 512, 120, 160, 0.0, 48 * 1024, 4096)]
    results = {"fwd_err": 0.0, "bwd_err": 0.0}
    for si, (label, R, N, H, W, invalid, budget, cap) in enumerate(shapes):
        c = binned_case(R, N, H, W, 100 + si, device, invalid, budget, cap,
                        edges=label == "cull edges")
        seg, table, bg, g_out = c["dup"].seg, c["table"], c["bg"], c["g_out"]
        th, tw, maxn = c["th"], c["tw"], c["maxn"]
        args = (R, H, W, th, tw, maxn)
        out, logt = sb.binned_fwd(seg, table, bg, *args)
        tot = (g_out * (out - bg.reshape(1, 3, 1, 1)
                        * torch.exp(logt)[:, None])).sum(1)
        dgrad = sb.binned_bwd(seg, table, bg, logt, tot, g_out, *args)
        torch.cuda.synchronize()
        out_r, logt_r = sb.binned_fwd_ref(seg, table, bg, *args)
        dgrad_r = sb.binned_bwd_ref(seg, table, bg, logt_r, tot, g_out, *args)
        err_out = float((out - out_r).abs().max())
        err_t = float((torch.exp(logt) - torch.exp(logt_r)).abs().max())
        t_mismatch = int((logt != logt_r).sum())
        img_mismatch = int((out != out_r).sum())
        row_err = [float((dgrad[k] - dgrad_r[k]).abs().max()
                         / (dgrad_r[k].abs().max() + 1e-12))
                   for k in range(9)]
        abs_bwd = float((dgrad - dgrad_r).abs().max())
        log(f"[kernels] binned {label}: R={R} N={N} {H}x{W} tiles {th}x{tw} "
            f"cap {maxn} budget {c['budget']}: {c['dups']} duplicates "
            f"(budget dropped {c['budget_dropped']}, cap dropped "
            f"{c['cap_dropped']}); fwd max|err| out {err_out:.3e} T "
            f"{err_t:.3e} (bit-mismatches T {t_mismatch}, images "
            f"{img_mismatch}; must be 0) tol {TOL_IMAGE:g}; "
            f"bwd max rel err per row {max(row_err):.3e} "
            f"({', '.join(f'{e:.1e}' for e in row_err)}) tol {TOL_GRAD:g}; "
            f"bwd max|err| {abs_bwd:.3e}")
        if not (err_out <= TOL_IMAGE and err_t <= TOL_IMAGE
                and t_mismatch == 0 and img_mismatch == 0
                and max(row_err) <= TOL_GRAD):
            raise AssertionError(f"binned kernel disagrees with its plain "
                                 f"version ({label})")
        results["fwd_err"] = max(results["fwd_err"], err_out, err_t)
        results["bwd_err"] = max(results["bwd_err"], abs_bwd)
        longest = int((seg[1:] - seg[:-1]).max())
        if (label == "overflow" and not (c["budget_dropped"] > 0
                                         and c["cap_dropped"] > 0)) or \
                (label == "re-arm" and longest <= sb.CHUNK):
            raise AssertionError(f"binned case {label} misses its purpose "
                                 f"(longest tile list {longest})")
        if label == "overflow":
            # the whole autograd path: finite, and exactly 0 for gaussians
            # none of whose duplicates is composited
            gs = [t.clone().requires_grad_(k in (0, 1, 2, 3))
                  for k, t in enumerate(c["gs"])]
            img = sb.rasterize_projected_binned(
                *gs, bg, H, W, th, tw, max_per_tile=maxn, dup_budget=budget)
            (img * g_out).sum().backward()
            dropped = fully_dropped(c["dup"], maxn, R * N).reshape(R, N)
            grads = [gs[k].grad for k in range(4)]
            finite = all(bool(torch.isfinite(x).all()) for x in grads)
            zero = all(bool((x[dropped] == 0).all()) for x in grads)
            log(f"[kernels] binned {label}: {int(dropped.sum())} gaussians "
                f"fully dropped; gradients finite {finite}, exactly 0 on "
                f"the dropped {zero}")
            if not (finite and zero):
                raise AssertionError("binned gradients past the cap")
        if label in ("scene", "cull edges"):
            # the cull's plain twin keeps every pair the card's plain walk
            # does not skip; the warp-column iterations of the first port's
            # rows and of the kernels' culled patches
            work = binned_work(seg, table, *args)
            log(f"[kernels] binned {label}: {work['live']} pairs not skipped "
                f"by the plain walk, dropped by the twin of the per-warp "
                f"cull {work['missed']} (must be 0); warp-column iterations "
                f"{work['iters_rows']} in 1x32 rows unculled (the first "
                f"port), {work['iters_patches']} in 4x8 patches culled "
                f"({work['iters_rows'] / max(work['iters_patches'], 1):.2f}x"
                f" fewer); {work['pairs']} contributing pairs")
            if work["missed"]:
                raise AssertionError("the per-warp cull drops live pairs")
        if label == "scene":
            it_k = 20
            ms_f = cuda_ms(lambda: sb.binned_fwd(seg, table, bg, *args), it_k)
            ms_b = cuda_ms(lambda: sb.binned_bwd(seg, table, bg, logt, tot,
                                                 g_out, *args), it_k)
            pms_f = cuda_ms(lambda: sb.binned_fwd_ref(seg, table, bg, *args), 1)
            pms_b = cuda_ms(lambda: sb.binned_bwd_ref(
                seg, table, bg, logt_r, tot, g_out, *args), 1)
            pairs, cols, capped = (work[k] for k in ("pairs", "cols",
                                                     "capped"))
            # bytes: rows 0-8 of the table columns the data needs (each
            # chunk up to its tile's last stop; the rest of a tile's list,
            # the duplicates past its cap, are never read) and seg, read
            # once; bg; the forward writes out (3 planes) and log T; the
            # backward reads log T, tot and g_out (5 planes) and writes
            # rows 0-8 of dgrad for the same columns
            tab = 9 * cols * 4
            fixed = seg.numel() * 4 + 12
            img = R * H * W * 4
            bf, byf = bound(tab + fixed + 4 * img, pairs,
                            BINNED_FWD_OPS_PER_PAIR)
            bb, byb = bound(2 * tab + fixed + 5 * img, pairs,
                            BINNED_BWD_OPS_PER_PAIR)
            log(f"[kernels] binned scene shape: {pairs} contributing pairs; "
                f"table columns needed {cols} of {capped} within the caps "
                f"({c['dups']} in the list); fwd {ms_f:.4f} ms (plain "
                f"{pms_f:.3f}, bound {bf:.5f} by {byf}); bwd {ms_b:.4f} ms "
                f"(plain {pms_b:.3f}, bound {bb:.5f} by {byb})")
            results["fwd"] = dict(ms=ms_f, plain_ms=pms_f, bound_ms=bf,
                                  bound_by=byf)
            results["bwd"] = dict(ms=ms_b, plain_ms=pms_b, bound_ms=bb,
                                  bound_by=byb)
        del c, out, logt, dgrad, out_r, logt_r, dgrad_r
        torch.cuda.empty_cache()
    return results


def stream_case(R, N, H, W, seed, device, invalid=0.0):
    """Random gaussians (``random_gaussians``) on the card, depth-sorted
    into the streaming splat's table with its chunk bitmap at ``auto_tile``
    tiles, bg and a random cotangent. Returns a dict."""
    import torch
    from unipre3d_tpu_torch.ops.rasterizer.preprocess import \
        ProjectedGaussians
    g = torch.Generator().manual_seed(seed)
    pg = ProjectedGaussians(*(t.to(device) for t in random_gaussians(
        R, N, H, W, g, invalid)))
    return stream_tables(pg, H, W, device,
                         torch.randn(R, 3, H, W, generator=g))


def stream_tables(pg, H, W, device, g_out):
    """The streaming splat's inputs of projected gaussians [R, N, ...] at
    ``auto_tile`` tiles, with bg and the cotangent ``g_out``, as a dict."""
    import torch
    from unipre3d_tpu_torch.ops.rasterizer import splat_stream as ss
    from unipre3d_tpu_torch.ops.rasterizer.render import auto_tile
    th, tw = auto_tile(H, W)
    table, flags, s = ss.stream_inputs(pg, H, W, th, tw)
    return dict(table=table, flags=flags, mean2d=s.mean2d, radius=s.radius,
                valid=s.valid, th=th, tw=tw, H=H, W=W,
                bg=torch.tensor([0.1, 0.2, 0.3], device=device),
                g_out=g_out.to(device))


def purpose_case(device):
    """One 64x64 view (32x32 tiles: columns x 0-31 and 32-63), 2,048
    gaussians in depth order, four chunks: chunk 0 ends with three opaque
    broad gaussians at (20, 10) that stop the pixels around them; chunk 1
    offers alpha-0.5 gaussians at the same place (the re-arm); chunk 2 lies
    in tile column 1 only (column 0's chunk 2 unflagged between flagged 1
    and 3); chunk 3 holds small gaussians in column 1 and, first, a broad
    one (sigma 20) left of the image whose 3-sigma bbox ends at x = 31, in
    column 0, yet which adds colour at x = 32, in column 1."""
    import numpy as np
    import torch
    from unipre3d_tpu_torch.ops.rasterizer.preprocess import \
        ProjectedGaussians
    rng = np.random.default_rng(11)
    n = 2048
    mean = np.zeros((n, 2))
    sigma = np.full(n, 0.5)
    opa = rng.uniform(0.2, 0.6, n)
    mean[:509] = rng.uniform([2, 2], [28, 62], (509, 2))
    opa[:509] = 0.0                            # chunk 0 filler: flags only
    mean[509:1024] = [20.0, 10.0]
    sigma[509:1024] = 8.0
    opa[509:512] = [0.9, 0.95, 1.0]
    opa[512:1024] = 0.5
    mean[1024:1536] = rng.uniform([50, 2], [62, 62], (512, 2))
    mean[1536] = [-30.0, 40.0]
    sigma[1536] = 20.0
    opa[1536] = 0.9
    mean[1537:] = rng.uniform([40, 2], [62, 62], (511, 2))
    var = sigma ** 2 + 0.3
    radius = np.ceil(3 * np.sqrt(var + np.sqrt(0.1)))
    assert -30.0 + radius[1536] == 31.0        # the broad bbox's right edge
    f = lambda a: torch.tensor(a, dtype=torch.float32)[None]  # noqa: E731
    pg = ProjectedGaussians(
        f(mean), f(np.stack([1 / var, np.zeros(n), 1 / var], -1)),
        f(rng.uniform(0, 1, (n, 3))), f(opa), f(1.0 + 1e-3 * np.arange(n)),
        torch.tensor(radius, dtype=torch.int32)[None],
        torch.ones(1, n, dtype=torch.bool))
    g_out = torch.randn(1, 3, 64, 64,
                        generator=torch.Generator().manual_seed(12))
    return stream_tables(ProjectedGaussians(*(t.to(device) for t in pg)),
                         64, 64, device, g_out)


def stream_work(c, stats):
    """What this run's data does in the streaming kernels, from the tally
    ``stats`` of the plain forward's walk (splat_stream._walk, with the
    cull's twin): contributing (pixel, gaussian) pairs; pairs evaluated
    (each flagged chunk up to each pixel's stop in it); pixels that
    contribute in a chunk after stopping in an earlier one (the re-arm);
    (tile, gaussian) pairs where a gaussian whose bbox misses the tile
    contributes to one of its pixels; tiles with an unflagged chunk
    between two flagged ones; the table columns of the chunks some tile of
    their render flags (what the kernels must read); the warp-column
    iterations unculled and culled, the culled groups, the live pairs and
    those the twin misses (``_walk``)."""
    import torch
    from unipre3d_tpu_torch.ops.rasterizer import splat_stream as ss
    flags = c["flags"]
    ov = ss.tile_overlap(c["mean2d"], c["radius"], c["valid"], c["H"],
                         c["W"], c["th"], c["tw"])
    outside = (stats["hit"][..., :ov.shape[-1]] & ~ov).sum()
    f = flags.bool()
    seen = torch.cummax(f.int(), -1).values.bool()      # a flag at or before
    ahead = torch.flip(torch.cummax(torch.flip(f.int(), [-1]), -1).values,
                       [-1]).bool()                     # a flag at or after
    gap = (~f[..., 1:-1] & seen[..., :-2] & ahead[..., 2:]).any(-1)
    cols = int(f.any(1).sum()) * ss.CHUNK
    return dict(outside=int(outside), gap_tiles=int(gap.sum()), cols=cols,
                **{k: int(stats[k]) for k in (
                    "pairs", "evaluated", "rearm", "iters_rows",
                    "iters_patches", "groups", "live", "missed")})


def stream_edge_case(device):
    """The streaming kernels' cull-edge case: ``cull_edge_gaussians`` aimed
    at the 8x8 warp patches of the scene's 8x32 tiles, 10 renders (two of
    each kind) of 1,200 gaussians (three chunks) at 120x160."""
    import torch
    from unipre3d_tpu_torch.ops.rasterizer import splat_stream as ss
    from unipre3d_tpu_torch.ops.rasterizer.preprocess import \
        ProjectedGaussians
    g = torch.Generator().manual_seed(202)
    pg = ProjectedGaussians(*(t.to(device) for t in cull_edge_gaussians(
        10, 1200, 120, 160, g, (ss.PATCH, ss.PATCH))))
    return stream_tables(pg, 120, 160, device,
                         torch.randn(10, 3, 120, 160, generator=g))


def phase_stream_kernels(device):
    """The streaming kernels against their plain versions at four shapes:
    (a) the scene load, the 16 test views of a scene in one launch, 84,096
    valid gaussians at 120x160 (8x32 tiles), what a ScanNet scene gives
    them; (b) the object orbit shape, its 80 frames in one launch, N = 128
    at 128x128 (32x32 tiles); (c) the purpose case
    (``purpose_case``); (d) the cull-edge case (``stream_edge_case``).
    Image and T bit for bit, the nine gradient rows and dbg to TOL_GRAD;
    at (a) and (d) the plain twin of the kernels' per-warp cull must keep
    every pair the card's plain walk does not skip, and the warp-column
    iterations of the first port's 1x32 rows and of the culled 8x8 patches
    are counted; times and bounds at (a) and (b)."""
    import torch
    from unipre3d_tpu_torch.ops.rasterizer import splat_stream as ss
    cases = [("scene", lambda: stream_case(16, 84096, 120, 160, 200,
                                           device)),
             ("orbit", lambda: stream_case(80, 128, 128, 128, 201, device,
                                           invalid=0.1)),
             ("purpose", lambda: purpose_case(device)),
             ("cull edges", lambda: stream_edge_case(device))]
    results = {"fwd_err": 0.0, "bwd_err": 0.0}
    for label, make in cases:
        c = make()
        table, flags, bg, g_out = c["table"], c["flags"], c["bg"], c["g_out"]
        args = (c["H"], c["W"], c["th"], c["tw"])
        R, _, n_pad = table.shape
        out, logt = ss.stream_fwd(table, flags, bg, *args)
        tot = (g_out * (out - bg.reshape(1, 3, 1, 1)
                        * torch.exp(logt)[:, None])).sum(1)
        dgrad = ss.stream_bwd(table, flags, bg, logt, tot, g_out, *args)
        # the plain versions walk every column one at a time (~40 and ~90 s
        # at 8 views of the scene load): one timed call each gives both
        # result and time
        (out_r, logt_r), pms_f = cuda_timed(
            lambda: ss.stream_fwd_ref(table, flags, bg, *args))
        dgrad_r, pms_b = cuda_timed(lambda: ss.stream_bwd_ref(
            table, flags, bg, logt_r, tot, g_out, *args))
        # the work the data makes the kernels do, in a second (untimed)
        # plain forward that tallies its walk against the cull's plain twin
        stats = {"survivors": ss.patch_survivors_ref(table, flags, *args),
                 "tile": (c["th"], c["tw"])}
        tallied = ss.stream_fwd_ref(table, flags, bg, *args, stats=stats)
        dbg = torch.einsum("rhw,rchw->c", torch.exp(logt), g_out)
        dbg_r = torch.einsum("rhw,rchw->c", torch.exp(logt_r), g_out)
        err_out = float((out - out_r).abs().max())
        err_t = float((torch.exp(logt) - torch.exp(logt_r)).abs().max())
        t_mismatch = int((logt != logt_r).sum())
        img_mismatch = int((out != out_r).sum())
        row_err = [float((dgrad[:, k] - dgrad_r[:, k]).abs().max()
                         / (dgrad_r[:, k].abs().max() + 1e-12))
                   for k in range(9)]
        err_bg = float((dbg - dbg_r).abs().max() / (dbg_r.abs().max()
                                                     + 1e-12))
        abs_bwd = max(float((dgrad - dgrad_r).abs().max()),
                      float((dbg - dbg_r).abs().max()))
        work = stream_work(c, stats)
        log(f"[kernels] stream {label}: R={R} N_pad={n_pad} {c['H']}x"
            f"{c['W']} tiles {c['th']}x{c['tw']}: {work['pairs']} "
            f"contributing pairs of {work['evaluated']} evaluated (flagged "
            f"chunks up to each pixel's stop), {work['rearm']} re-armed pixel "
            f"contributions, {work['outside']} (tile, gaussian) "
            f"contributions from outside the gaussian's bbox, "
            f"{work['gap_tiles']} tiles with an unflagged chunk between "
            f"flagged ones, {int(flags.sum())} of {flags.numel()} (tile, "
            f"chunk) flags set; fwd max|err| out {err_out:.3e} T "
            f"{err_t:.3e} (bit-mismatches T {t_mismatch}, images "
            f"{img_mismatch}; must be 0) tol {TOL_IMAGE:g}; bwd max rel err "
            f"per row {max(row_err):.3e} "
            f"({', '.join(f'{e:.1e}' for e in row_err)}) dbg {err_bg:.3e} "
            f"tol {TOL_GRAD:g}; bwd max|err| {abs_bwd:.3e}")
        log(f"[kernels] stream {label}: {work['live']} pairs not skipped by "
            f"the plain walk, dropped by the twin of the per-warp cull "
            f"{work['missed']} (must be 0); warp-column iterations "
            f"{work['iters_rows']} in 1x32 rows unculled (the first port), "
            f"{work['iters_patches']} in 8x8 patches culled "
            f"({work['iters_rows'] / max(work['iters_patches'], 1):.2f}x "
            f"fewer), in {work['groups']} culled 32-column groups")
        if not (err_out <= TOL_IMAGE and err_t <= TOL_IMAGE
                and t_mismatch == 0 and img_mismatch == 0
                and max(row_err) <= TOL_GRAD and err_bg <= TOL_GRAD
                and all(torch.equal(a, b) for a, b in zip(tallied,
                                                          (out_r, logt_r)))):
            raise AssertionError(f"stream kernel disagrees with its plain "
                                 f"version ({label})")
        if work["missed"]:
            raise AssertionError(f"stream {label}: the per-warp cull drops "
                                 f"live pairs")
        if label == "purpose" and not (work["rearm"] > 0
                                       and work["gap_tiles"] > 0
                                       and work["outside"] > 0):
            raise AssertionError(f"stream purpose case misses its purpose: "
                                 f"{work}")
        results["fwd_err"] = max(results["fwd_err"], err_out, err_t)
        results["bwd_err"] = max(results["bwd_err"], abs_bwd)
        if label in ("scene", "orbit"):
            it_k = 20
            ms_f = cuda_ms(lambda: ss.stream_fwd(table, flags, bg, *args),
                           it_k)
            ms_b = cuda_ms(lambda: ss.stream_bwd(table, flags, bg, logt, tot,
                                                 g_out, *args), it_k)
            # bytes: rows 0-8 of the table columns of the chunks some tile
            # of their render flags, read once, and the bitmap; bg; the
            # forward writes out (3 planes) and log T, the backward reads
            # log T, tot and g_out (5 planes) and adds rows 0-8 of dgrad
            # for the same columns
            # ops: the contributing pairs at the per-pair count
            tab = 9 * work["cols"] * 4
            fixed = flags.numel() * 4 + 12
            img = R * c["H"] * c["W"] * 4
            bf, byf = bound(tab + fixed + 4 * img, work["pairs"],
                            STREAM_FWD_OPS_PER_PAIR)
            bb, byb = bound(2 * tab + fixed + 5 * img, work["pairs"],
                            STREAM_BWD_OPS_PER_PAIR)
            log(f"[kernels] stream {label} shape: table columns read "
                f"{work['cols']} of {R * n_pad}; fwd {ms_f:.4f} ms (plain "
                f"{pms_f:.3f}, bound {bf:.5f} by {byf}, {ms_f / bf:.1f}x); "
                f"bwd {ms_b:.4f} ms (plain {pms_b:.3f}, bound {bb:.5f} by "
                f"{byb}, {ms_b / bb:.1f}x)")
            results[label] = {
                "fwd": dict(ms=ms_f, plain_ms=pms_f, bound_ms=bf,
                            bound_by=byf),
                "bwd": dict(ms=ms_b, plain_ms=pms_b, bound_ms=bb,
                            bound_by=byb)}
        del c, out, logt, dgrad, out_r, logt_r, dgrad_r, tot, stats, tallied
        torch.cuda.empty_cache()
    results.update(results["scene"])
    return results


SCENE_ARGV = ["--config-name", "sparseunet_pretraining",
              "data.pts_dataset_root=synthetic", "opt.batch_size=1"]
# the small scene of the parity phase (binned route, no tile is cut)
SMALL_SCENE_OVERRIDES = SCENE_ARGV[2:] + [
    "tpu.raster_impl_train=pallas_binned",
    "data.training_width=32", "data.training_height=32",
    "data.input_images=2", "data.max_points=1024",
    "tpu.raster_tile_capacity=1024",
    "model.vae_overrides={block_out_channels: [32, 32, 32, 32], "
    "layers_per_block: 1}",
    "model.backbone_overrides={channels: [16, 16, 24, 24, 24, 16, 16, 16], "
    "layers: [1, 1, 1, 1, 1, 1, 1, 1], pixel_capacity: 512}"]


OBJECT_ARGV = ["--config-name", "transformer_pretraining",
               "data.dataset_root=synthetic"]


def run_train(argv, counters, device_line, label, steps=3):
    """``train_network.main(argv)`` with the launch counts of ``counters``
    ({name: CudaKernel}) set to 0 just before and read just after; every
    one must have launched, every loss must be finite, and no step may
    have a non-finite gradient norm or be skipped by the NaN skip."""
    import torch
    from unipre3d_tpu_torch import train_network
    for k in counters.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    result = train_network.main(argv)
    launches = {n: k.launches for n, k in counters.items()}
    torch.cuda.synchronize()
    losses = result["losses"]
    log(f"[train] {label}: losses {losses} psnr {result['psnrs']} "
        f"grad_norm {result['grad_norms']}")
    log(f"[train] {label}: step ms {[round(t, 3) for t in result['step_ms']]}"
        f" (setup {result['setup_s']:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB) on "
        f"{device_line}")
    log(f"[train] {label}: val {result['val']}; launches {launches}")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label} train losses not finite: {losses}")
    if not all(math.isfinite(x) for x in result["grad_norms"]) or \
            any(result["nan_skipped"]):
        raise AssertionError(f"{label} step with a non-finite gradient: "
                             f"grad_norm {result['grad_norms']}, NaN skip "
                             f"{result['nan_skipped']}")
    if not result["val"] or not all(math.isfinite(v["psnr_novel"])
                                    for v in result["val"]):
        raise AssertionError(f"{label}: no finite validation {result['val']}")
    if counters and min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the {label} path never launched: "
                             f"{launches}")
    return result, launches


def phase_train(device_line, tmp):
    """Three full-width object steps (dense splat) with their val loop,
    checkpoints and test videos through the streaming splat, then
    ``eval.main`` over the run; three full-width scene steps on each of the
    binned and auto (tiled renderer) routes. Returns the launch counts of
    each kernel's path (the dense and binned splats, the streaming
    forward)."""
    import torch
    from unipre3d_tpu_torch import eval as eval_cli
    from unipre3d_tpu_torch.ops.rasterizer import splat_binned as sb
    from unipre3d_tpu_torch.ops.rasterizer import splat_dense as sd
    from unipre3d_tpu_torch.ops.rasterizer import splat_stream as ss
    obj_dir = os.path.join(tmp, "object")
    result, launches = run_train(
        OBJECT_ARGV + ["--output-dir", obj_dir, "opt.iterations=3",
                       "logging.loss_log=1", "logging.val_log=3",
                       "logging.loop_log=3", "tpu.raster_impl=pallas"],
        {"dense_fwd": sd.DENSE_FWD, "dense_bwd": sd.DENSE_BWD,
         "stream_fwd": ss.STREAM_FWD}, device_line, "object")
    for name in ("model_latest.ckpt", "model_best.ckpt"):
        if not os.path.exists(os.path.join(obj_dir, name)):
            raise AssertionError(f"object run wrote no {name}")
    log(f"[train] object: val ms {[round(v['ms'], 1) for v in result['val']]}"
        f"; test videos written {result['videos']}")
    sd.DENSE_FWD.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    scores = eval_cli.main([obj_dir])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t
    n_lines = len(open(os.path.join(obj_dir, "scores.txt")).readlines())
    log(f"[eval] object test split: {n_lines} examples in {eval_s:.2f} s "
        f"({n_lines / eval_s:.2f} examples/s, checkpoint load and test-set "
        f"GT renders included; dense launches {sd.DENSE_FWD.launches}) on "
        f"{device_line}: {scores}")
    if not os.path.exists(os.path.join(obj_dir, "test_scores.json")) or \
            not all(math.isfinite(scores[k]) for k in (
                "PSNR_cond", "PSNR_novel", "SSIM_cond", "SSIM_novel")):
        raise AssertionError(f"object eval: {scores}")
    scene = {}
    for route, counters in (
            ("pallas_binned", {"binned_fwd": sb.BINNED_FWD,
                               "binned_bwd": sb.BINNED_BWD}),
            ("auto", {})):
        res, counts = run_train(
            SCENE_ARGV + ["--output-dir", os.path.join(tmp, f"scene_{route}"),
                          f"tpu.raster_impl_train={route}",
                          "opt.iterations=3", "logging.loss_log=1"],
            counters, device_line, f"scene {route}")
        scene[route] = counts
        log(f"[train] scene {route}: valid rows {res['valid_rows']}, "
            f"geometry ms {[round(t, 3) for t in res['geometry_ms']]}"
            + (f"; each step's render: duplicates {res['dups']}, dropped by "
               f"the budget {res['budget_dropped']}, past the per-tile cap "
               f"{res['cap_dropped']}" if "dups" in res else ""))
    launches.update(scene["pallas_binned"])
    return launches


def phase_test_renders(device_line, tmp):
    """The test renders through the streaming splat: the object orbit (80
    frames) and the test views of the first test example, from the object
    run's checkpoint; the 16 test views of one full-width synthetic scene
    (84,096 slots, random weights from seed 0), then the same through the
    tiled renderer. Launch counts set to 0 before each path and read
    after."""
    import torch
    import yaml
    from unipre3d_tpu_torch.data import Loader, SyntheticSceneDataset, collate
    from unipre3d_tpu_torch import eval as eval_cli
    from unipre3d_tpu_torch.data import get_dataset
    from unipre3d_tpu_torch.ops.rasterizer import splat_stream as ss
    from unipre3d_tpu_torch.training import checkpoint as ckpt_lib
    from unipre3d_tpu_torch.training import trainer, video
    from unipre3d_tpu_torch.training.config import ConfigNode, load_config

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    obj_dir = os.path.join(tmp, "object")
    with open(os.path.join(obj_dir, ".hydra", "config.yaml")) as f:
        cfg = ConfigNode.from_obj(yaml.safe_load(f))
    model, state = trainer.create_train_state(cfg, seed=0)
    ckpt_lib.load_checkpoint(os.path.join(obj_dir, "model_latest.ckpt"),
                             model, state)
    batch = next(Loader(get_dataset(cfg, "test"), 1, shuffle=False).epoch(0))
    one, mask = video.predict_example(model, state, cfg, batch)
    ss.STREAM_FWD.launches = 0
    (views, seen_views), ms_views = timed(lambda: kept_launches(
        lambda: video.test_view_frames(one, mask, cfg, batch)))
    n_views = ss.STREAM_FWD.launches
    ss.STREAM_FWD.launches = 0
    (orbit, seen_orbit), ms_orbit = timed(lambda: kept_launches(
        lambda: video.render_orbit(one, cfg, 80, mask)))
    n_orbit = ss.STREAM_FWD.launches
    held = hold_launches({"test views": seen_views, "orbit": seen_orbit})
    per_view = one_launch_equals_per_view(
        one, mask, cfg, {"test views": {k: batch[k][0]
                                        for k in video.CAMERA_KEYS},
                         "orbit": video.orbit_camera_tensors(cfg, 80)})
    log(f"[render] object ({cfg.tpu.raster_impl}): test views "
        f"{views.shape} in {ms_views:.1f} ms (stream_fwd launches "
        f"{n_views}), orbit {orbit.shape} in {ms_orbit:.1f} ms "
        f"({80e3 / ms_orbit:.1f} frames/s; launches {n_orbit}); one "
        f"launch a view instead: {per_view}; on {device_line}")
    log(f"[render] object launches against the plain version: {held}")
    res = int(cfg.data.training_resolution)
    if n_views != 1 or n_orbit != 1 or orbit.shape != (80, res, res, 3) \
            or not orbit.any():
        raise AssertionError("object test renders did not go through one "
                             "streaming launch each")
    loader = Loader(get_dataset(cfg, "test"), 1, shuffle=False,
                    drop_last=False)
    eval_step = trainer.make_eval_step(cfg, model)
    for _ in range(2):      # a warm-up pass, then the timed one
        scores, ms_eval = timed(lambda: eval_cli.evaluate_dataset(
            model, eval_step, state, loader, cfg, tmp))
    n_ex = len(loader.dataset)
    log(f"[render] object eval (evaluate_dataset, checkpoint loaded): "
        f"{n_ex} test examples of {cfg.data.input_images} + "
        f"{batch['gt_images'].shape[1] - int(cfg.data.input_images)} views "
        f"in {ms_eval:.1f} ms after a warm-up pass: "
        f"{n_ex * 1e3 / ms_eval:.1f} examples/s on {device_line}")
    del model, state
    cfg = load_config("sparseunet_pretraining", overrides=SCENE_ARGV[2:] + [
        "tpu.raster_impl=pallas"])
    model, state = trainer.create_train_state(cfg, seed=0)
    batch = collate([SyntheticSceneDataset(cfg, "test", num_scenes=1,
                                           seed=42)[0]])
    one, mask = video.predict_example(model, state, cfg, batch)
    ss.STREAM_FWD.launches = 0
    (stream, seen_scene), ms_stream = timed(lambda: kept_launches(
        lambda: video.test_view_frames(one, mask, cfg, batch)))
    n_scene = ss.STREAM_FWD.launches
    held = hold_launches({"scene test views": seen_scene})
    stream, ms_stream2 = timed(lambda: video.test_view_frames(one, mask, cfg,
                                                              batch))
    per_view = one_launch_equals_per_view(
        one, mask, cfg, {"test views": {k: batch[k][0]
                                        for k in video.CAMERA_KEYS}})
    cfg.tpu.raster_impl = "xla"
    tiled, ms_tiled = timed(lambda: video.test_view_frames(one, mask, cfg,
                                                           batch))
    tiled, ms_tiled2 = timed(lambda: video.test_view_frames(one, mask, cfg,
                                                            batch))
    diff = int(abs(stream.astype(int) - tiled.astype(int)).max())
    log(f"[render] scene test views, {stream.shape[0]} views of "
        f"{one['xyz'].shape[0]} slots ({int(mask.sum())} valid): streaming "
        f"splat {ms_stream:.1f} / {ms_stream2:.1f} ms (stream_fwd launches "
        f"{n_scene}; one launch a view instead: {per_view}), tiled "
        f"renderer (capacity {cfg.tpu.raster_tile_capacity}) "
        f"{ms_tiled:.1f} / {ms_tiled2:.1f} ms; frames differ by at most "
        f"{diff} levels; on {device_line}")
    log(f"[render] scene launch against the plain version: {held}")
    if n_scene != 1:
        raise AssertionError("scene test views did not go through one "
                             "streaming launch")
    return {"object_stream_fwd": n_views + n_orbit,
            "scene_stream_fwd": n_scene}


def kept_launches(fn):
    """``fn()`` with ``splat_stream.stream_fwd`` wrapped to keep each
    launch's inputs and results -> (fn's result, [(args, (out, log T))]).
    The wrapped call launches and counts as before."""
    from unipre3d_tpu_torch.ops.rasterizer import splat_stream as ss
    kernel, seen = ss.stream_fwd, []

    def keep(*args):
        res = kernel(*args)
        seen.append((args, res))
        return res
    ss.stream_fwd = keep
    try:
        return fn(), seen
    finally:
        ss.stream_fwd = kernel


def hold_launches(seen_by_name):
    """Each kept streaming launch (``kept_launches``) against the plain
    version on the launch's own inputs: images and T bit for bit. Returns
    a summary string."""
    from unipre3d_tpu_torch.ops.rasterizer import splat_stream as ss
    out = []
    for name, seen in seen_by_name.items():
        if not seen:
            raise AssertionError(f"{name}: no streaming launch kept")
        for args, (img, logt) in seen:
            (img_r, logt_r), ms = cuda_timed(lambda: ss.stream_fwd_ref(*args))
            bad = int((img != img_r).sum()) + int((logt != logt_r).sum())
            table, flags = args[0], args[1]
            out.append(f"{name}: R={table.shape[0]} N_pad={table.shape[2]} "
                       f"{args[3]}x{args[4]} tiles {args[5]}x{args[6]}, "
                       f"{int(flags.sum())} of {flags.numel()} (tile, chunk) "
                       f"flags, bit-mismatches {bad} (must be 0), plain "
                       f"{ms:.1f} ms")
            if bad:
                raise AssertionError(f"{name}: the streaming launch disagrees "
                                     f"with its plain version")
    return "; ".join(out)


def per_view_frames(gaussians, cams, cfg, mask):
    """The views of ``cams`` (numpy stacks [V, ...]) one ``render_predicted``
    call each -> [V, 3, H, W] on the CPU."""
    import torch
    from unipre3d_tpu_torch.ops.rasterizer.render import render_predicted
    from unipre3d_tpu_torch.training import video
    from unipre3d_tpu_torch.training.trainer import bg_color_of
    dev = gaussians["xyz"].device
    with torch.no_grad():
        return torch.stack([render_predicted(
            gaussians, *(torch.as_tensor(cams[k][i], device=dev)
                         for k in video.CAMERA_KEYS), bg_color_of(cfg), cfg,
            gaussian_mask=mask)["render"]
            for i in range(len(cams["camera_centers"]))]).cpu().numpy()


def one_launch_equals_per_view(gaussians, mask, cfg, cams_by_name):
    """Each camera set's views rendered in one streaming launch
    (``video.render_views``) and one launch a view (``per_view_frames``):
    the frames must be equal bit for bit.
    Returns, per set, the per-view time (ms, host clock around
    synchronized calls) and its launches, as a string."""
    import numpy as np
    import torch
    from unipre3d_tpu_torch.ops.rasterizer import splat_stream as ss
    from unipre3d_tpu_torch.training import video
    out = []
    for name, cams in cams_by_name.items():
        one = video.render_views(gaussians, cams, cfg, mask)
        n0 = ss.STREAM_FWD.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        each = per_view_frames(gaussians, cams, cfg, mask)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        if not np.array_equal(one, each):
            raise AssertionError(f"{name}: the one-launch frames differ from "
                                 f"the per-view renders")
        out.append(f"{name} {ms:.1f} ms in {ss.STREAM_FWD.launches - n0} "
                   f"launches, frames equal bit for bit")
    return "; ".join(out)


def step_snapshot(cfg, batch, dev):
    """One train step of ``cfg`` on ``dev`` from seed-0 weights: (metrics,
    Adam's first moment per trainable tensor, on the CPU)."""
    from unipre3d_tpu_torch.data import batch_to
    from unipre3d_tpu_torch.training import trainer
    model, state = trainer.create_train_state(cfg, device=dev, seed=0)
    metrics = trainer.make_train_step(cfg, model)(state, batch_to(batch, dev))
    names = [n for n, _ in trainer.split_frozen(model)[0]]
    return metrics, {n: m.cpu() for n, m in zip(names, state.optimizer.mu)}


GAUSSIAN_KEYS = ("xyz", "opacity", "scaling", "rotation", "features_dc",
                 "features_rest")


def sparse_ops_snapshot(geo, n_views, img_h, img_w, dev):
    """Each op of the SparseUNet and PointFusion on ``dev`` over the
    geometry ``geo`` (the stem table, the PointFusion-merged set with its
    duplicate codes, stage 0's stride-2 structure): outputs and the
    gradients of a seeded random cotangent w.r.t. every input, on the CPU.
    The ops are linear in their inputs (BatchNorm in theirs and its affine
    parameters) and take no ReLU decision, so card and CPU agree entry by
    entry."""
    import torch
    from unipre3d_tpu_torch.models.sparseunet import (MaskedBatchNorm,
                                                      point_fusion_merge)
    from unipre3d_tpu_torch.ops import sparse as sp
    gen = torch.Generator().manual_seed(7)
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)  # noqa: E731
    B, M = geo.mask0.shape
    Mf, Mc, C = geo.fine_mask.shape[1], geo.downs[0].mask.shape[1], 8
    d0 = geo.downs[0]
    bn = MaskedBatchNorm(C).to(dev)
    cases = {
        "subm k5": (lambda f, w: sp.subm_gather_matmul(f, geo.nbr5, w),
                    [rnd(B, M, 6), rnd(125, 6, C)]),
        "subm k3 merged": (lambda f, w: sp.subm_gather_matmul(
            f, geo.nbr3_fine, w), [rnd(B, Mf, C), rnd(27, C, C)]),
        "down": (lambda f, w: sp.downsample_apply(d0, f, w),
                 [rnd(B, Mf, C), rnd(8, C, C)]),
        "inverse": (lambda f, w: sp.inverse_conv(
            d0.parent_idx, d0.child_offset, f, geo.fine_mask, w),
                    [rnd(B, Mc, C), rnd(8, C, C)]),
        "batchnorm": (lambda f, w, b: torch.func.functional_call(
            bn, {"weight": w, "bias": b}, (f, geo.fine_mask)),
                      [rnd(B, Mf, C), rnd(C), rnd(C)]),
        "fusion merge": (lambda f, img: point_fusion_merge(f, img, geo),
                         [rnd(B, M, C), rnd(B * n_views, C, img_h, img_w)]),
    }
    out = {}
    for name, (fn, ins) in cases.items():
        ins = [t.detach().requires_grad_(True) for t in ins]
        y = fn(*ins)
        grads = torch.autograd.grad(y, ins, rnd(*y.shape))
        out[f"{name} out"] = y.detach().cpu()
        out.update({f"{name} d{k}": g.cpu() for k, g in enumerate(grads)})
    return out


def scene_snapshot(cfg, batch, dev):
    """The scene step's forward and backward on ``dev`` from seed-0
    weights, on the CPU: (loss, the geometry's index tensors, the predicted
    gaussian fields, the loss gradient w.r.t. each of them, the parameter
    gradients, :func:`sparse_ops_snapshot` over the step's geometry)."""
    import torch
    from unipre3d_tpu_torch.data import batch_to
    from unipre3d_tpu_torch.training import trainer
    model, _ = trainer.create_train_state(cfg, device=dev, seed=0)
    b = batch_to(batch, dev)
    b["geometry"] = trainer.make_geometry_fn(cfg, model)(b)
    model.train()
    g = model(b["point_cloud"], b["gt_images"][:, :2],
              unprojected_coords=b["unprojected_coords"],
              geometry=b["geometry"])
    for k in GAUSSIAN_KEYS:
        g[k].retain_grad()
    bg = trainer.bg_color_of(cfg)
    loss, _ = trainer.compute_loss(
        trainer.render_supervision_views(g, b, cfg, bg),
        b["gt_images"][:, 2:], cfg, bg)
    loss.backward()
    geometry = [t.cpu() for t in torch.utils._pytree.tree_leaves(
        b["geometry"]) if t is not None]
    _, V, H, W, _ = b["unprojected_coords"].shape
    return (float(loss.detach()), geometry,
            {k: g[k].detach().cpu() for k in GAUSSIAN_KEYS},
            {k: g[k].grad.cpu() for k in GAUSSIAN_KEYS},
            {n: p.grad.cpu() for n, p in model.named_parameters()
             if p.grad is not None},
            sparse_ops_snapshot(b["geometry"], V, H, W, dev))


def rel_err(a, b):
    """max |b - a| over max |a| (0 where both are 0)."""
    return float((b - a).abs().max() / (a.abs().max() + 1e-30))


def compare_steps(label, a, b):
    """Loss to 1e-5 relative; gradients (Adam's first moment, 0.1 x the
    clipped gradient) per tensor relative to its largest entry; biases
    ahead of a BatchNorm have an analytically zero gradient and must be
    noise on both sides."""
    (m_a, g_a), (m_b, g_b) = a, b
    gmax = max(float(g.abs().max()) for g in g_a.values())
    worst, worst_name = 0.0, None
    for n, x in g_a.items():
        amax = float(x.abs().max())
        if amax < 1e-3 * gmax:
            if float(g_b[n].abs().max()) >= 1e-3 * gmax:
                raise AssertionError(f"{label}: {n} should be noise")
            continue
        err = float((g_b[n] - x).abs().max()) / amax
        if err > worst:
            worst, worst_name = err, n
    loss_err = abs(m_a["loss"] - m_b["loss"]) / abs(m_a["loss"])
    log(f"[parity] {label}: loss cpu {m_a['loss']:.7f} cuda "
        f"{m_b['loss']:.7f} (rel {loss_err:.2e}, tol 1e-5); max gradient "
        f"rel err {worst:.2e} at {worst_name} (tol {TOL_STEP_GRAD:g})")
    if loss_err > 1e-5 or worst > TOL_STEP_GRAD:
        raise AssertionError(f"{label}: card step disagrees with the CPU "
                             f"step")


def phase_parity():
    """One small object step and one small scene step (binned route) on the
    card (kernels) and on the CPU (plain versions), same weights and
    batch: the object step's loss and gradients; the scene step's geometry,
    loss, gradient w.r.t. the predicted gaussians (the render path with
    both binned kernels), each SparseUNet/PointFusion op over the step's
    geometry entry by entry, and the parameter gradients in relative L2."""
    import torch
    from unipre3d_tpu_torch.data import (SyntheticSceneDataset, collate,
                                         random_batch)
    from unipre3d_tpu_torch.training.config import load_config
    cfg = load_config("transformer_pretraining", overrides=[
        "data.training_resolution=32", "opt.batch_size=2",
        "model.vae_overrides={block_out_channels: [32, 32, 32, 32], "
        "layers_per_block: 1}",
        "model.backbone_overrides={depth: 2, drop_path_rate: 0.0}"])
    batch = random_batch(cfg, batch=2, n_points=256, n_views=3, seed=0)
    compare_steps("object", *(step_snapshot(cfg, batch, d)
                              for d in ("cpu", "cuda")))
    cfg = load_config("sparseunet_pretraining",
                      overrides=SMALL_SCENE_OVERRIDES)
    ds = SyntheticSceneDataset(cfg, num_scenes=1, seed=0, device="cpu")
    batch = collate([ds[0]])
    (l_a, geo_a, out_a, gg_a, pg_a, ops_a), (l_b, geo_b, out_b, gg_b, pg_b,
                                             ops_b) = (
        scene_snapshot(cfg, batch, d) for d in ("cpu", "cuda"))
    # the index structures are integer: the card's equal the CPU's exactly
    same = len(geo_a) == len(geo_b) and all(
        torch.equal(a, b) for a, b in zip(geo_a, geo_b))
    loss_err = abs(l_a - l_b) / abs(l_a)
    out_err = max(rel_err(out_a[k], out_b[k]) for k in out_a)
    gauss_err = max(rel_err(gg_a[k], gg_b[k]) for k in gg_a)
    ops_err = {k: rel_err(ops_a[k], ops_b[k]) for k in ops_a}
    worst_op = max(ops_err, key=ops_err.get)
    param_l2 = math.sqrt(sum(float(((pg_b[n] - pg_a[n]) ** 2).sum())
                             for n in pg_a)
                         / sum(float((pg_a[n] ** 2).sum()) for n in pg_a))
    log(f"[parity] scene: geometry ({len(geo_a)} index tensors) card == CPU: "
        f"{same}; loss cpu {l_a:.7f} cuda {l_b:.7f} (rel {loss_err:.2e}, tol "
        f"1e-5); predicted gaussians, max rel err per field {out_err:.2e}; "
        f"gradient w.r.t. the gaussians {gauss_err:.2e} (tol {TOL_GRAD:g}); "
        f"SparseUNet/PointFusion ops ({len(ops_err)} outputs and gradients) "
        f"{ops_err[worst_op]:.2e} at {worst_op} (tol {TOL_GRAD:g}); "
        f"parameter gradients, relative L2 {param_l2:.2e} (tol "
        f"{TOL_SCENE_PARAM_L2:g})")
    if not same or loss_err > 1e-5 or gauss_err > TOL_GRAD or \
            ops_err[worst_op] > TOL_GRAD or param_l2 > TOL_SCENE_PARAM_L2:
        raise AssertionError("scene: card step disagrees with the CPU step")


def phase_eval_parity():
    """Card against CPU: the streaming splat (R = 2, 1,300 gaussians at
    64x64, 32x32 tiles) forward and its gradients w.r.t. mean2d, conic,
    color, opacity and bg; ``render_predicted`` on the ``xla`` and
    ``pallas`` routes (3,000 gaussians, one 128x128 view); one small object
    eval step (PSNR, SSIM and the renders). Returns the streaming
    backward's launches in the card-side call (no training route runs it:
    the JAX package runs its ``_bwd_kernel`` only under a gradient of
    ``rasterize(impl="pallas")``)."""
    import numpy as np
    import torch
    from unipre3d_tpu_torch.data import batch_to, random_batch
    from unipre3d_tpu_torch.ops.rasterizer import splat_stream as ss
    from unipre3d_tpu_torch.ops.rasterizer.preprocess import \
        ProjectedGaussians
    from unipre3d_tpu_torch.ops.rasterizer.render import render_predicted
    from unipre3d_tpu_torch.training import trainer
    from unipre3d_tpu_torch.training.config import load_config
    from unipre3d_tpu_torch.utils import camera as cam_util

    g = torch.Generator().manual_seed(21)
    base = random_gaussians(2, 1300, 64, 64, g)
    cot = torch.randn(2, 3, 64, 64, generator=g)
    outs = []
    for dev in ("cpu", "cuda"):
        ins = [t.detach().to(dev).requires_grad_(k < 4)
               for k, t in enumerate(base)]
        bg = torch.tensor([0.1, 0.2, 0.3], device=dev, requires_grad=True)
        ss.STREAM_FWD.launches = ss.STREAM_BWD.launches = 0
        img = ss.rasterize_projected_stream(ProjectedGaussians(*ins), bg, 64,
                                            64, 32, 32)
        (img * cot.to(dev)).sum().backward()
        launches = {"stream_fwd": ss.STREAM_FWD.launches,
                    "stream_bwd": ss.STREAM_BWD.launches}
        outs.append([img.detach().cpu()] + [t.grad.cpu() for t in ins[:4]]
                    + [bg.grad.cpu()])
    # the card-side call with its gradients: the streaming backward's path
    if min(launches.values()) <= 0:
        raise AssertionError(f"the streaming splat's backward path did not "
                             f"launch its kernels: {launches}")
    err_img = float((outs[0][0] - outs[1][0]).abs().max())
    err_grad = max(rel_err(a, b) for a, b in zip(outs[0][1:], outs[1][1:]))

    # faint gaussians: the tiled renderer's stop test runs on a cumsum that
    # the card and the CPU sum in other orders, so a pixel at T ~ 1e-4 may
    # decide otherwise (by up to ~alpha x 1e-4); at these opacities few
    # pixels get there, and at most 0.1% of them may differ past TOL_IMAGE
    rng = np.random.default_rng(22)
    n = 3000
    q = rng.normal(size=(n, 4))
    gauss = {"xyz": rng.uniform(-0.35, 0.35, (n, 3)),
             "opacity": rng.uniform(0.05, 0.3, (n, 1)),
             "scaling": rng.uniform(0.005, 0.03, (n, 3)),
             "rotation": q / np.linalg.norm(q, axis=1, keepdims=True),
             "features_dc": rng.uniform(-1, 1, (n, 1, 3)),
             "features_rest": rng.normal(scale=0.2, size=(n, 3, 3))}
    cam = cam_util.build_camera_tensors(
        np.eye(3), np.array([0.0, 0.0, 1.5]), math.radians(49.13),
        math.radians(49.13), 0.5, 2.0)
    render_err = {}
    for impl in ("xla", "pallas"):
        cfg = load_config("transformer_pretraining",
                          overrides=[f"tpu.raster_impl={impl}"])
        imgs = []
        for dev in ("cpu", "cuda"):
            d = {k: torch.tensor(v, dtype=torch.float32, device=dev)
                 for k, v in gauss.items()}
            wv, fp, cc = (torch.tensor(cam[k], device=dev) for k in (
                "world_view_transform", "full_proj_transform",
                "camera_center"))
            imgs.append(render_predicted(d, wv, fp, cc, [0.0, 0.0, 0.0],
                                         cfg)["render"].cpu())
        err = (imgs[0] - imgs[1]).abs().amax(0)
        render_err[impl] = (float(err.max()), int((err > TOL_IMAGE).sum()))

    cfg = load_config("transformer_pretraining", overrides=[
        "data.training_resolution=32",
        "model.vae_overrides={block_out_channels: [32, 32, 32, 32], "
        "layers_per_block: 1}",
        "model.backbone_overrides={depth: 2, drop_path_rate: 0.0}"])
    batch = random_batch(cfg, batch=2, n_points=256, n_views=3, seed=3)
    evals = []
    for dev in ("cpu", "cuda"):
        model, state = trainer.create_train_state(cfg, device=dev, seed=0)
        for v in state.ema.values():      # an EMA away from the parameters
            v.mul_(1.01)
        evals.append(trainer.make_eval_step(cfg, model)(
            state, batch_to(batch, dev)))
    # PSNR relative, SSIM (in [-1, 1], ~0.03 on these noise targets)
    # absolute
    eval_err = max(abs(float(evals[0][k]) - float(evals[1][k]))
                   / (abs(float(evals[0][k])) if "psnr" in k else 1.0)
                   for k in ("psnr_cond", "psnr_novel", "ssim_cond",
                             "ssim_novel"))
    eval_img = float((evals[0]["rendered"] - evals[1]["rendered"].cpu())
                     .abs().max())
    log(f"[parity] streaming splat: image max|err| {err_img:.3e} (tol "
        f"{TOL_IMAGE:g}), gradients max rel err {err_grad:.3e} (tol "
        f"{TOL_GRAD:g}); render_predicted max|err| (pixels past "
        f"{TOL_IMAGE:g}) xla {render_err['xla'][0]:.3e} "
        f"({render_err['xla'][1]}), pallas {render_err['pallas'][0]:.3e} "
        f"({render_err['pallas'][1]}), of 16384 (tol 16 pixels, at most "
        f"1e-3); object eval step PSNR rel / SSIM abs max err "
        f"{eval_err:.2e} (tol 1e-5), renders max|err| {eval_img:.3e} (tol "
        f"{TOL_IMAGE:g}); launches of the card-side streaming call with "
        f"its gradients {launches}")
    render_ok = all(m <= 1e-3 and k <= 16 for m, k in render_err.values()) \
        and render_err["pallas"][1] == 0
    if err_img > TOL_IMAGE or err_grad > TOL_GRAD or not render_ok or \
            eval_err > 1e-5 or eval_img > TOL_IMAGE:
        raise AssertionError("eval path: card disagrees with the CPU")
    return launches["stream_bwd"]


def build_kernels(names):
    """Build every kernel library at once (one nvcc each, in parallel) and
    print ptxas' report."""
    from unipre3d_tpu_torch import kernels
    t = time.time()
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(kernels.load, names))
    log(f"[build] {', '.join(names)}: {time.time() - t:.1f} s")
    for name in names:
        for line in kernels.build_log(name).splitlines():
            if any(k in line for k in ("registers", "spill", "smem",
                                       "Compiling entry")):
                log(f"[build]   {name}: {line.strip()}")


def kernel_rows(dense, binned, stream, launches):
    """The ``{"kernels": [...]}`` rows of the six ported kernels."""
    rows = []
    for timing, src, tpu_file, entries in (
            (dense, "splat_dense", "pallas_splat_dense.py",
             (("fwd", "dense_fwd", "_dense_fwd_kernel", 193),
              ("bwd", "dense_bwd", "_dense_bwd_kernel", 220))),
            (binned, "splat_binned", "pallas_splat_binned.py",
             (("fwd", "binned_fwd", "_fwd_kernel", 73),
              ("bwd", "binned_bwd", "_bwd_kernel", 116))),
            (stream, "splat_stream", "pallas_splat.py",
             (("fwd", "stream_fwd", "_fwd_kernel", 103),
              ("bwd", "stream_bwd", "_bwd_kernel", 137)))):
        for key, fn, kern, line in entries:
            t = timing[key]
            rows.append({
                "name": f"{src}.{fn}", "route": "cuda",
                "source": f"unipre3d_tpu_torch/csrc/{src}.cu",
                "replaces": f"unipre3d_tpu/ops/rasterizer/{tpu_file}:{line} "
                            f"({kern})",
                "launches": launches[fn],
                "max_abs_err": timing[f"{key}_err"],
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": None})
    return rows


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    t0 = time.time()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    log(f"[device] {name} count={count} nvidia-smi: {smi}")

    build_kernels(["splat_dense", "splat_binned", "splat_stream"])
    dense = phase_kernels(device)
    binned = phase_binned_kernels(device)
    stream = phase_stream_kernels(device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        launches = phase_train(smi, tmp)
        phase_test_renders(smi, tmp)
    phase_parity()
    launches["stream_bwd"] = phase_eval_parity()

    rows = kernel_rows(dense, binned, stream, launches)
    log(f"[done] {time.time() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
