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
   iterations of the first port's rows and of the culled patches); the
   dense splat also at PointMLP's and PCM's main-path shape (128 renders of
   1,024 gaussians, two 512-chunks), bit for bit and timed; the
   selective-scan pair (Mamba3D and PCM) at Mamba3D's shape, PCM's first
   and deepest stages, the first two also at the mixer's bf16 dtypes and
   strided views (read in place, each gradient in its input's dtype), and
   edge cases (L = 1, L = 37, L one step either side of a backward segment,
   a forward tile and two tiles, at a masked channel edge), the output and
   every input's gradient against the plain recurrence, two backward
   launches bit for bit, timed; and the kernel launches of one default-run
   SSMBranch forward + backward and of its scan call (which must be the
   pair's three: no copy or cast around them).
4. train: the default run (bfloat16 compute dtype, the VAE feature cache)
   on synthetic data through ``unipre3d_tpu_torch.train_network``, each
   under its own output directory: six full-width
   ``transformer_pretraining`` steps with their val loop, checkpoints and
   test videos (``tpu.raster_impl=pallas``), with each step's time (the
   cache's attach and the step), the cache's hit rate (which must be above
   0: the synthetic set's 64 conditioning views repeat) and buffer, and the
   peak device memory, then ``eval.main`` over that run; three full-width
   ``sparseunet_pretraining`` steps on each of the binned route and the
   ``auto`` route (the tiled renderer). Each path's kernel launch counts
   are set to 0 just before it and read just after, and every kernel of
   the path must have launched. No step may have a non-finite gradient
   norm or be skipped by the NaN skip. Then, on one full-width object
   batch from the same weights: the cached step's loss against the
   live-VAE step's (bfloat16; 1e-6 relative, bit for bit on the CPU,
   tests/test_torch_feature_cache.py), and the bfloat16 step's loss
   against the float32 step's (2e-2 relative, as
   tests/test_torch_compute_dtype.py, and at least 1e-4 apart). The
   modules must compute in the dtype asked for: the first transformer,
   SparseUNet and VAE blocks of each default run, and the first
   transformer block of each of those steps, return it. Then three
   full-width default-run steps of each of ``pointmlp_pretraining``,
   ``mamba3d_pretraining`` and ``pcm_pretraining`` with their val loop
   (the dense pair must launch on each path, the scan pair on Mamba3D's
   and PCM's, each backbone's first block must return bfloat16), with the
   time of one forward's FPS calls beside the step's. Then three
   full-width default-run ``ptv3_pretraining`` steps with their val loop
   on each of the binned and auto routes (the binned pair must launch on
   the first, the first PTv3Block must return bfloat16), with the geometry
   build's time, each stage's valid rows and the parents each pooling
   dropped past its capacity.
5. test renders: the object orbit (80 frames) and the test views of a
   test example from the trained run's checkpoint, and the 16 test views of
   a full-width scene at 84,096 slots, through the streaming splat, each
   set of views in one launch, that launch held bit for bit against the
   plain version on its own inputs, and its frames equal bit for bit to one
   launch a view (the scene's also through the tiled renderer), each timed.
6. export, warm start and LPIPS (``phase_warm_start_lpips_export``): the
   object run's export under the reference's names against the export of
   its checkpoint on the CPU, bit for bit; a new full-width default run
   warm-started from that ``.pth`` with random LPIPS weights, the term from
   step 1, three steps and val (the backbone equal to the export right
   after the warm start, ``lpips`` 0 at the first step and above 0 after,
   the dense pair launched, no NaN skip) and ``eval.main`` over it with
   both LPIPS columns; the LPIPS module card against CPU and its time.
7. parity: one train step of a small object and a small scene configuration
   on the card (kernels) against the same step on the CPU (plain versions),
   same weights and batch; for the scene also each SparseUNet/PointFusion
   op over the step's geometry; the streaming splat with its gradients,
   ``render_predicted`` on the ``xla`` and ``pallas`` routes and a small
   object eval step, card against CPU; one float32 step of each of the
   three backbones of slice 8 at full width, card against CPU (gradients
   against the CPU's own move under a 1e-6 perturbation where max-pool
   ties make that larger than TOL_STEP_GRAD); one float32 step of a small
   PTv3 (five narrow stages), card against CPU, held as the SparseUNet
   scene step, with its ops (xCPE, patch attention along each order,
   segment max, fusion merge) entry by entry. The streaming backward, which no
   training route runs, takes its launch count from the card-side call of
   the streaming splat with its gradients.

It prints a ``{"kernels": [...]}`` line, then the card's name and power
limit, then as its last line ``{"ok": true, "device": {...}}``. Without a
CUDA device, or without the repository beside it, it exits non-zero and
prints no result. TF32 is off for every phase (``allow_tf32 = False`` for
matmuls and cuDNN), so the float32 comparisons are float32; the parity
phases pin ``tpu.compute_dtype=float32`` and ``tpu.vae_cache_entries=0``.
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

    shapes = [  # (R, N, H, W): main path (transformer, Mamba3D), main path
        # of PointMLP and PCM (a gaussian a point: two 512-chunks),
        # multi-chunk, top of the route, cull edges (N = 0: cull_edge_case)
        (128, 128, 128, 128), (128, 1024, 128, 128), (8, 1000, 128, 128),
        (4, 4096, 128, 128), (8, 0, 128, 128)]
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
        if si in (0, 1):  # the main-path shapes: time and bound
            key = "" if si == 0 else f"_{N}"
            it_k, it_p = (50, 3) if si == 0 else (20, 1)
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
            log(f"[kernels] main shape N={N}: survivors of the per-tile "
                f"cull {float(surv.float().mean()):.2f} a tile (max "
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
            log(f"[kernels] main shape R={R} N={N}: {pairs} contributing "
                f"pairs; fwd {ms_f:.4f} ms (plain {pms_f:.3f}, bound "
                f"{bf:.4f} by {byf}); bwd {ms_b:.4f} ms (plain {pms_b:.3f}, "
                f"bound {bb:.4f} by {byb})")
            results["fwd" + key] = dict(ms=ms_f, plain_ms=pms_f, bound_ms=bf,
                                        bound_by=byf)
            results["bwd" + key] = dict(ms=ms_b, plain_ms=pms_b, bound_ms=bb,
                                        bound_by=byb)
        results.setdefault("fwd_err", 0.0)
        results["fwd_err"] = max(results["fwd_err"], err_out, err_t)
        results.setdefault("bwd_err", 0.0)
        results["bwd_err"] = max(results["bwd_err"], abs_bwd)
        del data, out, tfin, dgrad, out_r, tfin_r, dgrad_r
        torch.cuda.empty_cache()
    return results


# the selective scan's operations per (b, t, d, n) state lane, what the
# function needs (the first kernels' count, kept so that the bound stays
# the yardstick): (float32 ops, special-function ops). Forward: dt A,
# the decay-and-add (2 FMA), C h and its sum; exp. Backward: the state
# recomputed once (dt A, 2 FMA) and the gradient terms (dh, d exp, dA, ddt,
# du, dB, dC: ~16); exp.
SCAN_FWD_OPS = (6, 1)
SCAN_BWD_OPS = (22, 1)
TOL_SCAN_FWD = 1e-5   # max |err| over max |y|
TOL_SCAN_GRAD = 1e-4  # max |err| over max |reference|, per input's gradient


def scan_case(Bsz, L, D, seed, device):
    """The mixer's scan inputs at one shape, from a seeded generator: u,
    delta (before the softplus), A = -exp(A_log) (S4D-real, 1..16), B, C,
    D, z, delta_bias (log-uniform dt in [1e-3, 0.1] before its inverse
    softplus), float32 on ``device``."""
    import torch
    from unipre3d_tpu_torch.models.mamba_mixer import a_log_init, dt_bias_init
    from unipre3d_tpu_torch.ops.scan import SCAN_N
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    ins = [r(Bsz, L, D), 0.5 * r(Bsz, L, D), -torch.exp(a_log_init(D, SCAN_N)),
           r(Bsz, L, SCAN_N), r(Bsz, L, SCAN_N), torch.ones(D), r(Bsz, L, D),
           dt_bias_init(D)]
    return [t.to(device) for t in ins]


def mixer_layout(ins):
    """The scan inputs as the default run's mixer hands them over
    (models/mamba_mixer.py): u float32; delta bfloat16 (dt_proj's output);
    B and C bfloat16 views of one [Bsz, L, dt_rank + 32] tensor (x_proj's
    output, dt_rank = ceil(d_model / 16), d_model = D / 2); z a bfloat16
    view of one [Bsz, L, 2 D] tensor (in_proj's output, its second half)."""
    import torch
    u, delta, A, Bm, Cm, Dv, z, bias = ins
    Bsz, L, D = u.shape
    rank = -(-(D // 2) // 16)
    xp = torch.randn(Bsz, L, rank + 2 * Bm.shape[-1], device=u.device)
    xp[..., rank:rank + Bm.shape[-1]] = Bm
    xp[..., rank + Bm.shape[-1]:] = Cm
    xp = xp.to(torch.bfloat16)
    zx = torch.cat([u, z], -1).to(torch.bfloat16)
    n = Bm.shape[-1]
    return [u, delta.to(torch.bfloat16), A, xp[..., rank:rank + n],
            xp[..., rank + n:], Dv, zx[..., D:], bias]


def grad_err(k, r):
    """max |k - r| beyond half an ulp of k's own dtype (the rounding of a
    float32 gradient into a bfloat16 input's dtype, exact as
    .to(torch.bfloat16); 0 for float32), over max |r|."""
    import torch
    diff = (k.float() - r.float()).abs()
    if k.dtype == torch.bfloat16:
        _, ex = torch.frexp(k.float())
        half_ulp = torch.ldexp(torch.ones_like(diff), ex - 9)
        diff = (diff - torch.where(k == 0, 0.0, half_ulp)).clamp_min(0.0)
    return float(diff.max() / (r.float().abs().max() + 1e-30))


def scan_bound(Bsz, L, D, x_bytes=4):
    """(forward, backward) least times, (ms, what sets it), of the scan at
    one shape: forward u, delta, z in, y out, B, C in; backward u, delta,
    z, dy in, du, ddelta, dz out, B, C in, dB, dC out; u, y, dy, du
    float32, delta, z, B, C and their gradients of ``x_bytes``; and
    SCAN_FWD_OPS / SCAN_BWD_OPS a state lane."""
    from unipre3d_tpu_torch.ops.scan import SCAN_N
    bld, bln = Bsz * L * D, Bsz * L * SCAN_N
    lanes = Bsz * L * D * SCAN_N
    small = (D * SCAN_N + 3 * D) * 4
    fwd = bound(bld * (8 + 2 * x_bytes) + 2 * bln * x_bytes + small, lanes,
                SCAN_FWD_OPS)
    bwd = bound(bld * (12 + 4 * x_bytes) + 4 * bln * x_bytes + 2 * small,
                lanes, SCAN_BWD_OPS)
    return fwd, bwd


def scan_launches(device):
    """Kernel launches on the card (torch.profiler) of one default-run
    ``SSMBranch`` forward + backward at Mamba3D's shape (bfloat16, batch 32,
    129 tokens, d_inner 768), and of its ``selective_scan`` call alone
    (forward + gradients of its inputs as the branch hands them over) ->
    {"branch": n, "scan": n, "scan_kernels": names}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from unipre3d_tpu_torch.models.mamba_mixer import SSMBranch
    from unipre3d_tpu_torch.ops import scan as sc
    g = torch.Generator().manual_seed(7)
    branch = SSMBranch(768, dt_rank=24, dtype=torch.bfloat16)
    with torch.no_grad():
        for prm in branch.parameters():
            prm.copy_(0.1 * torch.randn(prm.shape, generator=g))
    branch = branch.to(device)
    xz = torch.randn(32, 129, 1536, generator=g).to(device, torch.bfloat16)
    xz.requires_grad_(True)
    dy = torch.randn(32, 129, 768, generator=g).to(device)
    seen = {}
    real = sc.selective_scan

    def hook(*a, **kw):  # the branch's own scan inputs, kept as leaves
        seen["args"] = [t.detach().requires_grad_(True) if torch.is_tensor(t)
                        and t.is_floating_point() else t for t in a]
        seen["kw"] = {k: t.detach().requires_grad_(True)
                      if torch.is_tensor(t) else t for k, t in kw.items()}
        return real(*a, **kw)

    def launches(fn):
        fn()  # warm-up (builds and loads the kernels)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        return len(kern), sorted({e.name for e in kern})

    def run_branch():
        y = branch(xz[..., :768], xz[..., 768:])
        torch.autograd.grad(y, [xz] + list(branch.parameters()), dy)

    from unipre3d_tpu_torch.models import mamba_mixer
    mamba_mixer.selective_scan = hook
    try:
        n_branch, _ = launches(run_branch)
    finally:
        mamba_mixer.selective_scan = real
    args, kw = seen["args"], seen["kw"]
    leaves = [t for t in list(args) + list(kw.values())
              if torch.is_tensor(t) and t.requires_grad]

    def run_scan():
        torch.autograd.grad(real(*args, **kw), leaves, dy)

    n_scan, names = launches(run_scan)
    return {"branch": n_branch, "scan": n_scan, "scan_kernels": names}


def phase_scan_kernels(device):
    """The selective-scan pair against its plain version on the card: at
    Mamba3D's shape, PCM's stage 0 and deepest stage, the first two also at
    the mixer's dtypes and strides (``mixer_layout``; the plain version on
    float32 copies of the same values), and edge cases: L = 1, L = 37
    (which no segment or tile divides), L one step either side of a
    backward segment (8 steps), a forward tile (16) and two tiles, at D =
    96 (a backward CTA and a half: its channel edge masked). The output
    to TOL_SCAN_FWD and every input's gradient to TOL_SCAN_GRAD
    (``grad_err``: beyond the rounding into a bfloat16 input's dtype), and
    two backward launches on the same inputs must give the same bits. Times
    both kernels and both plain versions at each main-path shape (CUDA
    events), and counts the launches of one default-run SSMBranch forward +
    backward and of its scan call (``scan_launches``)."""
    import torch
    from unipre3d_tpu_torch.ops import scan as sc
    shapes = [("Mamba3D", 32, 129, 768, False),
              ("PCM stage 0", 32, 524, 768, False),
              ("PCM stage 3", 32, 76, 1536, False),
              ("Mamba3D mixer dtypes", 32, 129, 768, True),
              ("PCM stage 0 mixer dtypes", 32, 524, 768, True),
              ("edge L=1", 4, 1, 768, False), ("edge L=37", 3, 37, 1536, False)]
    shapes += [(f"tile edge L={L}", 2, L, 96, mixer)
               for L in (7, 9, 15, 17, 31, 33) for mixer in (False, True)]
    results = {"fwd_err": 0.0, "bwd_err": 0.0}
    for si, (label, Bsz, L, D, mixer) in enumerate(shapes):
        ins = scan_case(Bsz, L, D, si, device)
        if mixer:
            ins = mixer_layout(ins)
        g = torch.randn(ins[0].shape, device=device,
                        generator=torch.Generator(device).manual_seed(si))
        y, chk = sc.scan_fwd(*ins, True, keep_states=True)
        grads = sc.scan_bwd(*ins, True, g, chk)
        again = sc.scan_bwd(*ins, True, g, chk)
        leaves = [t.float().clone().requires_grad_(True) for t in ins]
        y_r = sc.selective_scan_ref(*leaves, delta_softplus=True)
        grads_r = torch.autograd.grad(y_r, leaves, g)
        torch.cuda.synchronize()
        y_r = y_r.detach()
        same = all(torch.equal(a, b) for a, b in zip(grads, again))
        dtypes_ok = all(a.dtype == t.dtype for a, t in zip(grads, ins))
        err_y = float((y - y_r).abs().max() / y_r.abs().max())
        errs = [grad_err(a, b) for a, b in zip(grads, grads_r)]
        ok = bool(torch.isfinite(y_r).all()) and err_y <= TOL_SCAN_FWD and \
            max(errs) <= TOL_SCAN_GRAD and same and dtypes_ok
        log(f"[kernels] selective scan {label} B={Bsz} L={L} D={D}: fwd "
            f"max|err|/max|y| {err_y:.2e} (tol {TOL_SCAN_FWD:g}); bwd max "
            f"rel err {max(errs):.2e} (u, delta, A, B, C, D, z, bias: "
            f"{', '.join(f'{e:.1e}' for e in errs)}; tol "
            f"{TOL_SCAN_GRAD:g}); two backward launches bit-identical "
            f"{same}; gradient dtypes "
            f"{[str(a.dtype).split('.')[-1] for a in grads]}")
        if not ok:
            raise AssertionError(f"the selective-scan kernels disagree with "
                                 f"their plain version at {label}")
        results["fwd_err"] = max(results["fwd_err"],
                                 float((y - y_r).abs().max()))
        results["bwd_err"] = max(results["bwd_err"], max(
            float((a.float() - b).abs().max()) for a, b in zip(grads, grads_r)))
        if si < 5:
            ms_f = cuda_ms(lambda: sc.scan_fwd(*ins, True, keep_states=True),
                           20)
            ms_f0 = cuda_ms(lambda: sc.scan_fwd(*ins, True), 20)
            ms_b = cuda_ms(lambda: sc.scan_bwd(*ins, True, g, chk), 20)
            pms_f = cuda_ms(lambda: sc.selective_scan_ref(
                *leaves, delta_softplus=True), 2)
            y_r = sc.selective_scan_ref(*leaves, delta_softplus=True)
            pms_b = cuda_ms(lambda: torch.autograd.grad(
                y_r, leaves, g, retain_graph=True), 2)
            (bf, byf), (bb, byb) = scan_bound(
                Bsz, L, D, x_bytes=2 if mixer else 4)
            log(f"[kernels] selective scan {label}: fwd {ms_f:.4f} ms "
                f"keeping the states for the backward, {ms_f0:.4f} without "
                f"(plain {pms_f:.3f}, bound {bf:.4f} by {byf}); bwd "
                f"{ms_b:.4f} ms (plain {pms_b:.3f}, bound {bb:.4f} by {byb});"
                f" states kept {chk.numel() * 4 / 1e6:.1f} MB")
            if si == 0:   # Mamba3D's, float32: the kernels line
                results["fwd"] = dict(ms=ms_f, plain_ms=pms_f, bound_ms=bf,
                                      bound_by=byf)
                results["bwd"] = dict(ms=ms_b, plain_ms=pms_b, bound_ms=bb,
                                      bound_by=byb)
        del ins, g, y, chk, grads, again, leaves, y_r, grads_r
        torch.cuda.empty_cache()
    counts = scan_launches(device)
    log(f"[kernels] launches of one default-run SSMBranch forward + backward "
        f"at Mamba3D's shape: {counts['branch']}; of its selective_scan "
        f"call alone (forward + gradients): {counts['scan']} "
        f"({', '.join(counts['scan_kernels'])})")
    if counts["scan"] != 3:
        raise AssertionError(f"the mixer's scan call launched "
                             f"{counts['scan']} kernels, not its 3 (forward,"
                             f" backward walk, sums): a copy or cast crept "
                             f"in")
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
# the parity phases compare float32 computations, without the cache
FLOAT32_PINS = ["tpu.compute_dtype=float32", "tpu.vae_cache_entries=0"]
# the small scene of the parity phase (binned route, no tile is cut)
SMALL_SCENE_OVERRIDES = SCENE_ARGV[2:] + FLOAT32_PINS + [
    "tpu.raster_impl_train=pallas_binned",
    "data.training_width=32", "data.training_height=32",
    "data.input_images=2", "data.max_points=1024",
    "tpu.raster_tile_capacity=1024",
    "model.vae_overrides={block_out_channels: [32, 32, 32, 32], "
    "layers_per_block: 1}",
    "model.backbone_overrides={channels: [16, 16, 24, 24, 24, 16, 16, 16], "
    "layers: [1, 1, 1, 1, 1, 1, 1, 1], pixel_capacity: 512}"]


PTV3_ARGV = ["--config-name", "ptv3_pretraining",
             "data.pts_dataset_root=synthetic", "opt.batch_size=1"]
# the small PTv3 of the parity phase: the small scene above with a narrow
# five-stage PTv3 (head dim 16, as at full width), DropPath and the order
# shuffle off (their draws differ between the card and the CPU)
SMALL_PTV3_OVERRIDES = SMALL_SCENE_OVERRIDES[:-1] + [
    "model.backbone_overrides={enc_channels: [32, 16, 16, 32, 32], "
    "enc_num_head: [2, 1, 1, 2, 2], enc_depths: [2, 1, 1, 1, 1], "
    "dec_channels: [16, 16, 16, 32], dec_num_head: [1, 1, 1, 2], "
    "dec_depths: [2, 1, 1, 1], pixel_capacity: 512, drop_path: 0.0, "
    "shuffle_orders: false}"]


OBJECT_ARGV = ["--config-name", "transformer_pretraining",
               "data.dataset_root=synthetic"]
OBJECT_STEPS = 6
TOL_CACHED_LOSS = 1e-6   # cached vs live VAE step, relative
TOL_BF16_LOSS = 2e-2     # bfloat16 vs float32 step, relative
# the least the bfloat16 step must move the loss from the float32 one,
# relative: a run that computes in float32 whatever its dtype moves it by
# nothing (TF32 is off)
TOL_BF16_MOVES = 1e-4


def first_output_dtypes(kinds):
    """Records the output dtype of the first call of a module of each
    class in ``kinds`` ({label: class}) while it is open; a global forward
    hook, removed once every class has been seen. Returns (hook handle,
    {label: dtype})."""
    import torch
    seen = {}
    handle = None

    def hook(module, _, out):
        if isinstance(out, tuple):   # PCM's MambaBlock: (output, residual)
            out = out[0]
        for label, cls in kinds.items():
            if label not in seen and isinstance(module, cls) and \
                    torch.is_tensor(out):
                seen[label] = out.dtype
        if len(seen) == len(kinds):
            handle.remove()

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    return handle, seen


def hold_dtypes(label, seen, kinds, dtype):
    """Every class of ``kinds`` must have returned ``dtype``."""
    log(f"[train] {label}: first outputs' dtypes {seen}")
    if set(seen) != set(kinds) or any(d != dtype for d in seen.values()):
        raise AssertionError(f"{label}: modules {seen}, not all {dtype}")


def run_train(argv, counters, device_line, label, steps=3):
    """``train_network.main(argv)`` with the launch counts of ``counters``
    ({name: CudaKernel}) set to 0 just before and read just after; every
    one must have launched, every loss must be finite, and no step may
    have a non-finite gradient norm or be skipped by the NaN skip. Prints
    each step's time (with the cache: its attach + the step) and the
    cache's hit rate and buffer."""
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
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; compute "
        f"{result['compute_dtype']}) on {device_line}")
    if "cache_ms" in result:
        total = [a + b for a, b in zip(result["cache_ms"], result["step_ms"])]
        log(f"[train] {label}: VAE cache attach ms "
            f"{[round(t, 3) for t in result['cache_ms']]}, attach + step ms "
            f"{[round(t, 3) for t in total]}; hit rate "
            f"{result['hit_rate']:.4f} {result['cache_counts']}; buffer "
            f"{result['cache_gib']:.3f} GiB")
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
    """The default run (bfloat16, the VAE feature cache): six full-width
    object steps (dense splat) with their val loop, checkpoints and test
    videos through the streaming splat, then ``eval.main`` over the run;
    three full-width scene steps on each of the binned and auto (tiled
    renderer) routes; then the default run's holds
    (``default_run_holds``). Returns the launch counts of each kernel's
    path (the dense and binned splats, the streaming forward)."""
    import torch
    from unipre3d_tpu_torch import eval as eval_cli
    from unipre3d_tpu_torch.models import layers, sparseunet, vae
    from unipre3d_tpu_torch.ops.rasterizer import splat_binned as sb
    from unipre3d_tpu_torch.ops.rasterizer import splat_dense as sd
    from unipre3d_tpu_torch.ops.rasterizer import splat_stream as ss
    obj_dir = os.path.join(tmp, "object")
    # what the default run computes in, read off its modules on the card
    kinds = {"transformer Block": layers.Block,
             "VAE ResnetBlock2D": vae.ResnetBlock2D}
    handle, dtypes = first_output_dtypes(kinds)
    result, launches = run_train(
        OBJECT_ARGV + ["--output-dir", obj_dir,
                       f"opt.iterations={OBJECT_STEPS}",
                       "logging.loss_log=1", f"logging.val_log={OBJECT_STEPS}",
                       f"logging.loop_log={OBJECT_STEPS}",
                       "tpu.raster_impl=pallas"],
        {"dense_fwd": sd.DENSE_FWD, "dense_bwd": sd.DENSE_BWD,
         "stream_fwd": ss.STREAM_FWD}, device_line, "object",
        steps=OBJECT_STEPS)
    handle.remove()
    hold_dtypes("object", dtypes, kinds, torch.bfloat16)
    for name in ("model_latest.ckpt", "model_best.ckpt", "metrics.jsonl"):
        if not os.path.exists(os.path.join(obj_dir, name)):
            raise AssertionError(f"object run wrote no {name}")
    if result["compute_dtype"] != "bfloat16" or \
            not (result["hit_rate"] or 0) > 0:
        raise AssertionError(f"object default run: compute "
                             f"{result['compute_dtype']}, VAE cache hit rate "
                             f"{result['hit_rate']}")
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
        kinds = {"SparseUNet BasicBlock": sparseunet.BasicBlock,
                 "VAE ResnetBlock2D": vae.ResnetBlock2D}
        handle, dtypes = first_output_dtypes(kinds)
        res, counts = run_train(
            SCENE_ARGV + ["--output-dir", os.path.join(tmp, f"scene_{route}"),
                          f"tpu.raster_impl_train={route}",
                          "opt.iterations=3", "logging.loss_log=1"],
            counters, device_line, f"scene {route}")
        handle.remove()
        hold_dtypes(f"scene {route}", dtypes, kinds, torch.bfloat16)
        scene[route] = counts
        log(f"[train] scene {route}: valid rows {res['valid_rows']}, "
            f"geometry ms {[round(t, 3) for t in res['geometry_ms']]}"
            + (f"; each step's render: duplicates {res['dups']}, dropped by "
               f"the budget {res['budget_dropped']}, past the per-tile cap "
               f"{res['cap_dropped']}" if "dups" in res else ""))
    launches.update(scene["pallas_binned"])
    default_run_holds(device_line)
    return launches


# the object backbones of slice 8, each with its first block's class and
# whether its step runs the selective scan
NEW_BACKBONES = ("pointmlp", "mamba3d", "pcm")


def fps_shapes(backbone):
    """(B, N, C, npoint) of each furthest_point_sample call of one forward
    at batch 32 and 1024 points."""
    if backbone == "mamba3d":
        return [(32, 1024, 3, 128)]
    c = 4 if backbone == "pointmlp" else 3
    return [(32, n, c, n // 2) for n in (1024, 512, 256, 128)]


def fps_ms(backbone, device):
    """The FPS calls of one forward of ``backbone``, host clock around
    synchronized calls (its Python loop launches ~8 kernels a sample), ms;
    median of 3 after a warm-up."""
    import torch
    from unipre3d_tpu_torch.ops.point_ops import furthest_point_sample
    g = torch.Generator(device).manual_seed(0)
    clouds = [(torch.rand(B, N, C, device=device, generator=g), k)
              for B, N, C, k in fps_shapes(backbone)]

    def run():
        for x, k in clouds:
            furthest_point_sample(x, k)
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return sorted(times[1:])[1]


def phase_train_backbones(device_line, tmp):
    """The default run (bfloat16, the VAE feature cache) of each object
    backbone of slice 8 through ``train_network``: three full-width steps
    with their val loop. The dense splat pair must launch on every path,
    the selective-scan pair on Mamba3D's and PCM's; the first block of each
    backbone must return bfloat16. Prints each step's time, the peak
    memory, and the FPS calls' time beside the step's. Returns the launch
    counts summed over the three paths."""
    import torch
    from unipre3d_tpu_torch.models import mamba3d, pcm, pointmlp
    from unipre3d_tpu_torch.ops import scan as sc
    from unipre3d_tpu_torch.ops.rasterizer import splat_dense as sd
    first_block = {"pointmlp": ("PointMLP ConvBNReLURes",
                                pointmlp.ConvBNReLURes),
                   "mamba3d": ("Mamba3DBlock", mamba3d.Mamba3DBlock),
                   "pcm": ("PCM MambaBlock", pcm.MambaBlock)}
    total = {}
    for bb in NEW_BACKBONES:
        counters = {"dense_fwd": sd.DENSE_FWD, "dense_bwd": sd.DENSE_BWD}
        if bb != "pointmlp":
            counters.update(scan_fwd=sc.SCAN_FWD, scan_bwd=sc.SCAN_BWD)
        kinds = dict([first_block[bb]])
        handle, dtypes = first_output_dtypes(kinds)
        result, launches = run_train(
            ["--config-name", f"{bb}_pretraining",
             "data.dataset_root=synthetic", "--output-dir",
             os.path.join(tmp, bb), "opt.iterations=3", "logging.loss_log=1"],
            counters, device_line, bb)
        handle.remove()
        hold_dtypes(bb, dtypes, kinds, torch.bfloat16)
        if result["compute_dtype"] != "bfloat16":
            raise AssertionError(f"{bb}: compute {result['compute_dtype']}")
        step = sorted(result["step_ms"][1:])[len(result["step_ms"][1:]) // 2]
        fps = fps_ms(bb, torch.device("cuda"))
        log(f"[train] {bb}: FPS calls of one forward ({len(fps_shapes(bb))}"
            f" calls, {sum(k for *_, k in fps_shapes(bb))} samples) "
            f"{fps:.1f} ms against a median step of {step:.1f} ms (share "
            f"{fps / step:.3f}) on {device_line}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total


def default_run_holds(device_line):
    """One full-width object step from the same seed-0 weights on one
    batch of distinct images (``random_batch``), three ways: bfloat16 with
    the VAE live, bfloat16 with the features from the cache (every view a
    miss, so the cache runs the VAE on the same images), and float32 with
    the VAE live. The cached loss must equal the live one to
    TOL_CACHED_LOSS, the bfloat16 loss the float32 one to TOL_BF16_LOSS,
    and differ from it by TOL_BF16_MOVES at least; the first transformer
    block of each model must return its compute dtype."""
    import torch
    from unipre3d_tpu_torch import train_network
    from unipre3d_tpu_torch.data import batch_to, random_batch
    from unipre3d_tpu_torch.training import trainer
    from unipre3d_tpu_torch.training.config import load_config
    cfg = load_config("transformer_pretraining", overrides=OBJECT_ARGV[2:])
    n_in = int(cfg.data.input_images)
    batch = random_batch(cfg, batch=int(cfg.opt.batch_size), n_points=1024,
                         n_views=n_in + 4, seed=0)
    losses = {}
    for label, dtype, cached in (("bf16 live", torch.bfloat16, False),
                                 ("bf16 cached", torch.bfloat16, True),
                                 ("f32 live", torch.float32, False)):
        model, state = trainer.create_train_state(cfg, device="cuda", seed=0,
                                                  dtype=dtype)
        b = batch_to(batch, "cuda")
        if cached:
            cache = train_network.make_cache(cfg, model, "cuda")
            b["vae_features"] = cache.attach(batch, n_in)
        seen = []
        hook = model.point_network.encoder.block0.register_forward_hook(
            lambda _, __, out: seen.append(out.dtype))
        m = trainer.make_train_step(cfg, model)(state, b)
        hook.remove()
        if not math.isfinite(m["loss"]) or m["nan_skipped"]:
            raise AssertionError(f"{label} step: {m}")
        if not seen or set(seen) != {dtype}:
            raise AssertionError(f"{label} step: block0 returned {seen}")
        losses[label] = m["loss"]
        del model, state, b
        torch.cuda.empty_cache()
    cached_err = abs(losses["bf16 cached"] - losses["bf16 live"]) \
        / losses["bf16 live"]
    bf16_err = abs(losses["bf16 live"] - losses["f32 live"]) \
        / losses["f32 live"]
    log(f"[train] default-run holds, full-width object step: losses "
        f"{losses}; cached vs live {cached_err:.2e} (tol "
        f"{TOL_CACHED_LOSS:g}), bf16 vs f32 {bf16_err:.2e} (tol "
        f"{TOL_BF16_LOSS:g}, at least {TOL_BF16_MOVES:g}); block0 returned "
        f"each model's compute dtype, on {device_line}")
    if cached_err > TOL_CACHED_LOSS or bf16_err > TOL_BF16_LOSS:
        raise AssertionError("default run: the cached or the bf16 step "
                             "disagrees")
    if bf16_err < TOL_BF16_MOVES:
        raise AssertionError("default run: the bf16 step's loss is the "
                             "float32 one's")


def phase_train_ptv3(device_line, tmp):
    """The default run (bfloat16, the VAE feature cache) of
    ``ptv3_pretraining`` through ``train_network``: three full-width steps
    with their val loop on each of the binned and auto (tiled renderer)
    routes. The binned pair must launch on the binned path, the first
    PTv3Block and VAE block return bfloat16, no step may have a non-finite
    gradient norm or be skipped by the NaN skip. Prints each step's time,
    the geometry build's, the peak memory, each stage's valid rows and the
    parents each pooling dropped past its capacity. Returns the binned
    path's launch counts."""
    import torch
    from unipre3d_tpu_torch.models import ptv3, vae
    from unipre3d_tpu_torch.ops.rasterizer import splat_binned as sb
    launches = {}
    for route, counters in (
            ("pallas_binned", {"binned_fwd": sb.BINNED_FWD,
                               "binned_bwd": sb.BINNED_BWD}),
            ("auto", {})):
        kinds = {"PTv3Block": ptv3.PTv3Block,
                 "VAE ResnetBlock2D": vae.ResnetBlock2D}
        handle, dtypes = first_output_dtypes(kinds)
        res, counts = run_train(
            PTV3_ARGV + ["--output-dir", os.path.join(tmp, f"ptv3_{route}"),
                         f"tpu.raster_impl_train={route}",
                         "opt.iterations=3", "logging.loss_log=1"],
            counters, device_line, f"ptv3 {route}")
        handle.remove()
        hold_dtypes(f"ptv3 {route}", dtypes, kinds, torch.bfloat16)
        log(f"[train] ptv3 {route}: valid rows per stage {res['stage_rows']}"
            f"; parents dropped past each pooling's capacity "
            f"{res['pool_dropped']}; geometry ms "
            f"{[round(t, 3) for t in res['geometry_ms']]}"
            + (f"; each step's render: duplicates {res['dups']}, dropped by "
               f"the budget {res['budget_dropped']}, past the per-tile cap "
               f"{res['cap_dropped']}" if "dups" in res else "")
            + f" on {device_line}")
        if route == "pallas_binned":
            launches = counts
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


def without_drops(model):
    """DropPath and Dropout at rate 0: their masks come from the step's
    generator, whose draws differ between the card and the CPU. (The
    transformer's rates are 0 through its overrides; PointMLP has none;
    Mamba3D's and PCM's take no overrides.)"""
    from unipre3d_tpu_torch.models import mamba3d, pcm
    for m in model.modules():
        if isinstance(m, (mamba3d.Mamba3DBlock, pcm.MambaBlock)):
            m.drop_path = 0.0
        if isinstance(m, pcm.SegHead):
            m.dropout = 0.0
    return model


def step_snapshot(cfg, batch, dev, scale=1.0):
    """One train step of ``cfg`` on ``dev`` from seed-0 weights (the
    trainable ones times ``scale``), no DropPath or Dropout: (metrics,
    Adam's first moment per trainable tensor, on the CPU)."""
    import torch
    from unipre3d_tpu_torch.data import batch_to
    from unipre3d_tpu_torch.training import trainer
    model, state = trainer.create_train_state(
        cfg, device=dev, seed=0, dtype=trainer.compute_dtype_of(cfg))
    without_drops(model)
    if scale != 1.0:
        with torch.no_grad():
            for _, p in trainer.split_frozen(model)[0]:
                p.mul_(scale)
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


def ptv3_ops_snapshot(geo, n_views, img_h, img_w, dev):
    """Each op of the PTv3 backbone on ``dev`` over the geometry ``geo``:
    the xCPE conv on the PointFusion-merged set, the patch attention along
    each order of stage 0 (SDPA on the card), the pooling's segment max
    over stage 0's clusters, and the fusion merge: outputs and the
    gradients of a seeded random cotangent w.r.t. every input, on the CPU.
    None takes a decision a rounding could flip (random inputs hold no
    tied maxima), so card and CPU agree entry by entry."""
    import torch
    from unipre3d_tpu_torch.models.ptv3 import patch_attention
    from unipre3d_tpu_torch.models.sparseunet import point_fusion_merge
    from unipre3d_tpu_torch.ops import sparse as sp
    gen = torch.Generator().manual_seed(7)
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)  # noqa: E731
    B, M = geo.mask0.shape
    Mf, C = geo.fine_mask.shape[1], 32
    ser, cl = geo.sers[0], geo.clusters[0]
    cases = {
        "xcpe k3 merged": (lambda f, w: sp.subm_gather_matmul(
            f, geo.nbr3_fine, w), [rnd(B, Mf, C), rnd(27, C, C)]),
        "segment max": (lambda f: sp.segment_reduce(
            f, cl.parent_idx, cl.mask.shape[1], "max"), [rnd(B, Mf, C)]),
        "fusion merge": (lambda f, img: point_fusion_merge(f, img, geo),
                         [rnd(B, M, C), rnd(B * n_views, C, img_h, img_w)]),
    }
    for o in range(ser.order.shape[1]):
        cases[f"patch attention order {o}"] = (
            lambda q, o=o: patch_attention(q, ser.order[:, o],
                                           ser.inverse[:, o], geo.fine_mask,
                                           2, 48), [rnd(B, Mf, 3 * C)])
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
    gradients, :func:`sparse_ops_snapshot` (SparseUNet) or
    :func:`ptv3_ops_snapshot` (PTv3) over the step's geometry)."""
    import torch
    from unipre3d_tpu_torch.data import batch_to
    from unipre3d_tpu_torch.training import trainer
    model, _ = trainer.create_train_state(
        cfg, device=dev, seed=0, dtype=trainer.compute_dtype_of(cfg))
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
            (sparse_ops_snapshot if hasattr(b["geometry"], "downs") else
             ptv3_ops_snapshot)(b["geometry"], V, H, W, dev))


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
    from unipre3d_tpu_torch.data import random_batch
    from unipre3d_tpu_torch.training.config import load_config
    cfg = load_config("transformer_pretraining", overrides=FLOAT32_PINS + [
        "data.training_resolution=32", "opt.batch_size=2",
        "model.vae_overrides={block_out_channels: [32, 32, 32, 32], "
        "layers_per_block: 1}",
        "model.backbone_overrides={depth: 2, drop_path_rate: 0.0}"])
    batch = random_batch(cfg, batch=2, n_points=256, n_views=3, seed=0)
    compare_steps("object", *(step_snapshot(cfg, batch, d)
                              for d in ("cpu", "cuda")))
    hold_scene_step("scene", "sparseunet_pretraining",
                    SMALL_SCENE_OVERRIDES, "SparseUNet/PointFusion ops")


def scene_loss(cfg, batch, dtype):
    """The scene step's loss on the CPU from seed-0 weights, the backbone
    computing in ``dtype`` (the renderer stays float32)."""
    import torch
    from unipre3d_tpu_torch.data import batch_to
    from unipre3d_tpu_torch.training import trainer
    model, _ = trainer.create_train_state(cfg, device="cpu", seed=0,
                                          dtype=dtype)
    b = batch_to(batch, "cpu")
    model.train()
    with torch.no_grad():
        g = model(b["point_cloud"], b["gt_images"][:, :2],
                  unprojected_coords=b["unprojected_coords"])
        bg = trainer.bg_color_of(cfg)
        loss, _ = trainer.compute_loss(
            trainer.render_supervision_views(g, b, cfg, bg),
            b["gt_images"][:, 2:], cfg, bg)
    return float(loss)


def hold_scene_step(label, config, overrides, ops_label,
                    loss_rounding_floor=False):
    """One small scene step of ``config`` on the card and on the CPU, same
    weights and batch: the geometry exactly, the loss to 1e-5, the gradient
    w.r.t. the predicted gaussians and each op of the backbone over the
    step's geometry entry by entry to TOL_GRAD, the parameter gradients in
    relative L2 to TOL_SCENE_PARAM_L2. With ``loss_rounding_floor`` the
    loss is held to max(1e-5, 3x the CPU loss's own float32 rounding
    error), that error read against the same step with the backbone in
    float64."""
    import torch
    from unipre3d_tpu_torch.data import SyntheticSceneDataset, collate
    from unipre3d_tpu_torch.training.config import load_config
    cfg = load_config(config, overrides=overrides)
    ds = SyntheticSceneDataset(cfg, num_scenes=1, seed=0, device="cpu")
    batch = collate([ds[0]])
    (l_a, geo_a, out_a, gg_a, pg_a, ops_a), (l_b, geo_b, out_b, gg_b, pg_b,
                                             ops_b) = (
        scene_snapshot(cfg, batch, d) for d in ("cpu", "cuda"))
    tol_loss, floor_note = 1e-5, ""
    if loss_rounding_floor:
        l_64 = scene_loss(cfg, batch, torch.float64)
        own = abs(l_a - l_64) / abs(l_64)
        tol_loss = max(1e-5, 3 * own)
        floor_note = (f" = max(1e-5, 3x the CPU's own float32 rounding "
                      f"{own:.2e}, against a float64 backbone's loss "
                      f"{l_64:.7f})")
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
    log(f"[parity] {label}: geometry ({len(geo_a)} index tensors) card == "
        f"CPU: {same}; loss cpu {l_a:.7f} cuda {l_b:.7f} (rel "
        f"{loss_err:.2e}, tol {tol_loss:.2e}{floor_note}); predicted "
        f"gaussians, max rel err per field {out_err:.2e}; "
        f"gradient w.r.t. the gaussians {gauss_err:.2e} (tol {TOL_GRAD:g}); "
        f"{ops_label} ({len(ops_err)} outputs and gradients) "
        f"{ops_err[worst_op]:.2e} at {worst_op} (tol {TOL_GRAD:g}); "
        f"parameter gradients, relative L2 {param_l2:.2e} (tol "
        f"{TOL_SCENE_PARAM_L2:g})")
    if not same or loss_err > tol_loss or gauss_err > TOL_GRAD or \
            ops_err[worst_op] > TOL_GRAD or param_l2 > TOL_SCENE_PARAM_L2:
        raise AssertionError(f"{label}: card step disagrees with the CPU "
                             f"step")


def phase_parity_ptv3():
    """One float32 step of a small PTv3 configuration (the small scene of
    the SparseUNet parity with a narrow five-stage PTv3, DropPath and the
    order shuffle off) on the card (kernels, SDPA) and on the CPU (plain
    versions), same weights and batch, held as the SparseUNet scene step
    (``hold_scene_step``; the ops: ``ptv3_ops_snapshot``), the loss to
    max(1e-5, 3x its own float32 rounding on the CPU): this step's loss
    moves by about 1e-5 or more between a float32 and a float64 backbone
    on the CPU alone (the phase prints it), where SparseUNet's moves far
    less: the blocks' rounding moves every pixel of the renders the same
    way."""
    hold_scene_step("ptv3", "ptv3_pretraining", SMALL_PTV3_OVERRIDES,
                    "PTv3 ops", loss_rounding_floor=True)


def unclipped_grads(model_state_metrics):
    """The step's gradient per trainable tensor, from Adam's first moment
    after one step (0.1 x the gradient clipped to norm 1), unclipped."""
    metrics, mu = model_state_metrics
    scale = 10.0 * max(metrics["grad_norm"], 1.0)
    return metrics, {n: m * scale for n, m in mu.items()}


def phase_parity_backbones():
    """One float32 step of each object backbone of slice 8 at full width
    (tiny VAE, batch 2, 256 points, 32x32; DropPath and Dropout at rate 0)
    on the card and on the CPU, same weights and batch: the loss to 1e-5
    relative, and each trainable tensor's gradient (unclipped) in relative
    L2 to TOL_STEP_GRAD, or to 3x the
    distance the CPU's own gradient moves when the weights are scaled by
    1 + 1e-6 where that is larger: at random init PointMLP's and PCM's
    max-pools over K neighbours hold near-ties that such a perturbation
    flips (tests/test_torch_object_backbones.py)."""
    from unipre3d_tpu_torch.data import random_batch
    from unipre3d_tpu_torch.training.config import load_config
    for bb in NEW_BACKBONES:
        cfg = load_config(f"{bb}_pretraining", overrides=FLOAT32_PINS + [
            "data.training_resolution=32", "opt.batch_size=2",
            "model.vae_overrides={block_out_channels: [32, 32, 32, 32], "
            "layers_per_block: 1}"])
        batch = random_batch(cfg, batch=2, n_points=256, n_views=3, seed=0)
        m_a, g_a = unclipped_grads(step_snapshot(cfg, batch, "cpu"))
        _, g_moved = unclipped_grads(step_snapshot(cfg, batch, "cpu",
                                                   scale=1 + 1e-6))
        m_b, g_b = unclipped_grads(step_snapshot(cfg, batch, "cuda"))
        rel = lambda a, b: float((b - a).norm() / (a.norm() + 1e-30))  # noqa
        gmax = max(float(g.abs().max()) for g in g_a.values())
        worst, worst_name, n_noise = 0.0, None, 0
        for n, a in g_a.items():
            own = rel(a, g_moved[n])
            if float(a.abs().max()) < 1e-3 * gmax and own > 0.1:
                # the rounding noise of an analytically zero gradient
                n_noise += 1
                if float(g_b[n].abs().max()) >= 1e-3 * gmax:
                    raise AssertionError(f"{bb}: {n} should be noise")
                continue
            lim = max(TOL_STEP_GRAD, 3 * own)
            if rel(a, g_b[n]) / lim > worst:
                worst, worst_name = rel(a, g_b[n]) / lim, n
        loss_err = abs(m_a["loss"] - m_b["loss"]) / abs(m_a["loss"])
        log(f"[parity] {bb}: loss cpu {m_a['loss']:.7f} cuda "
            f"{m_b['loss']:.7f} (rel {loss_err:.2e}, tol 1e-5); gradient "
            f"rel L2 over its bound at most {worst:.3f} (at {worst_name}; "
            f"bound max({TOL_STEP_GRAD:g}, 3x the CPU's own move); "
            f"{n_noise} analytically zero tensors are noise on both)")
        if loss_err > 1e-5 or worst > 1.0:
            raise AssertionError(f"{bb}: card step disagrees with the CPU "
                                 f"step")


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
                          overrides=FLOAT32_PINS + [f"tpu.raster_impl={impl}"])
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

    cfg = load_config("transformer_pretraining", overrides=FLOAT32_PINS + [
        "data.training_resolution=32",
        "model.vae_overrides={block_out_channels: [32, 32, 32, 32], "
        "layers_per_block: 1}",
        "model.backbone_overrides={depth: 2, drop_path_rate: 0.0}"])
    batch = random_batch(cfg, batch=2, n_points=256, n_views=3, seed=3)
    evals = []
    for dev in ("cpu", "cuda"):
        model, state = trainer.create_train_state(
            cfg, device=dev, seed=0, dtype=trainer.compute_dtype_of(cfg))
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


LPIPS_STEPS = 3
# the LPIPS module on the card against the CPU, float32, TF32 off, on 8
# image pairs at 128x128: the distances relative. Its gradient to the first
# images is ill-conditioned (a feature vector near zero is divided by
# sqrt(sum a^2 + 1e-10), which multiplies rounding by up to 1e5;
# tests/test_torch_lpips.py), so each float32 gradient is held against a
# float64 one on the card: the card's error, relative to the largest entry,
# at most LPIPS_FLOAT64_MULTIPLE times the CPU's own
TOL_LPIPS_CARD = 1e-4
LPIPS_FLOAT64_MULTIPLE = 2.0


def lpips_weights(path, seed=0):
    """Random LPIPS weights from ``seed`` (convolutions with He's variance,
    per-channel weights N(0.5, 1)) written as the ``.npz`` of the converted
    tree (``/``-joined keys) that ``opt.lpips_weights`` reads."""
    import numpy as np
    from unipre3d_tpu_torch.utils.lpips import VGG_CHANNELS, VGG_SLICES
    rng = np.random.default_rng(seed)
    flat, cin = {}, 3
    for idxs, chans in zip(VGG_SLICES, VGG_CHANNELS):
        for idx, ch in zip(idxs, chans):
            flat[f"vgg/conv{idx}/kernel"] = rng.normal(
                0, math.sqrt(2.0 / (9 * cin)), (3, 3, cin, ch)).astype(
                    np.float32)
            flat[f"vgg/conv{idx}/bias"] = rng.normal(0, 0.05, ch).astype(
                np.float32)
            cin = ch
    for i, chans in enumerate(VGG_CHANNELS):
        flat[f"lin{i}"] = (rng.normal(0, 1, chans[-1]) + 0.5).astype(
            np.float32)
    np.savez(path, **flat)
    return path


def lpips_card_vs_cpu(params, device_line):
    """The LPIPS module on the card against the CPU on 8 textured image
    pairs at 128x128: distances, and the gradient to the first images
    against a float64 one on the card, as near as the CPU's; then
    its forward + backward at the step's shape (128 renders against their
    ground truth) timed with CUDA events, TF32 off and on."""
    import numpy as np
    import torch
    from unipre3d_tpu_torch.utils.lpips import build_lpips, lpips_fn
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (8, 3, 128, 128)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.3, x.shape), -1, 1).astype(np.float32)
    out = {}
    for dev, dtype in (("cpu", torch.float32), ("cuda", torch.float32),
                       ("cuda", torch.float64)):
        model = build_lpips(params, dev).to(dtype)
        tx = torch.from_numpy(x).to(dev, dtype).requires_grad_(True)
        d = model(tx, torch.from_numpy(y).to(dev, dtype))
        d.sum().backward()
        out[dev, dtype] = (d.detach().cpu().double().numpy(),
                           tx.grad.cpu().double().numpy())
    (dc, gc), (dg, gg), (_, g64) = out.values()

    def rel(a, b):
        return (float(np.abs(a - b).max() / np.abs(b).max()),
                float(np.linalg.norm(a - b) / np.linalg.norm(b)))
    d_err = rel(dg, dc)[0]
    g_err, c_err, gc_err = rel(gg, g64), rel(gc, g64), rel(gg, gc)
    log(f"[lpips] card vs CPU, 8 pairs at 128x128: distances {dc.tolist()}, "
        f"max rel err {d_err:.3e} (tol {TOL_LPIPS_CARD}); gradient to the "
        f"first images, max / L2 err of its largest / norm: card vs CPU "
        f"{gc_err[0]:.3e} / {gc_err[1]:.3e}, card float32 vs float64 "
        f"{g_err[0]:.3e} / {g_err[1]:.3e}, CPU float32 vs float64 "
        f"{c_err[0]:.3e} / {c_err[1]:.3e} (card at most "
        f"{LPIPS_FLOAT64_MULTIPLE}x the CPU's)")
    if not d_err <= TOL_LPIPS_CARD or \
            not g_err[0] <= LPIPS_FLOAT64_MULTIPLE * c_err[0]:
        raise AssertionError(f"LPIPS card vs CPU: {d_err}, {g_err}, {c_err}")
    model = build_lpips(params, "cuda")
    r = torch.rand(128, 3, 128, 128, device="cuda", requires_grad=True)
    g = torch.rand(128, 3, 128, 128, device="cuda")

    def fwd_bwd():
        lpips_fn(model, r * 2 - 1, g * 2 - 1).mean().backward()
    times = {}
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        times[tf32] = cuda_ms(fwd_bwd, 5)
    torch.backends.cudnn.allow_tf32 = False
    log(f"[lpips] forward + backward of 128 renders against their ground "
        f"truth at 128x128: {times[False]:.3f} ms TF32 off, "
        f"{times[True]:.3f} ms cuDNN TF32 on (the CLI's default) on "
        f"{device_line}")


def phase_warm_start_lpips_export(device_line, tmp):
    """Export, warm start and LPIPS on the object run that ``phase_train``
    left behind: its export (``export_checkpoint``) must load with
    ``torch.load`` and equal, key for key and bit for bit, the export of
    its checkpoint loaded into a model on the CPU (the EMA in place); a new
    full-width default run (bf16, the cache) warm-starts from that ``.pth``
    with random LPIPS weights and the term from step 1
    (``opt.start_lpips_after=0``) for three steps and val: right after the
    warm start its backbone, parameters and EMA, equals the exported
    tensors; ``lpips`` is exactly 0 at the first step and finite and above
    0 at the others; the dense pair launches; no NaN skip; then
    ``eval.main`` over that run must give numbers in both LPIPS columns.
    Then the LPIPS module on the card against the CPU and its time
    (``lpips_card_vs_cpu``). Returns the dense pair's launch counts."""
    import torch
    import yaml
    from unipre3d_tpu_torch import eval as eval_cli
    from unipre3d_tpu_torch import export_checkpoint, train_network
    from unipre3d_tpu_torch.export import export_predictor
    from unipre3d_tpu_torch.ops.rasterizer import splat_dense as sd
    from unipre3d_tpu_torch.training import checkpoint as ckpt_lib
    from unipre3d_tpu_torch.training import trainer
    from unipre3d_tpu_torch.training.config import ConfigNode
    from unipre3d_tpu_torch.utils.lpips import load_lpips_params
    t0 = time.perf_counter()
    obj_dir = os.path.join(tmp, "object")
    pth = export_checkpoint.main([obj_dir, "--out",
                                  os.path.join(tmp, "backbone.pth")])
    exported = torch.load(pth, map_location="cpu", weights_only=False)
    with open(os.path.join(obj_dir, ".hydra", "config.yaml")) as f:
        cfg = ConfigNode.from_obj(yaml.safe_load(f))
    model, state = trainer.create_train_state(cfg, device="cpu", seed=1)
    # the checkpoint holds the card's DropPath generator
    state.generator = torch.Generator(device="cuda")
    ckpt_lib.load_checkpoint(os.path.join(obj_dir, "model_latest.ckpt"),
                             model, state)
    want = export_predictor({**model.state_dict(), **state.ema},
                            "transformer")
    del model, state
    got = exported["model_state_dict"]
    if set(got) != set(want) or exported["iteration"] != OBJECT_STEPS or             exported["backbone"] != "transformer" or any(
                not torch.equal(got[k], torch.from_numpy(want[k]))
                for k in want):
        raise AssertionError("the object run's export differs from its "
                             "checkpoint's export on the CPU")
    log(f"[export] object run: {len(got)} tensors at iteration "
        f"{exported['iteration']}, equal to the CPU export of its "
        f"checkpoint ({time.perf_counter() - t0:.1f} s)")

    prefix = "point_network.encoder."
    backbone = {k: v for k, v in got.items() if k.startswith(prefix)}
    warm = train_network.warm_start
    started = []

    def checked_warm_start(model, state, path):
        n = warm(model, state, path)
        sd_now = model.state_dict()
        for tag, weights in (("parameters", sd_now),
                             ("EMA", {**sd_now, **state.ema})):
            now = export_predictor(weights, "transformer")
            bad = [k for k, v in backbone.items()
                   if not torch.equal(v, torch.from_numpy(now[k]))]
            if bad:
                raise AssertionError(f"warm start: the {tag} differ from the "
                                     f"export at {bad[:3]}")
        started.append(n)
        return n

    npz = lpips_weights(os.path.join(tmp, "lpips.npz"))
    warm_dir = os.path.join(tmp, "warm_lpips")
    train_network.warm_start = checked_warm_start
    try:
        result, launches = run_train(
            OBJECT_ARGV + ["--output-dir", warm_dir,
                           f"opt.pretrained_ckpt={pth}",
                           f"opt.lpips_weights={npz}",
                           "opt.start_lpips_after=0",
                           f"opt.iterations={LPIPS_STEPS}",
                           "logging.loss_log=1",
                           f"logging.val_log={LPIPS_STEPS}",
                           "logging.loop_log=100000"],
            {"dense_fwd": sd.DENSE_FWD, "dense_bwd": sd.DENSE_BWD},
            device_line, "warm start + LPIPS", steps=LPIPS_STEPS)
    finally:
        train_network.warm_start = warm
    peak = torch.cuda.max_memory_allocated() / 2**30
    lp = result.get("lpips", [])
    if started != [len(backbone)] or len(lp) != LPIPS_STEPS or lp[0] != 0.0             or not all(math.isfinite(v) and v > 0 for v in lp[1:]):
        raise AssertionError(f"warm start {started} of {len(backbone)} "
                             f"tensors; lpips {lp}")
    total = [a + b for a, b in zip(result["cache_ms"], result["step_ms"])]
    log(f"[lpips] warm-started run: lpips {lp}; attach + step ms "
        f"{[round(t, 3) for t in total]} (step 1 gated off, LPIPS in steps "
        f"2-{LPIPS_STEPS}); peak device memory {peak:.2f} GiB on "
        f"{device_line}")
    sd.DENSE_FWD.launches = 0
    scores = eval_cli.main([warm_dir])
    if not all(scores[k] is not None and math.isfinite(scores[k])
               for k in ("LPIPS_cond", "LPIPS_novel", "PSNR_novel")):
        raise AssertionError(f"warm-started run's eval: {scores}")
    log(f"[eval] warm-started run with LPIPS (dense launches "
        f"{sd.DENSE_FWD.launches}): {scores}")
    lpips_card_vs_cpu(load_lpips_params(npz), device_line)
    log(f"[lpips] phase {time.perf_counter() - t0:.1f} s")
    return launches


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


def kernel_rows(dense, binned, stream, scan, launches):
    """The ``{"kernels": [...]}`` rows of the six ported Pallas kernels and
    of the selective-scan pair (which replaces a jax.lax.associative_scan,
    no Pallas kernel)."""
    rows = []
    rast = "unipre3d_tpu/ops/rasterizer/"
    for timing, src, tpu_file, entries in (
            (dense, "splat_dense", rast + "pallas_splat_dense.py",
             (("fwd", "dense_fwd", "_dense_fwd_kernel", 193),
              ("bwd", "dense_bwd", "_dense_bwd_kernel", 220))),
            (binned, "splat_binned", rast + "pallas_splat_binned.py",
             (("fwd", "binned_fwd", "_fwd_kernel", 73),
              ("bwd", "binned_bwd", "_bwd_kernel", 116))),
            (stream, "splat_stream", rast + "pallas_splat.py",
             (("fwd", "stream_fwd", "_fwd_kernel", 103),
              ("bwd", "stream_bwd", "_bwd_kernel", 137))),
            (scan, "selective_scan", "unipre3d_tpu/ops/scan.py",
             (("fwd", "scan_fwd", "selective_scan, jax.lax.associative_scan",
               36),
              ("bwd", "scan_bwd", "selective_scan's gradient", 36)))):
        for key, fn, kern, line in entries:
            t = timing[key]
            rows.append({
                "name": f"{src}.{fn}", "route": "cuda",
                "source": f"unipre3d_tpu_torch/csrc/{src}.cu",
                "replaces": f"{tpu_file}:{line} ({kern})",
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

    build_kernels(["splat_dense", "splat_binned", "splat_stream",
                   "selective_scan"])
    dense = phase_kernels(device)
    scan = phase_scan_kernels(device)
    binned = phase_binned_kernels(device)
    stream = phase_stream_kernels(device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        launches = phase_train(smi, tmp)
        for k, v in phase_train_backbones(smi, tmp).items():
            launches[k] = launches.get(k, 0) + v
        for k, v in phase_train_ptv3(smi, tmp).items():
            launches[k] = launches.get(k, 0) + v
        phase_test_renders(smi, tmp)
        for k, v in phase_warm_start_lpips_export(smi, tmp).items():
            launches[k] += v
    phase_parity()
    phase_parity_backbones()
    phase_parity_ptv3()
    launches["stream_bwd"] = phase_eval_parity()

    rows = kernel_rows(dense, binned, stream, scan, launches)
    log(f"[done] {time.time() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
