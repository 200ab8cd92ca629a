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
   (object path) and the binned splat (scene path).
4. train: three full-width ``transformer_pretraining`` train steps, then
   three full-width ``sparseunet_pretraining`` steps on the binned route,
   on synthetic data through ``unipre3d_tpu_torch.train_network``; each
   path's kernel launch counts are set to 0 just before it and read just
   after, and every kernel of the path must have launched. No scene step
   may have a non-finite gradient norm or be skipped by the NaN skip.
5. parity: one train step of a small object and a small scene configuration
   on the card (kernels) against the same step on the CPU (plain versions),
   same weights and batch; for the scene also each SparseUNet/PointFusion
   op over the step's geometry.

It prints a ``{"kernels": [...]}`` line, then the card's name and power
limit, then as its last line ``{"ok": true, "device": {...}}``. Without a
CUDA device, or without the repository beside it, it exits non-zero and
prints no result. TF32 is off for every phase (``allow_tf32 = False`` for
matmuls and cuDNN), so the float32 comparisons are float32.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
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
    t_bytes = nbytes / PEAK_BYTES
    t_ops = max(pairs * per_pair[0] / PEAK_F32, pairs * per_pair[1] / PEAK_SFU)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernels(device):
    """Each dense kernel against its plain version at three shapes."""
    import torch
    from unipre3d_tpu_torch.ops.rasterizer import splat_dense as sd

    shapes = [  # (R, N, H, W): main path, multi-chunk, top of the route
        (128, 128, 128, 128), (8, 1000, 128, 128), (4, 4096, 128, 128)]
    results = {}
    for si, (R, N, H, W) in enumerate(shapes):
        data, bg, g_out = make_case(R, N, H, W, seed=si, device=device)
        n_pad = data.shape[-1]
        out, tfin = sd.dense_fwd(data, bg, H, W)
        dgrad, dbg = sd.dense_bwd(data, bg, out, tfin, g_out, H, W)
        torch.cuda.synchronize()
        out_r, tfin_r = sd.dense_splat_fwd_ref(data, bg, H, W)
        dgrad_r, dbg_r = sd.dense_splat_bwd_ref(data, bg, tfin_r, g_out, H, W)
        err_out = float((out - out_r).abs().max())
        err_t = float((tfin - tfin_r).abs().max())
        t_mismatch = int((tfin != tfin_r).sum())
        row_err = [float((dgrad[:, k] - dgrad_r[:, k]).abs().max()
                         / (dgrad_r[:, k].abs().max() + 1e-12))
                   for k in range(9)]
        err_bg = float((dbg - dbg_r).abs().max() / (dbg_r.abs().max() + 1e-12))
        abs_bwd = max(float((dgrad - dgrad_r).abs().max()),
                      float((dbg - dbg_r).abs().max()))
        fwd_ok = err_out <= TOL_IMAGE and err_t <= TOL_IMAGE
        bwd_ok = max(row_err) <= TOL_GRAD and err_bg <= TOL_GRAD
        log(f"[kernels] R={R} N={N} (N_pad {n_pad}) {H}x{W}: fwd max|err| "
            f"out {err_out:.3e} T {err_t:.3e} (T bit-mismatches {t_mismatch})"
            f" tol {TOL_IMAGE:g}; bwd max rel err per row "
            f"{max(row_err):.3e} ({', '.join(f'{e:.1e}' for e in row_err)}) "
            f"dbg {err_bg:.3e} tol {TOL_GRAD:g}; bwd max|err| {abs_bwd:.3e}")
        if not (fwd_ok and bwd_ok):
            raise AssertionError(f"kernel disagrees with its plain version "
                                 f"at R={R} N={N}")
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
                max_per_tile=4096):
    """Random gaussians (``random_gaussians``) on the card, their sorted
    duplicate list and table at the binned route's tiles, bg and a random
    cotangent. Returns a dict."""
    import torch
    from unipre3d_tpu_torch.ops.rasterizer import splat_binned as sb
    from unipre3d_tpu_torch.ops.rasterizer.render import binned_tile
    g = torch.Generator().manual_seed(seed)
    gs = [t.to(device) for t in random_gaussians(R, N, H, W, g, invalid)]
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
    version's walk: (contributing (pixel, duplicate) pairs, table columns a
    tile must read: in each 1024-chunk of its capped list those up to the
    one where its last pixel stops, columns within the per-tile caps)."""
    import torch
    from unipre3d_tpu_torch.ops.rasterizer import splat_binned as sb
    from unipre3d_tpu_torch.ops.rasterizer.pack import LOG_T_EPS
    px, py, _ = sb._tile_pixels(R, H, W, th, tw, table.device)
    count = (seg[1:] - seg[:-1]).long().clamp(max=maxn)
    pairs = torch.zeros((), dtype=torch.int64, device=table.device)
    cols = torch.zeros((), dtype=torch.int64, device=table.device)
    log_t = torch.zeros_like(px)
    stopped = torch.zeros_like(px, dtype=torch.bool)
    for j, (_, _, terms, log_t_after) in enumerate(
            sb._walk(seg, sb._padded(table), px, py, maxn)):
        alpha, skip, contrib = terms[0], terms[4], terms[5]
        if j % sb.CHUNK == 0:
            stopped = torch.zeros_like(stopped)
        cols += ((j < count) & ~stopped.all(1)).sum()
        stopped = stopped | (~skip & (log_t + torch.log1p(-alpha) < LOG_T_EPS))
        log_t = log_t_after
        pairs += contrib.sum()
    return int(pairs), int(cols), int(count.sum())


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
    """The binned kernels against their plain versions at three shapes: the
    scene renderer's load (8 views, 84,096 valid gaussians, 120x160), a
    case past the per-tile cap and the budget, and a small case whose tiles
    hold more than 1024 duplicates (chunk re-arm)."""
    import torch
    from unipre3d_tpu_torch.ops.rasterizer import splat_binned as sb

    shapes = [  # (label, R, N, H, W, invalid, budget, max_per_tile)
        ("scene", 8, 84096, 120, 160, 0.0, None, 4096),
        ("overflow", 2, 20000, 120, 160, 0.1, 160 * 1024, 1024),
        ("re-arm", 1, 3000, 32, 32, 0.1, None, 4096)]
    results = {"fwd_err": 0.0, "bwd_err": 0.0}
    for si, (label, R, N, H, W, invalid, budget, cap) in enumerate(shapes):
        c = binned_case(R, N, H, W, 100 + si, device, invalid, budget, cap)
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
        row_err = [float((dgrad[k] - dgrad_r[k]).abs().max()
                         / (dgrad_r[k].abs().max() + 1e-12))
                   for k in range(9)]
        abs_bwd = float((dgrad - dgrad_r).abs().max())
        log(f"[kernels] binned {label}: R={R} N={N} {H}x{W} tiles {th}x{tw} "
            f"cap {maxn} budget {c['budget']}: {c['dups']} duplicates "
            f"(budget dropped {c['budget_dropped']}, cap dropped "
            f"{c['cap_dropped']}); fwd max|err| out {err_out:.3e} T "
            f"{err_t:.3e} (T bit-mismatches {t_mismatch}) tol {TOL_IMAGE:g}; "
            f"bwd max rel err per row {max(row_err):.3e} "
            f"({', '.join(f'{e:.1e}' for e in row_err)}) tol {TOL_GRAD:g}; "
            f"bwd max|err| {abs_bwd:.3e}")
        if not (err_out <= TOL_IMAGE and err_t <= TOL_IMAGE
                and t_mismatch == 0 and max(row_err) <= TOL_GRAD):
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
        if label == "scene":
            it_k = 20
            ms_f = cuda_ms(lambda: sb.binned_fwd(seg, table, bg, *args), it_k)
            ms_b = cuda_ms(lambda: sb.binned_bwd(seg, table, bg, logt, tot,
                                                 g_out, *args), it_k)
            pms_f = cuda_ms(lambda: sb.binned_fwd_ref(seg, table, bg, *args), 1)
            pms_b = cuda_ms(lambda: sb.binned_bwd_ref(
                seg, table, bg, logt_r, tot, g_out, *args), 1)
            pairs, cols, capped = binned_work(seg, table, *args)
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


SCENE_ARGV = ["--config-name", "sparseunet_pretraining",
              "data.pts_dataset_root=synthetic",
              "tpu.raster_impl_train=pallas_binned", "opt.batch_size=1"]
# the small scene of the parity phase (no tile is cut)
SMALL_SCENE_OVERRIDES = SCENE_ARGV[2:] + [
    "data.training_width=32", "data.training_height=32",
    "data.input_images=2", "data.max_points=1024",
    "tpu.raster_tile_capacity=1024",
    "model.vae_overrides={block_out_channels: [32, 32, 32, 32], "
    "layers_per_block: 1}",
    "model.backbone_overrides={channels: [16, 16, 24, 24, 24, 16, 16, 16], "
    "layers: [1, 1, 1, 1, 1, 1, 1, 1], pixel_capacity: 512}"]


def run_train(argv, counters, device_line, label):
    """``train_network.main(argv)`` with the launch counts of ``counters``
    ({name: CudaKernel}) set to 0 just before and read just after; every
    one must have launched and every loss must be finite."""
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
    log(f"[train] {label}: launches {launches}")
    if len(losses) != 3 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label} train losses not finite: {losses}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the {label} path never launched: "
                             f"{launches}")
    return result, launches


def phase_train(device_line):
    """Three full-width object steps (dense splat), then three full-width
    scene steps (binned splat)."""
    from unipre3d_tpu_torch.ops.rasterizer import splat_binned as sb
    from unipre3d_tpu_torch.ops.rasterizer import splat_dense as sd
    _, launches = run_train(
        ["--config-name", "transformer_pretraining",
         "data.dataset_root=synthetic", "opt.iterations=3",
         "logging.loss_log=1"],
        {"dense_fwd": sd.DENSE_FWD, "dense_bwd": sd.DENSE_BWD},
        device_line, "object")
    result, scene = run_train(
        SCENE_ARGV + ["opt.iterations=3", "logging.loss_log=1"],
        {"binned_fwd": sb.BINNED_FWD, "binned_bwd": sb.BINNED_BWD},
        device_line, "scene")
    log(f"[train] scene: valid rows {result['valid_rows']}, geometry ms "
        f"{[round(t, 3) for t in result['geometry_ms']]}; each step's "
        f"render: duplicates {result['dups']}, dropped by the budget "
        f"{result['budget_dropped']}, past the per-tile cap "
        f"{result['cap_dropped']}")
    if not all(math.isfinite(x) for x in result["grad_norms"]) or \
            any(result["nan_skipped"]):
        raise AssertionError(f"scene step with a non-finite gradient: "
                             f"grad_norm {result['grad_norms']}, NaN skip "
                             f"{result['nan_skipped']}")
    launches.update(scene)
    return launches


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


def kernel_rows(dense, binned, launches):
    """The ``{"kernels": [...]}`` rows of the four ported kernels."""
    rows = []
    for timing, src, tpu_file, entries in (
            (dense, "splat_dense", "pallas_splat_dense.py",
             (("fwd", "dense_fwd", "_dense_fwd_kernel", 193),
              ("bwd", "dense_bwd", "_dense_bwd_kernel", 220))),
            (binned, "splat_binned", "pallas_splat_binned.py",
             (("fwd", "binned_fwd", "_fwd_kernel", 73),
              ("bwd", "binned_bwd", "_bwd_kernel", 116)))):
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

    build_kernels(["splat_dense", "splat_binned"])
    dense = phase_kernels(device)
    binned = phase_binned_kernels(device)
    launches = phase_train(smi)
    phase_parity()

    rows = kernel_rows(dense, binned, launches)
    log(f"[done] {time.time() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
