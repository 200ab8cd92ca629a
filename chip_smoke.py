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
   its route takes, and times both with CUDA events.
4. train: three full-width ``transformer_pretraining`` train steps on
   synthetic data through ``unipre3d_tpu_torch.train_network``, with every
   kernel launch count set to 0 just before and read just after; every
   kernel of the path must have launched.
5. parity: one train step of a small configuration on the card (kernels)
   against the same step on the CPU (plain versions), same weights and batch.

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

TOL_IMAGE = 1e-4   # max abs error of images and T (pixel values in [0, 1])
TOL_GRAD = 1e-4    # max abs error over max |reference|, per gradient row
# whole step, card vs CPU, per parameter tensor: cuBLAS/cuDNN float32 and
# the kernels' atomics sum in other orders than the CPU
TOL_STEP_GRAD = 1e-3


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


def make_case(R, N, H, W, seed, device):
    """Random projected gaussians in pixel space, depth-sorted and packed:
    sizes from sub-pixel to a sixth of the image, 10% at opacity 1 (the
    0.99 cap), 10% invalid. Returns (data [R,16,N_pad], bg [3], g_out)."""
    import torch
    from unipre3d_tpu_torch.ops.rasterizer.splat_dense import sorted_table
    g = torch.Generator().manual_seed(seed)
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
    valid = u(R, N) > 0.1
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


def phase_train(device_line):
    import torch
    from unipre3d_tpu_torch import train_network
    from unipre3d_tpu_torch.ops.rasterizer import splat_dense as sd
    argv = ["--config-name", "transformer_pretraining",
            "data.dataset_root=synthetic", "opt.iterations=3",
            "logging.loss_log=1"]
    sd.DENSE_FWD.launches = 0
    sd.DENSE_BWD.launches = 0
    result = train_network.main(argv)
    launches = {"dense_fwd": sd.DENSE_FWD.launches,
                "dense_bwd": sd.DENSE_BWD.launches}
    torch.cuda.synchronize()
    losses = result["losses"]
    log(f"[train] losses {losses} psnr {result['psnrs']}")
    log(f"[train] step ms {[round(t, 3) for t in result['step_ms']]} "
        f"(setup {result['setup_s']:.1f} s) on {device_line}")
    log(f"[train] launches {launches}")
    if len(losses) != 3 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train losses not finite: {losses}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    return launches


def phase_parity(devices=("cpu", "cuda")):
    """One small train step on the card (kernels) and on the CPU (plain
    versions) from the same weights and batch. Gradients are compared
    through Adam's first moment (0.1 x the clipped gradient), per tensor,
    relative to its largest entry; biases ahead of a BatchNorm have an
    analytically zero gradient and must be noise on both sides."""
    import torch
    from unipre3d_tpu_torch.data import batch_to, random_batch
    from unipre3d_tpu_torch.training import trainer
    from unipre3d_tpu_torch.training.config import load_config
    cfg = load_config("transformer_pretraining", overrides=[
        "data.training_resolution=32", "opt.batch_size=2",
        "model.vae_overrides={block_out_channels: [32, 32, 32, 32], "
        "layers_per_block: 1}",
        "model.backbone_overrides={depth: 2, drop_path_rate: 0.0}"])
    batch = random_batch(cfg, batch=2, n_points=256, n_views=3, seed=0)
    res = {}
    for dev in devices:
        model, state = trainer.create_train_state(cfg, device=dev, seed=0)
        metrics = trainer.make_train_step(cfg, model)(state,
                                                      batch_to(batch, dev))
        names = [n for n, _ in trainer.split_frozen(model)[0]]
        res[dev] = (metrics, {n: m.cpu() for n, m in
                              zip(names, state.optimizer.mu)})
    (m_a, g_a), (m_b, g_b) = res[devices[0]], res[devices[1]]
    gmax = max(float(g.abs().max()) for g in g_a.values())
    worst = 0.0
    for n, a in g_a.items():
        amax = float(a.abs().max())
        if amax < 1e-3 * gmax:
            assert float(g_b[n].abs().max()) < 1e-3 * gmax, n
            continue
        worst = max(worst, float((g_b[n] - a).abs().max()) / amax)
    loss_err = abs(m_a["loss"] - m_b["loss"]) / abs(m_a["loss"])
    log(f"[parity] loss {devices[0]} {m_a['loss']:.7f} {devices[1]} "
        f"{m_b['loss']:.7f} (rel {loss_err:.2e}, tol 1e-5); max gradient "
        f"rel err {worst:.2e} (tol {TOL_STEP_GRAD:g})")
    if loss_err > 1e-5 or worst > TOL_STEP_GRAD:
        raise AssertionError("card step disagrees with the CPU step")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from unipre3d_tpu_torch import kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    t0 = time.time()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    log(f"[device] {name} count={count} nvidia-smi: {smi}")

    t = time.time()
    kernels.load("splat_dense")
    log(f"[build] splat_dense: {time.time() - t:.1f} s")
    for line in kernels.build_log("splat_dense").splitlines():
        if any(k in line for k in ("registers", "spill", "smem",
                                   "Compiling entry")):
            log(f"[build]   {line.strip()}")
    timing = phase_kernels(device)
    launches = phase_train(smi)
    phase_parity()

    replaces = "unipre3d_tpu/ops/rasterizer/pallas_splat_dense.py"
    rows = []
    for key, fn, kern, line in (("fwd", "dense_fwd", "_dense_fwd_kernel", 193),
                                ("bwd", "dense_bwd", "_dense_bwd_kernel", 220)):
        t = timing[key]
        rows.append({
            "name": f"splat_dense.{fn}", "route": "cuda",
            "source": "unipre3d_tpu_torch/csrc/splat_dense.cu",
            "replaces": f"{replaces}:{line} ({kern})",
            "launches": launches[fn],
            "max_abs_err": timing[f"{key}_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None})
    log(f"[done] {time.time() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
