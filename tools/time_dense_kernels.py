#!/usr/bin/env python3
"""Time versions of the dense splat kernels' source side by side on one card.

    python3 tools/time_dense_kernels.py [SRC.cu ...] [--rounds 2]
        [--out FILE]

Each source (default: unipre3d_tpu_torch/csrc/splat_dense.cu) exports the C
entry points ``dense_splat_fwd`` / ``dense_splat_bwd`` of that file (the
parent commit's version of it, or a copy edited to take one piece out, to
attribute time to it). At chip_smoke.py's main shape (R = 128 renders of
N = 128 random gaussians at 128x128, ``make_case`` seed 0) each source's
forward launch and backward launch (with the zeroing of its output) are
timed with CUDA events over 50 launches after a warm-up, in turns with the
other sources (tools/variant_timing.py), ``--rounds`` times. Each source's
forward is held to the plain version (bit mismatches of T and of the
images) and its backward to the plain gradients (largest relative error
over the nine rows). Also times the package's
wrappers ``dense_fwd`` / ``dense_bwd`` (allocation, checks and the
background's cotangent around its own build) and that cotangent's
reduction alone in three forms. Prints one JSON line for the wrappers and
one per source (times of every round, their median) with the card's name
and power limit; ``--out`` also writes them to a file.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import variant_timing as vt

ITERS = 50
sys.path.insert(0, vt.ROOT)


def runners(fwd, bwd, data, bg, out_r, g_out, ints):
    """One source's forward launch and backward launch (zeroing dgrad
    first) as closures over their own outputs -> (fwd, bwd, out, tfin,
    dgrad). The backward reads the plain version's images."""
    import torch
    R, _, _, H, W = ints
    out = torch.empty(R, 3, H * W, device=data.device)
    tfin = torch.empty(R, 1, H * W, device=data.device)
    dgrad = torch.zeros_like(data)

    def run_fwd():
        err = fwd(data.data_ptr(), bg.data_ptr(), out.data_ptr(),
                  tfin.data_ptr(), *ints, vt.stream_arg())
        assert err == 0, err

    def run_bwd():
        dgrad.zero_()
        err = bwd(data.data_ptr(), out_r.data_ptr(), g_out.data_ptr(),
                  dgrad.data_ptr(), *ints, vt.stream_arg())
        assert err == 0, err

    return run_fwd, run_bwd, out, tfin, dgrad


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="*", default=[os.path.join(
        vt.ROOT, "unipre3d_tpu_torch", "csrc", "splat_dense.cu")])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch
    import chip_smoke
    from unipre3d_tpu_torch.ops.rasterizer import splat_dense as sd
    if not torch.cuda.is_available():
        print("time_dense_kernels: no CUDA device available", file=sys.stderr)
        return 2
    smi = chip_smoke.nvidia_smi_line()
    R, N, H, W = 128, 128, 128, 128
    dev = torch.device("cuda")
    data, bg, g_out = chip_smoke.make_case(R, N, H, W, seed=0, device=dev)
    n_pad = data.shape[-1]
    chunk = sd.chunk_of(n_pad)
    out_r, tfin_r = sd.dense_splat_fwd_ref(data, bg, H, W)
    dgrad_r, _ = sd.dense_splat_bwd_ref(data, bg, tfin_r, g_out, H, W)

    with tempfile.TemporaryDirectory(prefix="dense_variants_") as tmp:
        built = vt.build_all(args.sources, tmp, [
            ("dense_splat_fwd", 4, 5), ("dense_splat_bwd", 4, 5)])
        rows = []
        for src, ((fwd, bwd), ptxas) in zip(args.sources, built):
            run_fwd, run_bwd, out, tfin, dgrad = runners(
                fwd, bwd, data, bg, out_r, g_out, (R, n_pad, chunk, H, W))
            run_fwd()
            run_bwd()
            torch.cuda.synchronize()
            rel = max(float((dgrad[:, k] - dgrad_r[:, k]).abs().max()
                            / (dgrad_r[:, k].abs().max() + 1e-12))
                      for k in range(9))
            rows.append(dict(
                source=vt.source_name(src), ptxas=ptxas, fwd=run_fwd,
                bwd=run_bwd, t_mismatch=int((tfin != tfin_r).sum()),
                img_mismatch=int((out != out_r).sum()), bwd_rel_err=rel))
        vt.time_rounds(rows, args.rounds, ITERS)
        # the package's wrappers (allocation, checks, the dbg reduction)
        # around its own build, and the dbg reduction alone in three forms
        out_w, tfin_w = sd.dense_fwd(data, bg, H, W)
        tf = tfin_w[:, 0, :]
        wrapper = dict(
            source="wrapper", card=smi,
            fwd_ms=chip_smoke.cuda_ms(lambda: sd.dense_fwd(data, bg, H, W),
                                      ITERS),
            bwd_ms=chip_smoke.cuda_ms(lambda: sd.dense_bwd(
                data, bg, out_w, tfin_w, g_out, H, W), ITERS),
            dbg_einsum_ms=chip_smoke.cuda_ms(
                lambda: torch.einsum("rp,rcp->c", tf, g_out), ITERS),
            dbg_bmm_ms=chip_smoke.cuda_ms(
                lambda: torch.bmm(g_out, tf[:, :, None]).sum((0, 2)),
                ITERS),
            dbg_mul_sum_ms=chip_smoke.cuda_ms(
                lambda: (g_out * tfin_w).sum((0, 2)), ITERS))
    vt.report(rows, args.out, head=[wrapper],
              shape=dict(R=R, N=N, H=H, W=W), card=smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
