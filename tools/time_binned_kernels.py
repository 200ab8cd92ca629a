#!/usr/bin/env python3
"""Time versions of the binned splat kernels' source side by side on one card.

    python3 tools/time_binned_kernels.py [SRC.cu ...] [--rounds 2]
        [--out FILE]

Each source (default: unipre3d_tpu_torch/csrc/splat_binned.cu) exports the
C entry points ``binned_splat_fwd`` / ``binned_splat_bwd`` of that file (the
parent commit's version of it, or a copy edited to take one piece out, to
attribute time to it; headers are found in the package's ``csrc/``). At
chip_smoke.py's scene shape (8 views of 84,096 valid random gaussians at
120x160, 8x32 tiles, cap 4096, ``binned_case`` seed 100) each source's
forward launch and backward launch (with the zeroing of its output) are
timed with CUDA events over 20 launches after a warm-up, in turns with the
other sources (tools/variant_timing.py), ``--rounds`` times. Each source's
forward is held to the plain version (bit mismatches of T and of the
images) and its backward to the plain gradients (largest relative error
over the nine rows). Prints one JSON line per source (times of every
round, their median, ptxas' report) with the card's name and power limit;
``--out`` also writes them to a file.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import variant_timing as vt

ITERS = 20
sys.path.insert(0, vt.ROOT)


def runners(fwd, bwd, c, ref, ints):
    """One source's forward launch and backward launch (zeroing dgrad
    first) as closures over their own outputs -> (fwd, bwd, out, logt,
    dgrad). The backward reads the plain version's log T and tot."""
    import torch
    M, R, H, W = ints[:4]
    seg, table, bg, g_out = c["dup"].seg, c["table"], c["bg"], c["g_out"]
    out = torch.empty(R, 3, H, W, device=table.device)
    logt = torch.empty(R, H, W, device=table.device)
    dgrad = torch.zeros_like(table)

    def run_fwd():
        err = fwd(seg.data_ptr(), table.data_ptr(), bg.data_ptr(),
                  out.data_ptr(), logt.data_ptr(), *ints, vt.stream_arg())
        assert err == 0, err

    def run_bwd():
        dgrad.zero_()
        err = bwd(seg.data_ptr(), table.data_ptr(), bg.data_ptr(),
                  ref["logt"].data_ptr(), ref["tot"].data_ptr(),
                  g_out.data_ptr(), dgrad.data_ptr(), *ints, vt.stream_arg())
        assert err == 0, err

    return run_fwd, run_bwd, out, logt, dgrad


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="*", default=[os.path.join(
        vt.ROOT, "unipre3d_tpu_torch", "csrc", "splat_binned.cu")])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch
    import chip_smoke
    from unipre3d_tpu_torch.ops.rasterizer import splat_binned as sb
    if not torch.cuda.is_available():
        print("time_binned_kernels: no CUDA device available", file=sys.stderr)
        return 2
    smi = chip_smoke.nvidia_smi_line()
    R, N, H, W = 8, 84096, 120, 160
    c = chip_smoke.binned_case(R, N, H, W, 100, torch.device("cuda"))
    seg, table, bg, g_out = c["dup"].seg, c["table"], c["bg"], c["g_out"]
    ints = (table.shape[1], R, H, W, c["th"], c["tw"], c["maxn"])
    out_r, logt_r = sb.binned_fwd_ref(seg, table, bg, *ints[1:])
    tot = (g_out * (out_r - bg.reshape(1, 3, 1, 1)
                    * torch.exp(logt_r)[:, None])).sum(1)
    dgrad_r = sb.binned_bwd_ref(seg, table, bg, logt_r, tot, g_out,
                                *ints[1:])
    ref = {"logt": logt_r, "tot": tot}

    with tempfile.TemporaryDirectory(prefix="binned_variants_") as tmp:
        built = vt.build_all(args.sources, tmp, [
            ("binned_splat_fwd", 5, 7), ("binned_splat_bwd", 7, 7)])
        rows = []
        for src, ((fwd, bwd), ptxas) in zip(args.sources, built):
            run_fwd, run_bwd, out, logt, dgrad = runners(fwd, bwd, c, ref,
                                                         ints)
            run_fwd()
            run_bwd()
            torch.cuda.synchronize()
            rel = max(float((dgrad[k] - dgrad_r[k]).abs().max()
                            / (dgrad_r[k].abs().max() + 1e-12))
                      for k in range(9))
            rows.append(dict(
                source=vt.source_name(src), ptxas=ptxas, fwd=run_fwd,
                bwd=run_bwd, t_mismatch=int((logt != logt_r).sum()),
                img_mismatch=int((out != out_r).sum()), bwd_rel_err=rel))
        vt.time_rounds(rows, args.rounds, ITERS)
    vt.report(rows, args.out, card=smi,
              shape=dict(R=R, N=N, H=H, W=W, tile=[c["th"], c["tw"]],
                         cap=c["maxn"], dups=c["dups"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
