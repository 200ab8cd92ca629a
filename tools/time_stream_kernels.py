#!/usr/bin/env python3
"""Time versions of the streaming splat kernels' source side by side on one
card.

    python3 tools/time_stream_kernels.py [SRC.cu ...] [--rounds 2]
        [--out FILE]

Each source (default: unipre3d_tpu_torch/csrc/splat_stream.cu) exports the
C entry points ``stream_splat_fwd`` / ``stream_splat_bwd`` of that file (the
parent commit's version of it, or a copy edited to take one piece out, to
attribute time to it; headers are found in the package's ``csrc/``). At
chip_smoke.py's two timed shapes, the scene load (a scene's 16 test views
in one launch, 84,096 valid random gaussians at 120x160, 8x32 tiles,
``stream_case`` seed 200) and the object orbit shape (80 frames in one
launch, 128 gaussians at 128x128, 32x32 tiles, seed 201), and at the
shapes earlier runs timed (8 views of the scene load, 1 orbit frame), each source's forward launch and backward launch (with the
zeroing of its output) are timed with CUDA events over 20 (50 at one orbit
frame) launches after a warm-up, in turns with the other sources
(tools/variant_timing.py), ``--rounds`` times. Each source's forward is
held to the plain version (bit mismatches of T and of the images) and its
backward to the plain gradients (largest relative error over the nine
rows); the plain versions take minutes at the scene loads, and
``--against-first`` holds every source to the first one instead (itself
held to the plain versions by chip_smoke.py). Prints one
JSON line per (source, shape) (times of every round, their median, ptxas'
report) with the card's name and power limit; ``--out`` also writes them
to a file.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import variant_timing as vt

sys.path.insert(0, vt.ROOT)

SHAPES = (("scene", (16, 84096, 120, 160, 200, 0.0), 20),
          ("orbit", (80, 128, 128, 128, 201, 0.1), 20),
          ("scene R=8", (8, 84096, 120, 160, 200, 0.0), 20),
          ("orbit R=1", (1, 128, 128, 128, 201, 0.1), 50))


def runners(fwd, bwd, c, ref):
    """One source's forward launch and backward launch (zeroing dgrad
    first) as closures over their own outputs -> (fwd, bwd, out, logt,
    dgrad). The backward reads the reference's log T and tot."""
    import torch
    table, flags, bg, g_out = c["table"], c["flags"], c["bg"], c["g_out"]
    R, _, n_pad = table.shape
    ints = (R, n_pad, c["H"], c["W"], c["th"], c["tw"])
    out = torch.empty(R, 3, c["H"], c["W"], device=table.device)
    logt = torch.empty(R, c["H"], c["W"], device=table.device)
    dgrad = torch.zeros_like(table)

    def run_fwd():
        err = fwd(table.data_ptr(), flags.data_ptr(), bg.data_ptr(),
                  out.data_ptr(), logt.data_ptr(), *ints, vt.stream_arg())
        assert err == 0, err

    def run_bwd():
        dgrad.zero_()
        err = bwd(table.data_ptr(), flags.data_ptr(), bg.data_ptr(),
                  ref["logt"].data_ptr(), ref["tot"].data_ptr(),
                  g_out.data_ptr(), dgrad.data_ptr(), *ints, vt.stream_arg())
        assert err == 0, err

    return run_fwd, run_bwd, out, logt, dgrad


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="*", default=[os.path.join(
        vt.ROOT, "unipre3d_tpu_torch", "csrc", "splat_stream.cu")])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out")
    ap.add_argument("--against-first", action="store_true")
    args = ap.parse_args(argv)

    import torch
    import chip_smoke
    from unipre3d_tpu_torch.ops.rasterizer import splat_stream as ss
    if not torch.cuda.is_available():
        print("time_stream_kernels: no CUDA device available",
              file=sys.stderr)
        return 2
    smi = chip_smoke.nvidia_smi_line()
    with tempfile.TemporaryDirectory(prefix="stream_variants_") as tmp:
        built = vt.build_all(args.sources, tmp, [
            ("stream_splat_fwd", 5, 6), ("stream_splat_bwd", 7, 6)])
        lines = []
        for label, (R, N, H, W, seed, invalid), iters in SHAPES:
            c = chip_smoke.stream_case(R, N, H, W, seed, torch.device("cuda"),
                                       invalid)
            table, flags, bg, g_out = (c[k] for k in ("table", "flags", "bg",
                                                      "g_out"))
            shape = (H, W, c["th"], c["tw"])
            if args.against_first:
                (fwd, bwd), _ = built[0]
                ref = {}
                run_fwd, _, out_r, logt_r, _ = runners(fwd, bwd, c, ref)
                run_fwd()
            else:
                out_r, logt_r = ss.stream_fwd_ref(table, flags, bg, *shape)
            tot = (g_out * (out_r - bg.reshape(1, 3, 1, 1)
                            * torch.exp(logt_r)[:, None])).sum(1)
            ref = {"logt": logt_r, "tot": tot}
            if args.against_first:
                _, run_bwd, _, _, dgrad_r = runners(fwd, bwd, c, ref)
                run_bwd()
            else:
                dgrad_r = ss.stream_bwd_ref(table, flags, bg, logt_r, tot,
                                            g_out, *shape)
            rows = []
            for src, ((fwd, bwd), ptxas) in zip(args.sources, built):
                run_fwd, run_bwd, out, logt, dgrad = runners(fwd, bwd, c, ref)
                run_fwd()
                run_bwd()
                torch.cuda.synchronize()
                rel = max(float((dgrad[:, k] - dgrad_r[:, k]).abs().max()
                                / (dgrad_r[:, k].abs().max() + 1e-12))
                          for k in range(9))
                rows.append(dict(
                    source=vt.source_name(src), shape=label, ptxas=ptxas,
                    fwd=run_fwd, bwd=run_bwd,
                    t_mismatch=int((logt != logt_r).sum()),
                    img_mismatch=int((out != out_r).sum()),
                    bwd_rel_err=rel))
            vt.time_rounds(rows, args.rounds, iters)
            lines += rows
            del c, out_r, logt_r, dgrad_r, tot, ref
            torch.cuda.empty_cache()
    vt.report(lines, args.out, card=smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
