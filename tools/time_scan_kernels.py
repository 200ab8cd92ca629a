#!/usr/bin/env python3
"""Time versions of the selective-scan kernels' source side by side on one
card.

    python3 tools/time_scan_kernels.py [SRC.cu ...] [--rounds 3]
        [--batch B] [--out FILE]

Each source (default: unipre3d_tpu_torch/csrc/selective_scan.cu) is either
the first design (a thread a state lane; it exports no
``selective_scan_version``), timed as its wrapper ran it: float32
contiguous operands, the backward launch followed by the five sums of its
partials; or a source exporting ``selective_scan_version`` 2 (a thread a
channel; the backward's entry point launches the walk and the fixed-order
sum of its partials), timed twice: on float32 contiguous operands and on
the mixer's dtypes and strides (``chip_smoke.mixer_layout``: bf16 delta,
B, C, z, with B, C and z views of wider tensors), the forward keeping the
states the backward reads. At the three main-path shapes (Mamba3D, PCM
stage 0, PCM stage 3; ``chip_smoke.scan_case``), each version's forward and
backward are timed with CUDA events over 20 launches after a warm-up, in
turns with the others (tools/variant_timing.py), ``--rounds`` times, and
held to the plain version (``selective_scan_ref`` and autograd on float32
copies of the same values; ``chip_smoke.grad_err``). Prints one JSON line
per (source, operands, shape) with the times of every round, their
median, the bound (``chip_smoke.scan_bound``), the errors and ptxas'
report, with the card's name and power limit; ``--out`` also writes them
to a file. ``--batch`` replaces the batch of 32 (a small batch leaves most
SMs idle and shows how long one CTA's walk takes alone).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys
import tempfile

import variant_timing as vt

sys.path.insert(0, vt.ROOT)

SHAPES = (("Mamba3D", 32, 129, 768), ("PCM stage 0", 32, 524, 768),
          ("PCM stage 3", 32, 76, 1536))
ITERS = 20


def bind(lib, name, n_ptr, n_int):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def v1_runners(lib, ins, g):
    """The first design: float32 contiguous operands; the backward with the
    partial sums its wrapper took -> (fwd, bwd, outputs)."""
    import torch
    fwd = bind(lib, "selective_scan_fwd", 9, 4)
    bwd = bind(lib, "selective_scan_bwd", 18, 4)
    u, delta, A, Bm, Cm, Dv, z, bias = [t.float().contiguous() for t in ins]
    Bsz, L, D = u.shape
    N, seg, dblk = 16, 16, 16
    f32 = dict(dtype=torch.float32, device=u.device)
    y = torch.empty_like(u)
    du, ddelta, dz = (torch.empty_like(u) for _ in range(3))
    dB_part = torch.empty(Bsz, L, D // dblk, N, **f32)
    dC_part = torch.empty(Bsz, L, D // dblk, N, **f32)
    dA_part = torch.empty(Bsz, D, N, **f32)
    dD_part, dbias_part = torch.empty(Bsz, D, **f32), torch.empty(Bsz, D, **f32)
    chk = torch.empty(Bsz, -(-L // seg), D, N, **f32)
    p = lambda t: t.data_ptr()  # noqa: E731
    out = {}

    def run_fwd():
        assert fwd(p(u), p(delta), p(A), p(Bm), p(Cm), p(Dv), p(z), p(bias),
                   p(y), Bsz, L, D, 1, vt.stream_arg()) == 0

    def run_bwd():
        assert bwd(p(u), p(delta), p(A), p(Bm), p(Cm), p(Dv), p(z), p(bias),
                   p(g), p(du), p(ddelta), p(dz), p(dA_part), p(dB_part),
                   p(dC_part), p(dD_part), p(dbias_part), p(chk), Bsz, L, D,
                   1, vt.stream_arg()) == 0
        out["grads"] = (du, ddelta, dA_part.sum(0), dB_part.sum(2),
                        dC_part.sum(2), dD_part.sum(0), dz, dbias_part.sum(0))

    out["y"] = y
    return run_fwd, run_bwd, out


def new_runners(lib, ins, g):
    """A version-2 source on operands as they are: the forward keeping the
    states; the backward (its two launches) -> (fwd, bwd, outputs)."""
    import torch
    from unipre3d_tpu_torch.ops import scan as sc
    fwd = bind(lib, "selective_scan_fwd", 11, 5)
    bwd = bind(lib, "selective_scan_bwd", 20, 5)
    u, delta, A, Bm, Cm, Dv, z, bias = ins
    Bsz, L, D = u.shape
    N = sc.SCAN_N
    nblk = -(-D // sc.SCAN_CHANNELS)
    f32 = dict(dtype=torch.float32, device=u.device)
    y = torch.empty(Bsz, L, D, **f32)
    chk = torch.empty(Bsz, -(-L // sc.SCAN_SEG), D, N, **f32)
    like = lambda t, *s: torch.empty(s or t.shape, dtype=t.dtype,  # noqa
                                     device=u.device)
    du, ddelta, dz = like(u), like(delta), like(z)
    dB, dC = like(Bm, Bsz, L, N), like(Cm, Bsz, L, N)
    dA, dD, dbias = (torch.empty(D, N, **f32), torch.empty(D, **f32),
                     torch.empty(D, **f32))
    work = torch.empty(Bsz * L * nblk * 2 * N + Bsz * D * N + 2 * Bsz * D,
                       **f32)
    st_f, bf_f = sc._layout(u, delta, z, Bm, Cm)
    st_b, bf_b = sc._layout(u, delta, z, Bm, Cm, g)
    p = lambda t: t.data_ptr()  # noqa: E731

    def run_fwd():
        assert fwd(p(u), p(delta), p(A), p(Bm), p(Cm), p(Dv), p(z), p(bias),
                   p(y), p(chk), ctypes.addressof(st_f), Bsz, L, D, 1, bf_f,
                   vt.stream_arg()) == 0

    def run_bwd():
        assert bwd(p(u), p(delta), p(A), p(Bm), p(Cm), p(Dv), p(z), p(bias),
                   p(g), p(chk), p(du), p(ddelta), p(dz), p(dA), p(dB),
                   p(dC), p(dD), p(dbias), p(work), ctypes.addressof(st_b),
                   Bsz, L, D, 1, bf_b, vt.stream_arg()) == 0

    return run_fwd, run_bwd, {"y": y, "grads": (du, ddelta, dA, dB, dC, dD,
                                                dz, dbias)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="*", default=[os.path.join(
        vt.ROOT, "unipre3d_tpu_torch", "csrc", "selective_scan.cu")])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch
    import chip_smoke
    from unipre3d_tpu_torch.ops import scan as sc
    if not torch.cuda.is_available():
        print("time_scan_kernels: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = chip_smoke.nvidia_smi_line()
    with tempfile.TemporaryDirectory(prefix="scan_variants_") as tmp:
        built = vt.build_all(args.sources, tmp, [])
        libs = [ctypes.CDLL(os.path.join(tmp, f"v{i}.so"))
                for i in range(len(args.sources))]
        versions = [lib.selective_scan_version()
                    if hasattr(lib, "selective_scan_version") else 1
                    for lib in libs]
        lines = []
        for si, (label, _, L, D) in enumerate(SHAPES):
            Bsz = args.batch
            base = chip_smoke.scan_case(Bsz, L, D, si, dev)
            g = torch.randn(Bsz, L, D, device=dev,
                            generator=torch.Generator(dev).manual_seed(si))
            cases = {"float32": base, "mixer": chip_smoke.mixer_layout(base, D // 2)}
            refs = {}
            for kind, ins in cases.items():
                leaves = [t.float().clone().requires_grad_(True) for t in ins]
                y_r = sc.selective_scan_ref(*leaves, delta_softplus=True)
                refs[kind] = (y_r.detach(),
                              torch.autograd.grad(y_r, leaves, g))
            rows = []
            for src, lib, ver, (_, ptxas) in zip(args.sources, libs,
                                                  versions, built):
                for kind in ("float32",) if ver == 1 else ("float32",
                                                           "mixer"):
                    ins = cases[kind]
                    run_fwd, run_bwd, out = (v1_runners if ver == 1
                                             else new_runners)(lib, ins, g)
                    run_fwd()
                    run_bwd()
                    torch.cuda.synchronize()
                    y_r, grads_r = refs[kind]
                    (bf, byf), (bb, byb) = chip_smoke.scan_bound(
                        Bsz, L, D, x_bytes=2 if kind == "mixer" else 4)
                    rows.append(dict(
                        source=vt.source_name(src), version=ver,
                        operands=kind, shape=label, B=Bsz, L=L, D=D,
                        ptxas=ptxas, fwd=run_fwd, bwd=run_bwd,
                        fwd_rel_err=float((out["y"] - y_r).abs().max()
                                          / y_r.abs().max()),
                        bwd_rel_err=max(chip_smoke.grad_err(a, b) for a, b
                                        in zip(out["grads"], grads_r)),
                        fwd_bound_ms=bf, fwd_bound_by=byf, bwd_bound_ms=bb,
                        bwd_bound_by=byb))
            vt.time_rounds(rows, args.rounds, ITERS)
            lines += rows
            del base, cases, refs, rows
            torch.cuda.empty_cache()
    vt.report(lines, args.out, card=smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
