#!/usr/bin/env python3
"""The scene renderers side by side on one CUDA card, forward + backward.

    python3 tools/tiled_render_breakdown.py

At the scene training step's render shape (8 views of 84,096 gaussian slots
at 120x160) and two loads, random projected gaussians from a seed
(chip_smoke.random_gaussians): ``synthetic``, ~6,150 valid as the synthetic
scenes give, and ``scannet``, all 84,096 valid. For each load it times a
forward + backward (a random cotangent) of the tiled renderer
(render.py:rasterize_projected, 8x32 tiles, capacity 1024), the streaming
splat (8x32 tiles) and the binned splat (8x32 tiles, 4,096 duplicates a
tile), each over five calls, the first apart. Before that it traces the
tiled renderer's first call in the process and its second with
``torch.profiler`` (all valid) and prints the operators that take the most
host and device time. Prints the card's name and power limit first. TF32
is off.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

H, W, R, N, CAP = 120, 160, 8, 84096, 1024


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import random_gaussians
    from unipre3d_tpu_torch.ops.rasterizer.preprocess import \
        ProjectedGaussians
    from unipre3d_tpu_torch.ops.rasterizer.render import (auto_tile,
                                                          binned_tile,
                                                          rasterize_projected)
    from unipre3d_tpu_torch.ops.rasterizer.splat_binned import \
        rasterize_projected_binned
    from unipre3d_tpu_torch.ops.rasterizer.splat_stream import \
        rasterize_projected_stream

    if not torch.cuda.is_available():
        print("tiled_render_breakdown: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[device] {smi}", flush=True)
    th, tw = auto_tile(H, W)
    bh, bw = binned_tile(H, W)
    renderers = {
        "tiled": lambda pg, bg: rasterize_projected(pg, bg, H, W, th, tw,
                                                    capacity=CAP),
        "stream": lambda pg, bg: rasterize_projected_stream(pg, bg, H, W,
                                                            th, tw),
        "binned": lambda pg, bg: rasterize_projected_binned(
            *pg, bg, H, W, bh, bw, max_per_tile=4 * CAP),
    }

    def step(name, pg, cot):
        ins = [t.detach().requires_grad_(k < 4) for k, t in enumerate(pg)]
        img = renderers[name](ProjectedGaussians(*ins), [0.0, 0.0, 0.0])
        (img * cot).sum().backward()

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    def gaussians(invalid, seed=7):
        g = torch.Generator().manual_seed(seed)
        pg = [t.cuda() for t in random_gaussians(R, N, H, W, g, invalid)]
        return pg, torch.randn(R, 3, H, W, generator=g).cuda()

    # where the tiled renderer's first call in the process goes, and a
    # later one's
    pg, cot = gaussians(0.0, seed=8)
    for label in ("first call", "second call"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ms = timed(lambda: step("tiled", pg, cot))
        print(f"[profile] tiled, {label}: {ms:.1f} ms", flush=True)
        events = prof.key_averages()
        for key, of in (("host", lambda e: e.self_cpu_time_total),
                        ("device", lambda e: getattr(
                            e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0)))):
            for e in sorted(events, key=of, reverse=True)[:8]:
                print(f"[profile]   by {key}: {e.key[:60]:60s} x{e.count} "
                      f"{of(e) / 1e3:.2f} ms", flush=True)
    for load, invalid in (("synthetic", 1 - 6150 / N), ("scannet", 0.0)):
        pg, cot = gaussians(invalid)
        n_valid = int(pg[6].sum())
        for name in renderers:
            ms = [timed(lambda: step(name, pg, cot)) for _ in range(5)]
            print(f"[{load}] {name}: {n_valid} valid of {R * N} slots, "
                  f"fwd+bwd ms first {ms[0]:.1f}, then "
                  f"{', '.join(f'{m:.2f}' for m in ms[1:])}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
