#!/usr/bin/env python3
"""Time the host FPS cap of the PTv3 ScanNet pipeline on the host's CPU.

    python3 tools/time_host_fps.py [--n 150000] [--m 80000] [--busy K]
                                   [--jax]

Caps a seeded uniform cloud of ``--n`` points at ``--m`` with the port's
C++ FPS (``unipre3d_tpu_torch/native``, one thread), after a first call
that builds and loads it, and prints the host clock of two calls. With
``--jax`` it also times the JAX package's OpenMP version
(``unipre3d_tpu.native.host_fps``) in turns with the port's, and checks
that both pick the same points. With ``--busy K`` K processes spin on
the CPU while it times (a host whose cores are shared, as under the input
pipeline's reader threads or a test run). Host times only: no device is
involved.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def spin(stop):
    while not stop.is_set():
        pass


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=150000)
    ap.add_argument("--m", type=int, default=80000)
    ap.add_argument("--busy", type=int, default=0)
    ap.add_argument("--jax", action="store_true")
    args = ap.parse_args()

    from unipre3d_tpu_torch.native import host_fps
    fns = {"port (C++, one thread)": host_fps}
    if args.jax:
        from unipre3d_tpu.native import host_fps as jax_fps
        fns["JAX package (C++, OpenMP)"] = jax_fps
    xyz = np.random.default_rng(0).uniform(0, 2, (args.n, 3)).astype(
        np.float32)
    for f in fns.values():
        f(xyz, 16)                       # build and load
    stop = mp.Event()
    busy = [mp.Process(target=spin, args=(stop,)) for _ in range(args.busy)]
    for p in busy:
        p.start()
    try:
        picks = {}
        for _ in range(2):
            for name, f in fns.items():
                t = time.perf_counter()
                picks[name] = f(xyz, args.m)
                print(f"[host_fps] {name}: {args.n} -> {args.m} points in "
                      f"{time.perf_counter() - t:.2f} s ({os.cpu_count()} "
                      f"cores, {args.busy} busy processes)", flush=True)
    finally:
        stop.set()
        for p in busy:
            p.join()
    if len(picks) == 2:
        a, b = picks.values()
        print(f"[host_fps] same points: {bool(np.array_equal(a, b))}")


if __name__ == "__main__":
    main()
