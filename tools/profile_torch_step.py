#!/usr/bin/env python3
"""Profile the PyTorch port's object-pretraining step on one CUDA card.

    python3 tools/profile_torch_step.py [--tf32]

Builds ``transformer_pretraining`` at full width (random weights from seed
42) on a random batch of the real shapes (1024 points, 1 + 4 views at
128²), runs two warm-up steps, then times three steps with the host
clock around synchronized steps and traces them with ``torch.profiler``.
Prints the card's name and power limit, the step times, the device time
of the step's named ranges (``step/forward``, ``predictor/frozen_vae``,
``step/render``, ``step/backward``, ``step/optimizer``), the device busy
share (sum of kernel time over wall time) and the top kernels by device
time.
TF32 is off unless ``--tf32`` (as in chip_smoke.py).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STEPS = 3
BATCH = 32


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tf32", action="store_true")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile
    from unipre3d_tpu_torch import resolve_device
    from unipre3d_tpu_torch.data import batch_to, random_batch
    from unipre3d_tpu_torch.training import trainer
    from unipre3d_tpu_torch.training.config import load_config

    dev = resolve_device()
    torch.backends.cuda.matmul.allow_tf32 = args.tf32
    torch.backends.cudnn.allow_tf32 = args.tf32
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[profile] {smi}; tf32={args.tf32} batch={BATCH}", flush=True)
    cfg = load_config("transformer_pretraining",
                      overrides=[f"opt.batch_size={BATCH}"])
    model, state = trainer.create_train_state(cfg, device=dev, seed=42)
    step = trainer.make_train_step(cfg, model)
    batch = batch_to(random_batch(cfg, BATCH, n_points=1024, n_views=5,
                                  seed=0), dev)
    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()

    times = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_all = time.perf_counter()
        for _ in range(STEPS):
            t = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        wall_ms = (time.perf_counter() - t_all) * 1e3
    print(f"[profile] step ms {[round(t, 2) for t in times]}", flush=True)

    events = prof.key_averages()
    dev_time = lambda e: getattr(e, "device_time_total",
                                 getattr(e, "cuda_time_total", 0.0))
    self_dev = lambda e: getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0.0))
    ranges = ("step/forward", "predictor/frozen_vae", "step/render",
              "step/backward", "step/optimizer")
    for name in ranges:
        e = [x for x in events if x.key == name]
        if e:
            print(f"[profile] range {name}: device "
                  f"{dev_time(e[0]) / 1e3 / STEPS:.2f} ms/step, host "
                  f"{e[0].cpu_time_total / 1e3 / STEPS:.2f} ms/step")
    # device-side events, less the named ranges' own annotations; kernels
    # that autograd's thread launches are not attributed to step/backward
    kernels = [e for e in events if e.device_type is not None
               and "cuda" in str(e.device_type).lower()
               and e.key not in ranges]
    busy_ms = sum(self_dev(e) for e in kernels) / 1e3
    print(f"[profile] device busy {busy_ms / STEPS:.2f} ms/step of "
          f"{wall_ms / STEPS:.2f} ms wall: busy share "
          f"{busy_ms / wall_ms:.3f}")
    top = sorted(kernels, key=self_dev, reverse=True)[:15]
    for e in top:
        print(f"[profile] kernel {self_dev(e) / 1e3 / STEPS:8.3f} "
              f"ms/step x{e.count // STEPS:4d}  {e.key[:90]}")


if __name__ == "__main__":
    main()
