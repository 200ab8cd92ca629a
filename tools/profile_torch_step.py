#!/usr/bin/env python3
"""Profile one of the PyTorch port's pretraining steps on one CUDA card.

    python3 tools/profile_torch_step.py [--tf32] [--scene]
                                        [--dtype bfloat16] [--cache]
                                        [--backbone pointmlp|mamba3d|pcm]
    python3 tools/profile_torch_step.py --scene [--backbone ptv3] [...]

Without ``--scene``: ``<backbone>_pretraining`` (``transformer`` by
default) at full width (random weights from seed 42) on a random batch of
the real shapes (batch 32, 1024 points, 1 + 4 views at 128²). With
``--scene``: ``sparseunet_pretraining`` at full width on the binned splat
route (batch 1, 80,000 point slots, 8 + 8 views at 160x120) on one
synthetic scene, its SparseUNet geometry built before each step and timed
apart; with ``--scene --backbone ptv3`` the same for ``ptv3_pretraining``
(its PTv3 geometry, with each stage's valid rows). Runs two warm-up steps,
then times three steps with the host clock around synchronized steps and
traces them with ``torch.profiler``. Prints the card's name and power
limit, the step times, the device time of the step's named ranges
(``step/forward``, ``predictor/frozen_vae``, ``predictor/sparseunet`` or
``predictor/ptv3``, ``point_ops/fps``, ``step/render``,
``step/backward``, ``step/optimizer``), the device busy share (sum of
kernel time over wall time), the top kernels by device time and the
port's hand-written kernels wherever they rank.
TF32 is off unless ``--tf32`` (as in chip_smoke.py). The model computes in
``--dtype`` (default float32); with ``--cache`` each step takes the
conditioning views' VAE features from the feature cache
(training/feature_cache.py), filled before the warm-up steps so that every
timed step hits, and the profile covers each step's attach. The default
run is ``--dtype bfloat16 --cache``.
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
    ap.add_argument("--scene", action="store_true")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--cache", action="store_true")
    ap.add_argument("--backbone", default=None,
                    help="object: transformer (default), pointmlp, mamba3d, "
                         "pcm; scene: sparseunet (default), ptv3")
    args = ap.parse_args()
    scene_backbones, object_backbones = ("sparseunet", "ptv3"), (
        "transformer", "pointmlp", "mamba3d", "pcm")
    backbone = args.backbone or ("sparseunet" if args.scene
                                 else "transformer")
    if backbone not in (scene_backbones if args.scene else object_backbones):
        ap.error(f"--backbone {backbone} with scene={args.scene}")

    import torch
    from torch.profiler import ProfilerActivity, profile
    from unipre3d_tpu_torch import resolve_device
    from unipre3d_tpu_torch.data import (SyntheticSceneDataset, batch_to,
                                         collate, random_batch)
    from unipre3d_tpu_torch.train_network import make_cache
    from unipre3d_tpu_torch.training import trainer
    from unipre3d_tpu_torch.training.config import load_config

    dev = resolve_device()
    torch.backends.cuda.matmul.allow_tf32 = args.tf32
    torch.backends.cudnn.allow_tf32 = args.tf32
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    if args.scene:
        cfg = load_config(f"{backbone}_pretraining", overrides=[
            "opt.batch_size=1", "data.pts_dataset_root=synthetic",
            "tpu.raster_impl_train=pallas_binned"])
        host = collate([SyntheticSceneDataset(cfg, num_scenes=1, seed=0,
                                              device=dev)[0]])
    else:
        cfg = load_config(f"{backbone}_pretraining",
                          overrides=[f"opt.batch_size={BATCH}"])
        host = random_batch(cfg, BATCH, n_points=1024, n_views=5, seed=0)
    batch = batch_to(host, dev)
    print(f"[profile] {smi}; {cfg.model.backbone_type} tf32={args.tf32} "
          f"batch={cfg.opt.batch_size} compute={args.dtype} "
          f"cache={args.cache}", flush=True)
    model, state = trainer.create_train_state(
        cfg, device=dev, seed=42, dtype=getattr(torch, args.dtype))
    train_step = trainer.make_train_step(cfg, model)
    cache = make_cache(cfg, model, dev) if args.cache else None
    n_in = int(cfg.data.input_images)

    def step(state, batch):
        if cache is not None:
            batch["vae_features"] = cache.attach(host, n_in)
        return train_step(state, batch)

    geometry_fn = trainer.make_geometry_fn(cfg, model)
    geo_ms = []
    if geometry_fn is not None:
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            batch["geometry"] = geometry_fn(batch)
            torch.cuda.synchronize()
            geo_ms.append((time.perf_counter() - t) * 1e3)
        print(f"[profile] geometry build ms {[round(t, 2) for t in geo_ms]}",
              flush=True)
        geo = batch["geometry"]
        if hasattr(geo, "pool_dropped"):
            masks = [geo.fine_mask] + [c.mask for c in geo.clusters]
            print(f"[profile] PTv3 stage rows "
                  f"{[int(m.sum()) for m in masks]} (capacities "
                  f"{[m.shape[1] for m in masks]}), parents dropped past "
                  f"capacity {geo.pool_dropped.sum(0).tolist()}", flush=True)
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
    ranges = ("step/forward", "predictor/frozen_vae", "predictor/sparseunet",
              "predictor/ptv3", "point_ops/fps", "step/render",
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
    ranked = sorted(kernels, key=self_dev, reverse=True)
    # the top 15, and the port's own kernels wherever they rank
    for e in ranked[:15] + [e for e in ranked[15:] if e.key.startswith(
            "(anonymous namespace)::")]:
        print(f"[profile] kernel {self_dev(e) / 1e3 / STEPS:8.3f} "
              f"ms/step x{e.count // STEPS:4d}  {e.key[:90]}")


if __name__ == "__main__":
    main()
