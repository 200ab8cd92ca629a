#!/usr/bin/env python3
"""Step times of the port's default pretraining run and its attributions,
on one CUDA card.

    python3 tools/time_default_run.py [--object-steps 8] [--scene-steps 4]
                                      [--regime-steps 6] [--out FILE]

Runs ``unipre3d_tpu_torch.train_network.main`` on the synthetic data at
full width, one output directory each, for the object
(``transformer_pretraining``, batch 32) and the scene
(``sparseunet_pretraining`` on the binned route, batch 1) in four
settings: bfloat16 with the VAE feature cache (the default run), float32
with the cache, bfloat16 without it, float32 without it. Per step it
prints the cache's attach (the VAE on the batch's misses, synchronized),
the train step and their sum; then the cache's hit rate and counts, its
buffer and the peak device memory. Then the
frozen VAE alone, CUDA events over 5 calls after a warm-up, in bfloat16 and
float32, on the object step's 32 conditioning views at 128x128 and the
scene's 8 at 120x160.

Then the cache's two regimes beside the VAE run in every step, bfloat16,
one model each from the same seed, in turns, ``--regime-steps`` timed
steps after 2 warm-up steps: ``live`` (no cache), ``miss`` (the cache, and
every conditioning image new in every step: the object's fresh
``random_batch`` each step, the scene's one synthetic scene with its
conditioning images scaled by a step-dependent factor; the same batches as
``live``) and ``hit`` (the cache, one batch every step). The object at
batch 32, the scene on the binned route, its geometry built before each
step and not timed. This is the traffic of a real split, whose
conditioning images almost never repeat within the cache's 512 slots
(tools/cache_hit_share.py), beside the synthetic set's, which repeats.

TF32 is off, as in chip_smoke.py. Prints the card's name and power limit
first and writes every number to ``--out`` (default
``experiments_out/default_run.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SETTINGS = (("bf16+cache", "bfloat16", 512), ("f32+cache", "float32", 512),
            ("bf16", "bfloat16", 0), ("f32", "float32", 0))


def run(argv):
    import torch
    from unipre3d_tpu_torch import train_network
    torch.cuda.reset_peak_memory_stats()
    res = train_network.main(argv)
    torch.cuda.synchronize()
    n = len(res["step_ms"])
    cache = res.get("cache_ms") or [0.0] * n
    out = {"step_ms": res["step_ms"], "cache_ms": res.get("cache_ms"),
           "total_ms": [a + b for a, b in zip(res["step_ms"], cache)],
           "losses": res["losses"], "hit_rate": res.get("hit_rate"),
           "cache_counts": res.get("cache_counts"),
           "cache_gib": res.get("cache_gib"),
           "geometry_ms": res.get("geometry_ms") or None,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    return out


def vae_ms(cfg_name, overrides, n_views, h, w, dtype):
    import torch
    from unipre3d_tpu_torch.models.gaussian_predictor import build_predictor
    from unipre3d_tpu_torch.training.config import load_config
    cfg = load_config(cfg_name, overrides=overrides)
    model = build_predictor(cfg, dtype=dtype).cuda()
    img = torch.rand(n_views, 3, h, w, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(0))
    model.extract_vae_features(img)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        model.extract_vae_features(img)
    end.record()
    torch.cuda.synchronize()
    del model
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / 5


def regimes(level, steps):
    """Attach and step ms of the ``live``, ``miss`` and ``hit`` regimes
    (module docstring), in turns, and each regime's last loss."""
    import torch
    from unipre3d_tpu_torch.data import (SyntheticSceneDataset, batch_to,
                                         collate, random_batch)
    from unipre3d_tpu_torch.train_network import make_cache
    from unipre3d_tpu_torch.training import trainer
    from unipre3d_tpu_torch.training.config import load_config
    n = steps + 2
    if level == "object":
        cfg = load_config("transformer_pretraining",
                          overrides=["data.dataset_root=synthetic"])
        fresh = [random_batch(cfg, int(cfg.opt.batch_size), n_points=1024,
                              n_views=5, seed=1000 + i) for i in range(n)]
    else:
        cfg = load_config("sparseunet_pretraining", overrides=[
            "data.pts_dataset_root=synthetic", "opt.batch_size=1",
            "tpu.raster_impl_train=pallas_binned"])
        base = collate([SyntheticSceneDataset(cfg, num_scenes=1, seed=0,
                                              device="cuda")[0]])
        n_in = int(cfg.data.input_images)
        fresh = []
        for i in range(n):
            b = dict(base)
            b["gt_images"] = base["gt_images"].copy()
            b["gt_images"][:, :n_in] *= np.float32(1.0 - 1e-3 * i)
            fresh.append(b)
    n_in = int(cfg.data.input_images)
    runs = {}
    for mode in ("live", "miss", "hit"):
        model, state = trainer.create_train_state(cfg, device="cuda", seed=0,
                                                  dtype=torch.bfloat16)
        runs[mode] = {"model": model, "state": state,
                      "step": trainer.make_train_step(cfg, model),
                      "geometry": trainer.make_geometry_fn(cfg, model),
                      "cache": None if mode == "live" else
                      make_cache(cfg, model, "cuda"),
                      "attach_ms": [], "step_ms": [], "losses": []}
    for i in range(n):
        for mode, r in runs.items():
            host = fresh[0 if mode == "hit" else i]
            batch = batch_to(host, "cuda")
            if r["geometry"] is not None:
                batch["geometry"] = r["geometry"](batch)
            torch.cuda.synchronize()
            t = time.perf_counter()
            if r["cache"] is not None:
                batch["vae_features"] = r["cache"].attach(host, n_in)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            m = r["step"](r["state"], batch)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if i >= 2:
                r["attach_ms"].append((t1 - t) * 1e3)
                r["step_ms"].append((t2 - t1) * 1e3)
            r["losses"].append(m["loss"])
    out = {}
    for mode, r in runs.items():
        c = r["cache"]
        out[mode] = {"attach_ms": r["attach_ms"], "step_ms": r["step_ms"],
                     "total_ms": [a + b for a, b in zip(r["attach_ms"],
                                                        r["step_ms"])],
                     "losses": r["losses"],
                     "cache_counts": None if c is None else
                     {"hits": c.hits, "misses": c.misses}}
    del runs
    torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--object-steps", type=int, default=8)
    ap.add_argument("--scene-steps", type=int, default=4)
    ap.add_argument("--regime-steps", type=int, default=6)
    ap.add_argument("--out", default="experiments_out/default_run.json")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("time_default_run.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[default-run] {smi}", flush=True)
    results = {"device": smi, "object": {}, "scene": {}, "vae_ms": {}}
    with tempfile.TemporaryDirectory(prefix="default_run_") as tmp:
        for label, dtype, entries in SETTINGS:
            pin = [f"tpu.compute_dtype={dtype}",
                   f"tpu.vae_cache_entries={entries}",
                   "logging.val_log=100000", "logging.loop_log=100000",
                   "logging.loss_log=100000"]
            for level, argv in (
                    ("object", ["--config-name", "transformer_pretraining",
                                "data.dataset_root=synthetic",
                                f"opt.iterations={args.object_steps}"]),
                    ("scene", ["--config-name", "sparseunet_pretraining",
                               "data.pts_dataset_root=synthetic",
                               "opt.batch_size=1",
                               "tpu.raster_impl_train=pallas_binned",
                               f"opt.iterations={args.scene_steps}"])):
                r = run(argv + pin + ["--output-dir",
                                      os.path.join(tmp, f"{level}_{label}")])
                results[level][label] = r
                rnd = lambda xs: xs and [round(x, 3) for x in xs]  # noqa
                print(f"[default-run] {level} {label}: total ms "
                      f"{rnd(r['total_ms'])} (attach {rnd(r['cache_ms'])}, "
                      f"step {rnd(r['step_ms'])}); hit rate {r['hit_rate']} "
                      f"{r['cache_counts']}; buffer {r['cache_gib']} GiB; "
                      f"peak {r['peak_gib']:.2f} GiB; losses "
                      f"{[round(x, 6) for x in r['losses']]}", flush=True)
    for label, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        results["vae_ms"][label] = {
            "object_32x128x128": vae_ms("transformer_pretraining", [], 32,
                                        128, 128, dtype),
            "scene_8x120x160": vae_ms("sparseunet_pretraining", [], 8, 120,
                                      160, dtype)}
        print(f"[default-run] VAE {label}: {results['vae_ms'][label]} ms",
              flush=True)
    results["regimes"] = {}
    for level in ("object", "scene"):
        results["regimes"][level] = reg = regimes(level, args.regime_steps)
        for mode, r in reg.items():
            print(f"[default-run] regime {level} bf16 {mode}: total ms "
                  f"{r['total_ms']} (attach {r['attach_ms']}, step "
                  f"{r['step_ms']}); cache {r['cache_counts']}; losses "
                  f"{r['losses']}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"[default-run] written {args.out}", flush=True)


if __name__ == "__main__":
    main()
