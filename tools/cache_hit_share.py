#!/usr/bin/env python3
"""The VAE feature cache's hit rate on the traffic of a real split, worked
out from the split's size alone (no data, no card).

    python3 tools/cache_hit_share.py [--epochs 3] [--entries 512]
                                     [--out FILE]

A cached entry is a conditioning image; it hits only when the same image
comes back while it is still among the cache's ``--entries`` most recently
used. This script feeds the cache the keys a split of a given size gives
it, through the port's own ``Loader`` (its per-epoch order and each
example's draws from (seed, epoch, position)) and ``DeviceVAECache`` on
the CPU, with a stand-in for the VAE (one channel, 1x1). Each example's
conditioning images are 1x1 images that name (item, view), drawn by the
readers' own rules at the configs' batch sizes:

* object (``transformer_pretraining``, batch 32, 1 conditioning view):
  N objects of V renders, the conditioning view the first of
  ``np_rng.permutation(V)[:imgs_per_obj]`` (data/shapenet.py ``get``;
  the synthetic set draws its views by the same rule);
* scene (``sparseunet_pretraining``, batch 4, 8 conditioning views): S
  scenes of F frames, the conditioning frames those of
  ``ScanNetDataset._select_frames`` (data/scannet.py).

Prints, and writes to ``--out`` (default
``experiments_out/cache_hit_share.json``), the hit rate of each epoch for
each size.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import types

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (N objects, V renders, examples an epoch): the synthetic set (8 objects
# of 8 views read 16 times an epoch: data/synthetic.py), then splits of N
# objects at the reference reader's 24 renders an object, each object once
# an epoch
OBJECT_SPLITS = ((8, 8, 128), (64, 24, 64), (512, 24, 512),
                 (4096, 24, 4096), (32768, 24, 32768))
# (S scenes, F frames): a few scenes, then ScanNet v2's 1,201 train scenes
SCENE_SPLITS = ((4, 40), (64, 100), (1201, 100), (1201, 300))


class KeyDataset:
    """Examples that hold only their conditioning images, each a 1x1
    image naming (item, view)."""
    takes_draws = True

    def __init__(self, n_items, views_of, length=None):
        self.n_items = n_items
        self.views_of = views_of     # (item, draws) -> conditioning views
        self.length = n_items if length is None else length

    def __len__(self):
        return self.length

    def get(self, index, draws):
        views = self.views_of(index, draws)
        img = np.zeros((len(views), 3, 1, 1), np.float32)
        img[:, 0, 0, 0] = index % self.n_items
        img[:, 1, 0, 0] = views
        return {"gt_images": img}


def hit_rates(dataset, batch_size, n_in, entries, epochs, seed):
    import torch
    from unipre3d_tpu_torch.data.loader import Loader
    from unipre3d_tpu_torch.training.feature_cache import DeviceVAECache
    cache = DeviceVAECache(lambda x: torch.zeros(len(x), 1, 1, 1), entries,
                           1, 1, channels=1, dtype=torch.float32,
                           device="cpu")
    loader = Loader(dataset, batch_size, seed=seed, num_workers=1)
    rates = []
    for epoch in range(epochs):
        h0, m0 = cache.hits, cache.misses
        for batch in loader.epoch(epoch):
            cache.attach(batch, n_in)
        h, m = cache.hits - h0, cache.misses - m0
        rates.append(h / (h + m) if h + m else 0.0)
    return rates


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--entries", type=int, default=512)
    ap.add_argument("--out", default="experiments_out/cache_hit_share.json")
    args = ap.parse_args()

    from unipre3d_tpu_torch.data.scannet import ScanNetDataset
    from unipre3d_tpu_torch.training.config import load_config
    results = {"entries": args.entries, "object": [], "scene": []}

    cfg = load_config("transformer_pretraining")
    per_obj, n_in = int(cfg.opt.imgs_per_obj), int(cfg.data.input_images)
    for n, v, length in OBJECT_SPLITS:
        ds = KeyDataset(n, lambda i, d, v=v:
                        d.np_rng.permutation(v)[:per_obj][:n_in], length)
        rates = hit_rates(ds, int(cfg.opt.batch_size), n_in, args.entries,
                          args.epochs, int(cfg.general.random_seed))
        results["object"].append({"objects": n, "renders": v,
                                  "examples": length, "images": n * v,
                                  "hit_rate": rates})
        print(f"[hit-share] object: {n} objects x {v} renders "
              f"({n * v} images, {length} examples an epoch): hit rate by "
              f"epoch {rates}", flush=True)

    cfg = load_config("sparseunet_pretraining")
    n_in = int(cfg.data.input_images)
    reader = types.SimpleNamespace(
        input_images=n_in, split="train",
        use_ref_images=bool(cfg.data.get("use_neighbor_imgs", True)),
        supervised_max_distance=int(cfg.data.get("supervised_max_distance",
                                                 5)))
    for s, f in SCENE_SPLITS:
        ds = KeyDataset(s, lambda i, d, f=f: ScanNetDataset._select_frames(
            reader, f, d)[:n_in])
        rates = hit_rates(ds, int(cfg.opt.batch_size), n_in, args.entries,
                          args.epochs, int(cfg.general.random_seed))
        results["scene"].append({"scenes": s, "frames": f,
                                 "images": s * f, "hit_rate": rates})
        print(f"[hit-share] scene: {s} scenes x {f} frames ({s * f} "
              f"images): hit rate by epoch {rates}", flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(results, fh, indent=1)
    print(f"[hit-share] written {args.out}", flush=True)


if __name__ == "__main__":
    main()
