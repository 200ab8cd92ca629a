"""Evaluation entry point of the PyTorch port.

    python -m unipre3d_tpu_torch.eval <experiment_path> [--split test] \
        [--save-vis N] [--ckpt model_latest.ckpt] [--device cpu]

Counterpart of the repository's ``eval.py``: reloads the run's composed
config from ``<experiment_path>/.hydra/config.yaml`` (written by
``unipre3d_tpu_torch.train_network``), rebuilds the model, loads the
checkpoint, and scores every example of the split with the eval step
(EMA parameters, every view rendered): PSNR and SSIM of the conditioning
views and of the novel views, all-black ground-truth views left out.
Writes one line per example to ``scores.txt`` and the means to
``test_scores.json``; ``--save-vis N`` saves render and GT PNGs of the first
N examples (PIL, imported there). With ``opt.lpips_weights`` set (converted
VGG weights; utils/lpips.py) it also scores LPIPS of both view sets,
in float32; without it the LPIPS keys stay ``None``, as the JAX eval gives
them. A set path that does not exist raises (the JAX eval skips it). One
process on one device (the CUDA card unless ``--device`` names another).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
import yaml

from unipre3d_tpu_torch import resolve_device
from unipre3d_tpu_torch.data import Loader, batch_to, get_dataset
from unipre3d_tpu_torch.train_network import existing_path
from unipre3d_tpu_torch.training import checkpoint as ckpt_lib
from unipre3d_tpu_torch.training.config import ConfigNode
from unipre3d_tpu_torch.training.trainer import (create_train_state,
                                                 make_eval_step)
from unipre3d_tpu_torch.training.video import to_uint8
from unipre3d_tpu_torch.utils import losses as loss_lib
from unipre3d_tpu_torch.utils.lpips import (build_lpips, load_lpips_params,
                                            lpips_fn)

SCORE_KEYS = ("PSNR_cond", "SSIM_cond", "LPIPS_cond", "PSNR_novel",
              "SSIM_novel", "LPIPS_novel")


class Metricator:
    """PSNR and SSIM (and LPIPS, given an ``lpips`` module) of every view
    of one example, and which ground-truth views are all black, in chunks
    of at most ``CHUNK`` views."""

    CHUNK = 100

    def __init__(self, lpips=None):
        self.lpips = lpips

    @torch.no_grad()
    def compute_metrics_batched(self, rendered, gt):
        """rendered/gt [V, 3, H, W] tensors -> dict of numpy [V]: psnr,
        ssim, black (and lpips)."""
        out = {"psnr": [], "ssim": [], "black": []}
        if self.lpips is not None:
            out["lpips"] = []
        for s in range(0, rendered.shape[0], self.CHUNK):
            r, g = rendered[s:s + self.CHUNK], gt[s:s + self.CHUNK]
            mse = ((r - g) ** 2).mean(dim=(1, 2, 3))
            out["psnr"].append(-10.0 * torch.log10(torch.clamp_min(mse,
                                                                   1e-12)))
            out["ssim"].append(loss_lib.ssim(r, g, size_average=False))
            out["black"].append((g == 0).all(dim=(1, 2, 3)))
            if self.lpips is not None:
                out["lpips"].append(lpips_fn(self.lpips, r * 2 - 1,
                                             g * 2 - 1))
        return {k: torch.cat(v).cpu().numpy() for k, v in out.items()}


def _mean(values):
    values = [x for x in values if x is not None]
    return float(np.mean(values)) if values else None


def evaluate_dataset(model, eval_step, state, loader, cfg, out_folder: str,
                     save_vis: int = 0, lpips=None):
    """Score every example of ``loader.epoch(0)`` (numpy batches of one
    example) -> the means over examples under SCORE_KEYS (None where no
    view counted, and LPIPS without an ``lpips`` module); writes
    ``scores.txt`` (example, its novel PSNR, SSIM, LPIPS) and with
    ``save_vis`` the PNGs of the first examples."""
    n_in = int(cfg.data.input_images)
    dev = next(model.parameters()).device
    metricator = Metricator(lpips)
    agg = {k: [] for k in SCORE_KEYS}
    scores_path = os.path.join(out_folder, "scores.txt")
    open(scores_path, "w").close()
    for d_idx, batch in enumerate(loader.epoch(0)):
        tb = batch_to(batch, dev)
        res = eval_step(state, tb)
        m = metricator.compute_metrics_batched(res["rendered"][0],
                                               tb["gt_images"][0])
        if d_idx < save_vis:
            from PIL import Image
            ex_dir = os.path.join(out_folder, f"vis_{d_idx:04d}")
            os.makedirs(ex_dir, exist_ok=True)
            for tag, imgs in (("render", res["rendered"][0].cpu().numpy()),
                              ("gt", batch["gt_images"][0])):
                for r, img in enumerate(to_uint8(imgs)):
                    Image.fromarray(img).save(
                        os.path.join(ex_dir, f"{r:05d}_{tag}.png"))
        per = {k: [] for k in SCORE_KEYS}
        for r in range(m["psnr"].shape[0]):
            if m["black"][r]:        # all-black ground truth: not scored
                continue
            side = "cond" if r < n_in else "novel"
            per[f"PSNR_{side}"].append(float(m["psnr"][r]))
            per[f"SSIM_{side}"].append(float(m["ssim"][r]))
            per[f"LPIPS_{side}"].append(
                float(m["lpips"][r]) if "lpips" in m else None)
        for k in SCORE_KEYS:
            v = _mean(per[k])
            if v is not None:
                agg[k].append(v)
        with open(scores_path, "a") as f:
            f.write(f"{d_idx}_example {_mean(per['PSNR_novel'])} "
                    f"{_mean(per['SSIM_novel'])} "
                    f"{_mean(per['LPIPS_novel'])}\n")
    return {k: _mean(v) for k, v in agg.items()}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("experiment_path")
    p.add_argument("--split", default="test")
    p.add_argument("--save-vis", type=int, default=0)
    p.add_argument("--ckpt", default="model_latest.ckpt")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; a missing card is an "
                        "error)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Evaluate a run's checkpoint; returns the scores (also written to
    ``<experiment_path>/test_scores.json``)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    with open(os.path.join(args.experiment_path, ".hydra",
                           "config.yaml")) as f:
        cfg = ConfigNode.from_obj(yaml.safe_load(f))
    lpips_path = existing_path(cfg, "lpips_weights")
    loader = Loader(get_dataset(cfg, args.split, device), 1, shuffle=False,
                    drop_last=False)
    model, state = create_train_state(cfg, device=device,
                                      seed=int(cfg.general.random_seed))
    ckpt = os.path.join(args.experiment_path, args.ckpt)
    state, _ = ckpt_lib.load_checkpoint(ckpt, model, state)
    print(f"[eval] loaded {ckpt} at step {state.step}", flush=True)
    lpips = None
    if lpips_path:
        lpips = build_lpips(load_lpips_params(lpips_path), device)
        print(f"[eval] LPIPS weights loaded from {lpips_path}", flush=True)
    scores = evaluate_dataset(model, make_eval_step(cfg, model), state,
                              loader, cfg, args.experiment_path,
                              args.save_vis, lpips)
    print(json.dumps(scores, indent=2))
    out = os.path.join(args.experiment_path, "test_scores.json")
    with open(out, "w") as f:
        json.dump(scores, f, indent=2)
    print(f"[eval] wrote {out}", flush=True)
    return scores


if __name__ == "__main__":
    main()
