#!/usr/bin/env python3
"""How far the small scene step's parameter gradients can be compared.

    python3 tools/scene_grad_sensitivity.py [--seeds N]

Runs on the CPU, at the small scene configuration of chip_smoke.py's
parity phase (SMALL_SCENE_OVERRIDES, one synthetic scene), with the PyTorch
port's random init. Prints:

1. per init seed 0..N-1, the smallest ReLU input margin of the forward:
   min over the ReLU calls of (smallest nonzero |input|) / (largest
   |input|) of that call: how close to a ReLU decision the step sits;
2. for seed 0, how the parameter gradients of one step move when the
   weights or the conditioning images are scaled by (1 + eps * N(0, 1))
   for eps 1e-7, 1e-6, 1e-5: relative L2 over all parameter gradients and
   the worst tensor (max abs change over its largest entry), and how many
   ReLU decisions the perturbation flipped.

A linear response means no decision flipped; a jump between two eps means
one did. chip_smoke.py holds the card's scene gradients to the CPU's in
relative L2 for this reason (TOL_SCENE_PARAM_L2).
"""

from __future__ import annotations

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=8)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F
    from chip_smoke import SMALL_SCENE_OVERRIDES
    from unipre3d_tpu_torch.data import (SyntheticSceneDataset, batch_to,
                                         collate)
    from unipre3d_tpu_torch.training import trainer
    from unipre3d_tpu_torch.training.config import load_config

    cfg = load_config("sparseunet_pretraining",
                      overrides=SMALL_SCENE_OVERRIDES)
    batch = batch_to(collate([SyntheticSceneDataset(
        cfg, num_scenes=1, seed=0, device="cpu")[0]]), "cpu")
    n_in = int(cfg.data.input_images)
    bg = trainer.bg_color_of(cfg)
    relu_inputs = []
    relu = F.relu

    def recording_relu(x, *a, **k):
        relu_inputs.append(x.detach().clone())
        return relu(x, *a, **k)

    def step(seed, w_eps=0.0, img_eps=0.0, backward=True):
        """One forward (+ backward) of the scene step; returns the
        parameter gradients and the ReLU inputs."""
        model, _ = trainer.create_train_state(cfg, device="cpu", seed=seed)
        g = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + w_eps * torch.randn(p.shape, generator=g))
        b = dict(batch)
        b["geometry"] = trainer.make_geometry_fn(cfg, model)(b)
        cond = b["gt_images"][:, :n_in]
        cond = cond * (1 + img_eps * torch.randn(cond.shape, generator=g))
        model.train()
        relu_inputs.clear()
        F.relu = recording_relu
        try:
            with torch.set_grad_enabled(backward):
                out = model(b["point_cloud"], cond,
                            unprojected_coords=b["unprojected_coords"],
                            geometry=b["geometry"])
        finally:
            F.relu = relu
        xs = list(relu_inputs)
        if not backward:
            return None, xs
        loss, _ = trainer.compute_loss(
            trainer.render_supervision_views(out, b, cfg, bg),
            b["gt_images"][:, n_in:], cfg, bg)
        loss.backward()
        return ({n: p.grad.clone() for n, p in model.named_parameters()
                 if p.grad is not None}, xs)

    for seed in range(args.seeds):
        _, xs = step(seed, backward=False)
        margins = [float(x.abs()[x != 0].min() / x.abs().max()) for x in xs]
        i = min(range(len(margins)), key=margins.__getitem__)
        print(f"seed {seed}: smallest ReLU margin {margins[i]:.3e} (ReLU "
              f"call {i} of {len(xs)}; "
              f"{sum(int((x != 0).sum()) for x in xs)} nonzero inputs)",
              flush=True)

    ref, ref_x = step(0)
    gmax = max(float(x.abs().max()) for x in ref.values())
    for what in ("weights", "images"):
        for eps in (1e-7, 1e-6, 1e-5):
            kw = {"w_eps" if what == "weights" else "img_eps": eps}
            grads, xs = step(0, **kw)
            l2 = math.sqrt(
                sum(float(((grads[n] - ref[n]) ** 2).sum()) for n in ref)
                / sum(float((ref[n] ** 2).sum()) for n in ref))
            worst, name = max(
                (float((grads[n] - x).abs().max() / x.abs().max()), n)
                for n, x in ref.items() if float(x.abs().max()) >= 1e-3 * gmax)
            flips = sum(int(((a > 0) != (b > 0)).sum())
                        for a, b in zip(ref_x, xs))
            print(f"{what} x (1 + {eps:g} N(0,1)): gradients relative L2 "
                  f"{l2:.3e}, worst tensor {worst:.3e} ({name}); ReLU "
                  f"decisions flipped {flips}", flush=True)


if __name__ == "__main__":
    main()
