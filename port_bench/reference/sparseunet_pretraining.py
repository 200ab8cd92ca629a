"""Plain reference of ``sparseunet_pretraining``'s training step (one
rank's share: its scenes, with no exchange).

From the weights and batches the harness made, it builds the float32
scene predictor (scene_nets.py), builds each batch's index structures
itself, and follows the program through its first steps: the frozen
VAE's ``decoder_block_3`` of the conditioning views, SparseUNet with
PointFusion, the gaussians, the supervision views through the tiled
renderer (render.py, ``raster_tile_capacity`` gaussians a tile), the L2
loss, the gradient, its clip, AdamW and the EMA (optim.py). TF32 is off
while it runs; ``rounding`` ``fp8`` makes the control.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from port_bench.reference import render, scene_nets
from port_bench.reference.optim import AdamW, ema_update
from port_bench.reference.precision import Rounding
from port_bench.reference.transformer_pretraining import (bn_changes,
                                                          head_of,
                                                          materialize,
                                                          no_tf32)


def build(spec: dict, rounding: str = "float32", with_lpips: bool = False):
    """(predictor, None) on the meta device, the spec's widths."""
    if with_lpips:
        raise ValueError("the scene reference has no LPIPS term")
    model = scene_nets.ScenePredictor(
        Rounding(rounding), float(spec["offset_scale"]), spec["vae"],
        float(spec["grid_size"]), int(spec["pixel_capacity"]),
        tuple(spec["level_capacity_div"]))
    return model, None


def on_device(batch, device):
    """The host batch as the program's ``batch_to`` hands it: float arrays
    as float32, integer and boolean arrays as they are."""
    def conv(a):
        t = torch.as_tensor(a)
        return (t.float() if t.is_floating_point() else t).to(device)
    return {k: on_device(v, device) if isinstance(v, dict) else conv(v)
            for k, v in batch.items()}


def run_steps(spec: dict, weights: Dict[str, torch.Tensor], batches: List,
              generator_seed: int, start_step: int, device,
              rounding: str = "float32", lpips_weights: Optional[Dict] = None,
              counter: Optional[dict] = None) -> dict:
    """As transformer_pretraining.run_steps; ``counter`` gains the valid
    rows of each batch (``valid_rows``) and the tiled renderer's overlaps
    past its capacity (``tile_dropped``)."""
    n_in = int(spec["input_images"])
    H, W = int(spec["training_height"]), int(spec["training_width"])
    bg = [1.0] * 3 if spec["white_background"] else [0.0] * 3
    ema_cfg = spec["ema"]
    with no_tf32():
        model, _ = build(spec, rounding)
        model = materialize(model, weights, "", device).train()
        named = [(n, p) for n, p in model.named_parameters()
                 if not n.startswith("image_network.")]
        params = [p for _, p in named]
        opt = AdamW(params, float(spec["base_lr"]), int(spec["step_lr"]),
                    float(spec["lr_gamma"]), *map(float, spec["betas"]))
        ema = {n: p.detach().clone() for n, p in named}
        step, losses, out = start_step, [], {}
        for i, host_batch in enumerate(batches):
            b = on_device(host_batch, device)
            geo = model.geometry(b["point_cloud"], b["unprojected_coords"])
            if counter is not None:
                counter.setdefault("valid_rows", []).append(
                    int(geo.fine_mask.sum()))
            cond = b["gt_images"][:, :n_in].flatten(0, 1)
            feats = model.vae_features(cond)
            if i == 0:
                out["vae_features"] = feats.detach().float()
            with head_of(model, out if i == 0 else {}):
                g = model(b["point_cloud"], feats, geo)
            rendered = render.render_scene_views(
                g, b, n_in, H, W, float(spec["fov"]), bg,
                int(spec["raster_tile_capacity"]), counter)
            if i == 0:
                out["gaussians"] = {k: v.detach().float() if
                                    v.is_floating_point() else v.detach()
                                    for k, v in g.items()}
                out["renders"] = rendered.detach().float()
            loss = ((rendered - b["gt_images"][:, n_in:]) ** 2).mean()
            grads = torch.autograd.grad(loss, params)
            losses.append(float(loss.detach()))
            taken = opt.update(list(grads))
            step += 1
            if ema_cfg["use"]:
                ema_update(ema, named, step, float(ema_cfg["beta"]),
                           int(ema_cfg["update_every"]),
                           int(ema_cfg["update_after_step"]))
            if i == 0:
                out["bn1_norms"] = bn_changes(model)
                out["grad_norm"] = float(torch.sqrt(sum(
                    (t.double() ** 2).sum() for t in grads)))
                out["grads"] = {n: t.detach().clone() for (n, _), t in
                                zip(named, taken or grads)}
                out["grad_norms"] = {n: float(t.norm()) for n, t in
                                     out["grads"].items()}
        out["losses"] = losses
        out["updates"] = {n: p.detach() - weights[n] for n, p in named}
        out["update_norms"] = {n: float(u.norm()) for n, u in
                               out["updates"].items()}
        out["ema_norms"] = {n: float((ema[n] - weights[n]).norm())
                            for n, _ in named}
        out["bn_norms"] = bn_changes(model)
    return out


def flop_step(spec: dict, mix: dict, batch, device):
    """(samples, the counted work) of one training step for
    counts/model_flops.py over ``batch`` on ``device``, since the index
    structures are built from the data (their capacities, and so the
    count, are fixed): the frozen VAE's forward on the conditioning views
    and the predictor's forward and backward; the geometry build and the
    renderer left out."""
    from port_bench.weights import make_weights, shapes_of
    n_in = int(spec["input_images"])
    model, _ = build(spec)
    model = materialize(model, make_weights(shapes_of(model), 0, device),
                        "", device)
    b = on_device(batch, device)
    params = [p for n, p in model.named_parameters()
              if not n.startswith("image_network.")]
    geo = model.geometry(b["point_cloud"], b["unprojected_coords"])

    def work():
        feats = model.vae_features(b["gt_images"][:, :n_in].flatten(0, 1))
        g = model(b["point_cloud"], feats, geo)
        outs = [v for v in g.values() if v.is_floating_point()]
        torch.autograd.grad(outs, params, [torch.randn_like(v)
                                           for v in outs],
                            allow_unused=True)
    return b["gt_images"].shape[0], work


def render_gaussians(spec: dict, gaussians: dict, host_batch, device):
    """The supervision views [B, V_sup, 3, H, W] of a scene's
    ``gaussians`` (with their ``mask``) against ``host_batch``'s cameras,
    through the plain tiled renderer in float32 with TF32 off."""
    n_in = int(spec["input_images"])
    H, W = int(spec["training_height"]), int(spec["training_width"])
    bg = [1.0] * 3 if spec["white_background"] else [0.0] * 3
    with no_tf32(), torch.no_grad():
        g = {k: v.to(device) for k, v in gaussians.items()}
        return render.render_scene_views(
            g, on_device(host_batch, device), n_in, H, W, float(spec["fov"]),
            bg, int(spec["raster_tile_capacity"]))
