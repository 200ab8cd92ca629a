"""Plain reference of ``transformer_pretraining``'s training step.

From the weights and batches the harness made (never from the program's
state), it builds the float32 predictor (nets.py), the LPIPS module when
the cell has one (lpips.py), and follows the program through its first
steps: the frozen VAE's ``decoder_block_3`` of the conditioning view,
the gaussians, the supervision renders (render.py), the focal L2 loss
plus ``lambda_lpips`` x LPIPS past ``start_lpips_after``, the gradient,
its clip, AdamW and the EMA (optim.py). DropPath's masks come from a CUDA
generator seeded as the program's, drawn in the same order.

TF32 is switched off for matrix products and convolutions while it runs;
``rounding`` (precision.py) ``fp8`` makes the control of the correctness
check.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Optional

import torch

from port_bench.reference import nets, render
from port_bench.reference.lpips import LPIPS
from port_bench.reference.optim import AdamW, ema_update
from port_bench.reference.precision import Rounding


def build(spec: dict, rounding: str = "float32", with_lpips: bool = False):
    """(predictor, LPIPS or None) on the meta device, the spec's widths."""
    model = nets.ObjectPredictor(Rounding(rounding), float(spec["fov"]),
                                 int(spec["training_resolution"]),
                                 float(spec["offset_scale"]),
                                 int(spec["depth"]), spec["vae"])
    return model, (LPIPS() if with_lpips else None)


@contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


BN_START = {"running_mean": 0.0, "running_var": 1.0}


@contextmanager
def head_of(model, store: dict):
    """While open, the predictor's Gaussian head leaves its raw channels
    in ``store["head"]``."""
    hook = model.point_network.final.register_forward_hook(
        lambda _m, _a, out: store.__setitem__("head", out.detach().float()))
    try:
        yield store
    finally:
        hook.remove()


def materialize(module, weights: Dict[str, torch.Tensor], prefix: str,
                device):
    """The meta module on ``device`` holding ``weights[prefix + name]``,
    its BatchNorm running statistics at their start (mean 0, variance
    1)."""
    module = module.to_empty(device=device)
    state = {n: weights[prefix + n] for n, _ in module.named_parameters()}
    for n, b in module.named_buffers():
        state[n] = torch.full_like(b, BN_START[n.rsplit(".", 1)[-1]])
    module.load_state_dict(state)
    return module


def bn_changes(module) -> Dict[str, float]:
    """Norm of each BatchNorm running statistic's change from its start."""
    return {n: float((b - BN_START[n.rsplit(".", 1)[-1]]).norm())
            for n, b in module.named_buffers()
            if n.rsplit(".", 1)[-1] in BN_START}


def on_device(batch, device):
    return {k: torch.as_tensor(v).to(device).float() for k, v in batch.items()}


def run_steps(spec: dict, weights: Dict[str, torch.Tensor], batches: List,
              generator_seed: int, start_step: int, device,
              rounding: str = "float32", lpips_weights: Optional[Dict] = None,
              counter: Optional[dict] = None) -> dict:
    """Follow the program through ``len(batches)`` steps from ``weights``
    (name -> tensor, the predictor's; copied, not changed) and the state's
    step ``start_step``. Returns ``losses`` (each step's), ``grad_norms``
    (leaf -> norm of step 1's gradient after the clip), ``grads`` (those
    gradients), ``updates`` (leaf -> the change from ``weights`` after the
    last step), ``update_norms`` and ``ema_norms`` (their norms, and the
    EMA's), ``vae_features`` (step 1's decoder_block_3, float32),
    ``gaussians`` and ``renders`` (step 1's predictor output and
    supervision renders).
    ``counter`` gains the splat's contributing pairs of every step."""
    n_in = int(spec["input_images"])
    res = int(spec["training_resolution"])
    bg = [1.0] * 3 if spec["white_background"] else [0.0] * 3
    ema_cfg = spec["ema"]
    with no_tf32():
        model, lp = build(spec, rounding, lpips_weights is not None)
        model = materialize(model, weights, "", device)
        model.train()
        if lp is not None:
            lp = materialize(lp, lpips_weights, "", device).eval()
            lp.requires_grad_(False)
        named = [(n, p) for n, p in model.named_parameters()
                 if not n.startswith("image_network.")]
        params = [p for _, p in named]
        opt = AdamW(params, float(spec["base_lr"]), int(spec["step_lr"]),
                    float(spec["lr_gamma"]), *map(float, spec["betas"]))
        ema = {n: p.detach().clone() for n, p in named}
        gen = torch.Generator(device=device).manual_seed(generator_seed)
        step, losses, out = start_step, [], {}
        for i, host_batch in enumerate(batches):
            b = on_device(host_batch, device)
            cond = b["gt_images"][:, :n_in]
            feats = model.vae_features(cond[:, 0])
            if i == 0:
                out["vae_features"] = feats.detach().float()
            with head_of(model, out if i == 0 else {}):
                g = model(b["point_cloud"], cond,
                          b["view_to_world_transforms"], gen,
                          vae_features=feats)
            rendered = render.render_views(g, b, n_in, res, res,
                                           float(spec["fov"]), bg, counter)
            if i == 0:
                out["gaussians"] = {k: v.detach().float() if
                                    v.is_floating_point() else v.detach()
                                    for k, v in g.items()}
                out["renders"] = rendered.detach().float()
            gt = b["gt_images"][:, n_in:]
            loss = render.focal_l2(rendered, gt, bg,
                                   float(spec["non_bg_color_loss_rate"]),
                                   float(spec["bg_color_loss_rate"]))
            if lp is not None and step > int(spec["start_lpips_after"]):
                d = lp(rendered.flatten(0, 1) * 2 - 1,
                       gt.flatten(0, 1) * 2 - 1).mean()
                loss = loss + float(spec["lambda_lpips"]) * d
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
                    (g.double() ** 2).sum() for g in grads)))
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
    counts/model_flops.py: the frozen VAE's forward on the conditioning
    view, the predictor's forward and backward, and LPIPS's forward on both
    image sets and backward to the renders where the mix has it; the
    renderer left out. On the meta device (shapes only, nothing
    computed), so ``batch`` and ``device`` are not read."""
    B = int(spec["batch_size"])
    res = int(spec["training_resolution"])
    n_in, n_sup = int(spec["input_images"]), int(spec["imgs_per_obj"])
    meta = torch.device("meta")
    model, lp = build(spec, with_lpips=bool(mix.get("lpips")))
    pts = torch.empty(B, int(spec["num_points"]), 3, device=meta)
    images = torch.empty(B, n_in, 3, res, res, device=meta)
    c2w = torch.empty(B, n_in, 4, 4, device=meta)
    params = [p for n, p in model.named_parameters()
              if not n.startswith("image_network.")]

    def work():
        feats = model.vae_features(images[:, 0])
        g = model(pts, images, c2w, None, vae_features=feats)
        outs = list(g.values())
        torch.autograd.grad(outs, params,
                            [torch.empty_like(v) for v in outs],
                            allow_unused=True)
        if lp is not None:
            x = torch.empty(B * n_sup, 3, res, res, device=meta,
                            requires_grad=True)
            lp(x, torch.empty_like(x)).sum().backward()
    return B, work


def render_gaussians(spec: dict, gaussians: dict, host_batch, device):
    """The supervision views [B, V_sup, 3, H, W] of ``gaussians`` (a
    predictor's dict) against ``host_batch``'s cameras, through the plain
    renderer in float32 with TF32 off."""
    n_in = int(spec["input_images"])
    res = int(spec["training_resolution"])
    bg = [1.0] * 3 if spec["white_background"] else [0.0] * 3
    with no_tf32(), torch.no_grad():
        g = {k: v.to(device).float() for k, v in gaussians.items()}
        return render.render_views(g, on_device(host_batch, device), n_in,
                                   res, res, float(spec["fov"]), bg)
