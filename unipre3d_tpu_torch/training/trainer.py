"""Training: the object- and scene-pretraining step and the eval step.

Port of unipre3d_tpu/training/trainer.py: backbone forward (frozen VAE
under ``torch.no_grad``), all B*V supervision renders in one splat launch
each way, the photometric loss, then AdamW(eps 1e-15) with StepLR, clip
1.0, the NaN skip and EMA, with the LPIPS term when LPIPS weights are
given. The optimizer is written out to reproduce the
optax chain of the JAX package exactly (``AdamW`` below); the step updates
the model, optimizer, BatchNorm running stats and EMA in place (torch
idiom; the JAX step returns a new state). The eval step renders every view
with the EMA parameters in eval mode and returns the cond/novel PSNR and
SSIM.

Renderer routes (``tpu.raster_impl_train``): ``pallas_dense`` or ``auto``
with N <= 4096 take the dense splat (splat_dense.py); ``pallas_binned``
takes the binned splat (splat_binned.py) with the JAX trainer's tiles
(``auto_tile`` clamped to 256 px) and per-tile cap (4 x
``tpu.raster_tile_capacity``); ``xla``, and ``auto`` at larger N, take the
tiled renderer (render.py:rasterize_projected) with ``auto_tile`` tiles and
``tpu.raster_tile_capacity`` gaussians a tile. Any other value raises (the
JAX trainer reads a value it does not know as ``xla``).

The scene level takes its index structures (SparseUNet or PTv3 geometry) from
``batch["geometry"]``, built before the step by ``make_geometry_fn``, or
builds them inside the step when the batch has none. Both steps take the
conditioning views' VAE features from ``batch["vae_features"]`` when the
feature cache attached them (training/feature_cache.py), and run the VAE
otherwise.

The model computes in the ``dtype`` given to ``create_train_state``
(float32 by default, as the JAX package's; the CLI passes
``compute_dtype_of(cfg)``, bfloat16 by default); the parameters, the
optimizer, the EMA and the renderer stay float32.

Under several processes (parallel/distributed.py) each rank steps on its
shard of the global batch: the forward runs inside ``synced()`` (BatchNorm
statistics and DropPath's mask of the global batch), the gradients are
averaged over ranks in one flat buffer right after ``torch.autograd.grad``
and before the norm, the clip, the NaN skip and AdamW, so every rank takes
the same decision and update, and the metrics are the global batch's:
``loss`` and ``lpips`` are means over ranks, ``psnr`` comes from the
reduced MSE (JAX's PSNR of the global batch, not a mean of the ranks'
PSNRs), ``grad_norm`` is the reduced gradient's, and the binned route's
counts are sums. ``DistributedDataParallel`` would not do: it reduces in
hooks that ``torch.autograd.grad`` never runs.

On a ``(data, model)`` grid (parallel/mesh.py) "ranks" above are the data
group's: the ranks of a model group step on the same rows, each with its
part of the split parameters (and of their EMA and Adam moments). One
all-reduce over the model group then averages the replicated parameters'
gradients (computed on every rank of the group, rounded otherwise by the
card's float atomics), sums the squares of the split parts for the
gradient norm (the replicated ones counted once) and agrees the
finiteness, so the clip, the NaN skip and AdamW take the same decision
and the replicated parameters stay the same on every rank, as JAX's
global arrays are.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch
from torch import nn

from unipre3d_tpu_torch import resolve_device
from unipre3d_tpu_torch.models.gaussian_predictor import (
    GaussianSplatPredictor, build_predictor)
from unipre3d_tpu_torch.models.sparseunet import SparseKernel
from unipre3d_tpu_torch.ops.rasterizer.preprocess import (
    ProjectedGaussians, preprocess_gaussians)
from unipre3d_tpu_torch.ops.rasterizer.render import (
    auto_tile, binned_tile, rasterize_projected)
from unipre3d_tpu_torch.ops.rasterizer.splat_binned import \
    rasterize_projected_binned
from unipre3d_tpu_torch.ops.rasterizer.splat_dense import \
    rasterize_dense_batched
from unipre3d_tpu_torch.parallel import distributed as dist_lib
from unipre3d_tpu_torch.parallel.mesh import is_model_shard
from unipre3d_tpu_torch.parallel.tensor import model_sum_
from unipre3d_tpu_torch.telemetry import mark, span
from unipre3d_tpu_torch.utils import losses as loss_lib
from unipre3d_tpu_torch.utils.lpips import lpips_fn

DENSE_MAX_N = 4096   # the dense route serves up to this many gaussians
TRAIN_IMPLS = ("auto", "pallas_dense", "pallas_binned", "xla")
COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype_of(cfg) -> torch.dtype:
    """``tpu.compute_dtype`` (``bfloat16``, the default, or ``float32``) as
    a torch dtype. ``tpu.param_dtype`` may only be ``float32``: the
    parameters stay float32, as in the JAX package. Any other value of
    either key raises (the JAX CLI reads an unknown compute dtype as
    float32)."""
    tpu = cfg.get("tpu") or {}
    name = str(tpu.get("compute_dtype", "bfloat16"))
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"tpu.compute_dtype {name!r}: one of "
                         f"{tuple(COMPUTE_DTYPES)}")
    param = str(tpu.get("param_dtype", "float32"))
    if param != "float32":
        raise ValueError(f"tpu.param_dtype {param!r}: only float32")
    return COMPUTE_DTYPES[name]


def split_frozen(model: nn.Module):
    """(trainable, frozen) named parameters: the SD-VAE (``image_network``)
    is frozen, out of autograd and of the optimizer."""
    trainable, frozen = [], []
    for name, p in model.named_parameters():
        (frozen if name.startswith("image_network.") else trainable).append(
            (name, p))
    return trainable, frozen


class AdamW:
    """optax ``apply_if_finite(chain(clip_by_global_norm(1.0),
    adamw(exponential_decay(staircase), b1, b2, eps=1e-15,
    weight_decay=0.01)))``, written out:

    * clip: ``g * max_norm / |g|`` only when ``|g| >= max_norm`` (no +1e-6,
      unlike ``torch.nn.utils.clip_grad_norm_``);
    * AdamW decays every trainable tensor, biases and norms included;
    * a non-finite gradient skips the update and leaves the Adam moments,
      the Adam count and the schedule where they were.
    """

    def __init__(self, params: List[torch.Tensor], base_lr: float,
                 step_lr: int, lr_gamma: float, betas=(0.9, 0.999),
                 eps: float = 1e-15, weight_decay: float = 0.01,
                 max_norm: float = 1.0):
        self.params = params
        self.base_lr, self.step_lr, self.lr_gamma = base_lr, step_lr, lr_gamma
        self.b1, self.b2 = float(betas[0]), float(betas[1])
        self.eps, self.weight_decay, self.max_norm = eps, weight_decay, max_norm
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0   # applied updates (the schedule's step too)

    def lr(self) -> float:
        return self.base_lr * self.lr_gamma ** (self.count // self.step_lr)

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], grad_norm: torch.Tensor,
               finite=None) -> bool:
        """Apply one update; False (and no change) if a gradient is not
        finite (``finite``, when given: the verdict over every rank's
        part)."""
        if finite is None:
            finite = all_finite(grads)
        # the host waits here for the backward and the norm to drain
        with span("sync/optimizer"):
            if not bool(finite):
                return False
            norm = float(grad_norm)
        if norm >= self.max_norm:
            grads = torch._foreach_mul(torch._foreach_div(grads, norm),
                                       self.max_norm)
        b1, b2, k = self.b1, self.b2, self.count + 1
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1.0 - b2))
        mu_hat = torch._foreach_div(self.mu, 1.0 - b1 ** k)
        nu_hat = torch._foreach_div(self.nu, 1.0 - b2 ** k)
        den = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps)
        upd = torch._foreach_div(mu_hat, den)
        torch._foreach_add_(upd, torch._foreach_mul(self.params,
                                                    self.weight_decay))
        torch._foreach_add_(self.params, torch._foreach_mul(upd, -self.lr()))
        self.count += 1
        return True


def all_finite(grads: List[torch.Tensor]) -> torch.Tensor:
    """Whether every entry is finite (optax ``apply_if_finite``'s test)."""
    return torch.stack([torch.isfinite(g).all() for g in grads]).all()


class _Clock:
    """Elapsed time of a stretch of device work: CUDA events on a card,
    the host clock on the CPU (where the work is synchronous)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.t = time.perf_counter()

    def stop(self) -> "_Clock":
        if self.cuda:
            self.end.record()
        else:
            self.t = time.perf_counter() - self.t
        return self

    def ms(self) -> float:
        if self.cuda:
            self.end.synchronize()
            return self.start.elapsed_time(self.end)
        return self.t * 1e3


def make_optimizer(cfg, params: List[torch.Tensor]) -> AdamW:
    return AdamW(params, base_lr=float(cfg.opt.base_lr),
                 step_lr=int(cfg.opt.step_lr),
                 lr_gamma=float(cfg.opt.lr_gamma),
                 betas=cfg.opt.get("betas", [0.9, 0.999]))


def bg_color_of(cfg) -> List[float]:
    return [1.0, 1.0, 1.0] if cfg.data.white_background else [0.0, 0.0, 0.0]


def _image_hw(cfg) -> Tuple[int, int]:
    if "training_resolution" in cfg.data:
        res = int(cfg.data.training_resolution)
        return res, res
    return int(cfg.data.training_height), int(cfg.data.training_width)


def render_supervision_views(gaussians: Dict[str, torch.Tensor], batch,
                             cfg, bg_color, stats=None,
                             start_view: int = None) -> torch.Tensor:
    """Render views [start_view:] (default: the supervision views after the
    ``input_images`` conditioning views) of every batch element in one
    splat launch -> [B, V_sup, 3, H, W]. On the binned route a ``stats``
    dict, if given, receives the duplicate list's counts
    (splat_binned.duplicate_stats)."""
    n_in = int(cfg.data.input_images) if start_view is None else start_view
    img_h, img_w = _image_hw(cfg)
    tanfov = math.tan(float(cfg.data.fov) * math.pi / 360)
    N = gaussians["xyz"].shape[1]
    tpu = cfg.get("tpu") or {}
    impl = str(tpu.get("raster_impl_train", "auto"))
    if impl not in TRAIN_IMPLS:
        raise ValueError(f"raster_impl_train {impl!r}: one of {TRAIN_IMPLS}")
    dense = impl == "pallas_dense" or (impl == "auto" and N <= DENSE_MAX_N)
    cap = int(tpu.get("raster_tile_capacity", 1024))
    shs = torch.cat([gaussians["features_dc"], gaussians["features_rest"]],
                    dim=2)
    mask = gaussians.get("mask")
    # gaussians [B, 1, N, ...] broadcast against cameras [B, V, ...]
    pg = preprocess_gaussians(
        gaussians["xyz"][:, None], gaussians["opacity"][:, None, :, 0],
        gaussians["scaling"][:, None], gaussians["rotation"][:, None],
        shs[:, None], batch["world_view_transforms"][:, n_in:],
        batch["full_proj_transforms"][:, n_in:],
        batch["camera_centers"][:, n_in:], img_h, img_w, tanfov, tanfov,
        int(cfg.model.max_sh_degree),
        gaussian_mask=None if mask is None else mask[:, None])
    B, Vs = pg.depth.shape[:2]
    flat = [t.expand(B, Vs, *t.shape[2:]).reshape(B * Vs, *t.shape[2:])
            for t in pg]
    mean2d, conic, color, opacity, depth, radius, valid = flat
    if dense:
        imgs = rasterize_dense_batched(mean2d, conic, color, opacity, depth,
                                       valid, bg_color, img_h, img_w)
    elif impl == "pallas_binned":
        th, tw = binned_tile(img_h, img_w)
        imgs = rasterize_projected_binned(
            mean2d, conic, color, opacity, depth, radius, valid, bg_color,
            img_h, img_w, th, tw, max_per_tile=4 * cap, stats=stats)
    else:
        imgs = rasterize_projected(ProjectedGaussians(*flat), bg_color,
                                   img_h, img_w, *auto_tile(img_h, img_w),
                                   capacity=cap)
    return imgs.reshape(B, Vs, 3, img_h, img_w)


def compute_loss(rendered, gt, cfg, bg_color):
    """Photometric loss; rendered/gt [B, V, 3, H, W]."""
    r = rendered.reshape(-1, *rendered.shape[2:])
    g = gt.reshape(-1, *gt.shape[2:])
    kind = cfg.opt.loss
    if kind == "focal_l2":
        main = loss_lib.focal_l2_loss(
            r, g, bg_color, float(cfg.opt.non_bg_color_loss_rate),
            float(cfg.opt.bg_color_loss_rate))
    elif kind == "l1":
        main = loss_lib.l1_loss(r, g)
    else:
        main = loss_lib.l2_loss(r, g)
    return main, {"loss": main, "psnr": loss_lib.psnr(r, g)}


def init_like_flax(model: nn.Module, generator: torch.Generator) -> None:
    """Random init with flax's defaults: Dense/Conv kernels lecun-normal
    (truncated normal, variance 1/fan_in), biases 0, norms (1, 0), the CLS
    token 0 and the CLS position N(0, 1); sparse-conv kernels
    truncated-normal(0.02); then each module's own ``flax_init``, where it
    has one. Draws come from ``generator``."""
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, SparseKernel):
                mod.reset_parameters(generator)
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                w = mod.weight
                fan_in = w[0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                w.copy_(torch.nn.init.trunc_normal_(
                    torch.empty(w.shape), std=std, a=-2 * std, b=2 * std,
                    generator=generator))
                if mod.bias is not None:
                    mod.bias.zero_()
        for name, p in model.named_parameters():
            if name.endswith("cls_pos"):
                p.copy_(torch.randn(p.shape, generator=generator))
        # modules whose flax initializers differ (the scan's parameters,
        # Mamba3D's CLS embeddings, PCM's prompt table) draw last
        for mod in model.modules():
            if hasattr(mod, "flax_init"):
                mod.flax_init(generator)


@dataclass
class TrainState:
    step: int
    optimizer: AdamW
    ema: Dict[str, torch.Tensor]    # EMA of the trainable parameters
    generator: torch.Generator      # DropPath draws


def create_train_state(cfg, device=None, seed: int = 0, state_dict=None,
                       dtype: torch.dtype = torch.float32
                       ) -> Tuple[GaussianSplatPredictor, TrainState]:
    """Model computing in ``dtype`` (random init from ``seed``, or
    ``state_dict``; float32 parameters), optimizer over the trainable
    parameters, EMA copy and DropPath generator."""
    dev = resolve_device(device)
    model = build_predictor(cfg, dtype=dtype)
    init_like_flax(model, torch.Generator().manual_seed(seed))
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model.to(dev)
    trainable, _ = split_frozen(model)
    opt = make_optimizer(cfg, [p for _, p in trainable])
    ema = {n: p.detach().clone() for n, p in trainable}
    gen = torch.Generator(device=dev).manual_seed(seed)
    return model, TrainState(step=0, optimizer=opt, ema=ema, generator=gen)


def make_geometry_fn(cfg, model: GaussianSplatPredictor):
    """Batch -> its scene backbone's geometry (models/scene_geometry.py:
    SparseUNet's, or PTv3's, which the JAX package builds inside the
    forward instead), or None for configs without one (object level). Run
    before the step, as the JAX package's input pipeline does for
    SparseUNet; the step takes it from ``batch["geometry"]``."""
    if cfg.opt.level != "scene":
        return None
    encoder = model.point_network.encoder
    use_fusion = bool(cfg.opt.use_fusion)

    def geometry_fn(batch):
        return encoder.build_geometry(batch["point_cloud"],
                                      batch.get("unprojected_coords"),
                                      use_fusion)

    return geometry_fn


def predict(model: GaussianSplatPredictor, batch, n_in: int, generator=None,
            params: Dict[str, torch.Tensor] = None):
    """The model's gaussians for a batch (object or scene schema), with
    ``params`` (a name -> tensor dict, e.g. the EMA) standing in for the
    module's parameters of the same names when given, and the batch's
    cached ``vae_features`` for the VAE when it has them."""
    if model.level == "scene":
        args = (batch["point_cloud"], batch["gt_images"][:, :n_in])
        kwargs = dict(unprojected_coords=batch.get("unprojected_coords"),
                      geometry=batch.get("geometry"), generator=generator)
    else:
        args = (batch["point_cloud"], batch["gt_images"][:, :n_in],
                batch["view_to_world_transforms"][:, :n_in])
        kwargs = dict(generator=generator)
    kwargs["vae_features"] = batch.get("vae_features")
    if params is None:
        return model(*args, **kwargs)
    return torch.func.functional_call(model, params, args, kwargs)


def all_reduce_grads(grads) -> List[torch.Tensor]:
    """The gradients averaged over the data group, through one flat
    buffer."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist_lib.all_reduce_sum_(flat).div_(dist_lib.data_count())
    return [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in
                                                      grads]), grads)]


def global_norm(grads, params):
    """(gradients, optax.global_norm of the whole gradient, whether every
    entry is finite). Split over a model group, one all-reduce over it
    averages the replicated parameters' gradients (each rank computed them
    redundantly, and the card's float atomics round them otherwise on
    each: unsynced, the ranks' replicated parameters would drift apart),
    sums the squares of the split parameters' parts and agrees the
    finiteness; the replicated squares are counted once."""
    if dist_lib.model_count() == 1:
        return grads, torch.sqrt(sum((g * g).sum() for g in grads)), \
            all_finite(grads)
    M = dist_lib.model_count()
    split = [is_model_shard(p) for p in params]
    rep = [g for g, k in zip(grads, split) if not k]
    own = [g for g, k in zip(grads, split) if k]
    zero = grads[0].new_zeros(())
    tail = torch.stack([sum(((g * g).sum() for g in own), zero),
                        (~all_finite(own)).to(zero.dtype) if own else zero])
    flat = model_sum_(torch.cat([g.reshape(-1) for g in rep] + [tail]))
    sizes = [g.numel() for g in rep]
    rep = [f.view_as(g).div_(M) for f, g in zip(
        flat[:-2].split(sizes), rep)]
    it = iter(rep)
    grads = [g if k else next(it) for g, k in zip(grads, split)]
    norm = torch.sqrt(sum((g * g).sum() for g in rep) + flat[-2])
    return grads, norm, all_finite(rep) & (flat[-1] == 0)


def _reduce_metrics(metrics: Dict, mse: torch.Tensor) -> Dict:
    """The global batch's metrics from the ranks' (equal local batches):
    means of the losses, PSNR of the mean MSE, sums of the counts."""
    means = [k for k in ("loss", "lpips") if k in metrics]
    sums = [k for k in ("dups", "budget_dropped", "cap_dropped")
            if k in metrics]
    vals = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float64)
                        .detach().cpu() for k in means + sums]
                       + [mse.detach().double().cpu()])
    dist_lib.all_reduce_sum_(vals)
    w = dist_lib.data_count()
    out = dict(metrics)
    for i, k in enumerate(means):
        out[k] = vals[i] / w
    for i, k in enumerate(sums):
        out[k] = vals[len(means) + i]
    out["psnr"] = -10.0 * torch.log10(torch.clamp_min(vals[-1] / w, 1e-12))
    return out


def make_train_step(cfg, model: GaussianSplatPredictor, lpips=None):
    """-> ``train_step(state, batch) -> metrics`` (updates in place): loss,
    psnr, grad_norm, nan_skipped, and on the binned route the render's
    ``dups``, ``budget_dropped`` and ``cap_dropped``; under several
    processes the global batch's (see the module docstring) and
    ``reduce_ms``, the gradient all-reduce's time (CUDA events on the
    card).

    With an ``lpips`` module (utils/lpips.py) and ``opt.lambda_lpips`` not
    0, the loss gains ``lambda_lpips`` x the mean LPIPS of the supervision
    renders against their ground truth, both mapped to [-1, 1], reported as
    ``lpips``, as the JAX step does (unipre3d_tpu/training/trainer.py:
    loss_fn). The term is gated on the step count before its increment,
    strictly: ``state.step > opt.start_lpips_after``; off the gate
    ``lpips`` is 0 and the VGG does not run."""
    bg_color = bg_color_of(cfg)
    n_in = int(cfg.data.input_images)
    lambda_lpips = float(cfg.opt.get("lambda_lpips", 0.01))
    start_lpips_after = int(cfg.opt.get("start_lpips_after", 0))
    if lambda_lpips == 0.0:
        lpips = None
    ema_cfg = cfg.opt.ema
    use_ema = bool(ema_cfg.use)
    ema_beta = float(ema_cfg.beta)
    ema_every = int(ema_cfg.update_every)
    ema_after = int(ema_cfg.update_after_step)
    trainable, _ = split_frozen(model)
    names = [n for n, _ in trainable]
    params = [p for _, p in trainable]

    def train_step(state: TrainState, batch) -> Dict[str, float]:
        render_stats = {}
        world = dist_lib.data_count()
        # the spans and backward marks (telemetry.py) label a profiler's
        # trace of the step; without one they cost a check each
        model.train()
        with dist_lib.synced():
            with span("step/forward"):
                gaussians = predict(model, batch, n_in, state.generator)
            with span("step/render"):
                rendered = render_supervision_views(gaussians, batch, cfg,
                                                    bg_color, render_stats)
                gt = batch["gt_images"][:, n_in:]
                loss, metrics = compute_loss(rendered, gt, cfg, bg_color)
                loss = mark(loss, "render")
            if lpips is not None:
                with span("step/lpips"):
                    if state.step > start_lpips_after:
                        lp = lpips_fn(lpips, rendered.flatten(0, 1) * 2 - 1,
                                      gt.flatten(0, 1) * 2 - 1).mean()
                    else:
                        lp = torch.zeros((), device=loss.device)
                    loss = mark(loss + lambda_lpips * lp, "lpips")
                    metrics.update(lpips=lp, loss=loss)
            with span("step/backward"):
                grads = torch.autograd.grad(loss, params)
        metrics.update(render_stats)
        if world > 1:
            with span("step/reduce"):
                t0 = _Clock(loss.device)
                grads = all_reduce_grads(grads)
                reduce_clock = t0.stop()
                metrics = _reduce_metrics(
                    metrics, ((rendered.detach() - gt) ** 2).mean())
        with span("step/optimizer"):
            with span("optimizer/norm"):
                # optax.global_norm: sqrt of the sum of every squared entry
                grads, grad_norm, finite = global_norm(grads, params)
            with span("optimizer/adamw"):
                applied = state.optimizer.update(list(grads), grad_norm,
                                                 finite)
            state.step += 1
            if use_ema:
                with span("optimizer/ema"), torch.no_grad():
                    if state.step <= ema_after:
                        for n, p in zip(names, params):
                            state.ema[n].copy_(p)
                    elif state.step % ema_every == 0:
                        for n, p in zip(names, params):
                            state.ema[n].mul_(ema_beta).add_(
                                p * (1.0 - ema_beta))
        with span("sync/metrics"):
            metrics = {k: float(v.detach()) for k, v in metrics.items()}
            metrics["grad_norm"] = float(grad_norm)
        metrics["nan_skipped"] = float(not applied)
        if world > 1:
            metrics["reduce_ms"] = reduce_clock.ms()
        return metrics

    return train_step


def make_eval_step(cfg, model: GaussianSplatPredictor, use_ema: bool = True):
    """-> ``eval_step(state, batch) -> dict``: every view of the batch
    rendered (``start_view=0``, the training step's route) from the EMA
    parameters (the model's own with ``use_ema=False``) in eval mode, and
    the PSNR and SSIM of the conditioning views (``psnr_cond``,
    ``ssim_cond``) and of the novel views (``psnr_novel``, ``ssim_novel``),
    each a mean over batch and views, with ``rendered`` [B, V, 3, H, W]."""
    bg_color = bg_color_of(cfg)
    n_in = int(cfg.data.input_images)

    @torch.no_grad()
    def eval_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        model.eval()
        gaussians = predict(model, batch, n_in,
                            params=state.ema if use_ema else None)
        rendered = render_supervision_views(gaussians, batch, cfg, bg_color,
                                            start_view=0)
        gt = batch["gt_images"]
        mse = ((rendered - gt) ** 2).mean(dim=(2, 3, 4))          # [B, V]
        psnr = -10.0 * torch.log10(torch.clamp_min(mse, 1e-12))
        B, V = rendered.shape[:2]
        ssim_bv = loss_lib.ssim(rendered.reshape(B * V, *rendered.shape[2:]),
                                gt.reshape(B * V, *gt.shape[2:]),
                                size_average=False).reshape(B, V)
        return {"psnr_cond": psnr[:, :n_in].mean(),
                "psnr_novel": psnr[:, n_in:].mean(),
                "ssim_cond": ssim_bv[:, :n_in].mean(),
                "ssim_novel": ssim_bv[:, n_in:].mean(),
                "rendered": rendered}

    return eval_step
