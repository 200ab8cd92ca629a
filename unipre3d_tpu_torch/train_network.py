"""Pretraining entry point of the PyTorch port.

    python -m unipre3d_tpu_torch.train_network --config-name \
        transformer_pretraining data.dataset_root=synthetic opt.iterations=3 \
        [--device cpu] [--output-dir DIR] [key.subkey=value ...]
    python -m unipre3d_tpu_torch.train_network --config-name \
        sparseunet_pretraining data.pts_dataset_root=synthetic [...]
    python -m unipre3d_tpu_torch.train_network --config-name \
        ptv3_pretraining data.pts_dataset_root=synthetic [...]

Counterpart of the repository's ``train_network.py``: composes the same
config tree (the port's own copy under ``unipre3d_tpu_torch/configs``),
writes it to ``<output dir>/.hydra/config.yaml`` (default
``experiments_out/<date>/<time>``), resumes from ``model_latest.ckpt`` there
if it exists, and runs the train steps up to ``opt.iterations`` on one
device (the CUDA card unless ``--device`` names another).

It runs the JAX CLI's default run: the model computes in
``tpu.compute_dtype`` (``bfloat16`` by default; ``float32`` restores the
float32 run, any other value raises), and with ``opt.use_fusion`` the
frozen VAE's features come from the device feature cache
(training/feature_cache.py) of ``tpu.vae_cache_entries`` slots (512 by
default; 0 runs the VAE in every step), attached to each batch before its
step. Real data comes through ``data.dataset_root`` (a ShapeNet tree) or
``data.pts_dataset_root`` (a ScanNet tree); ``synthetic`` selects the
procedural datasets.

Every ``logging.loss_log`` steps it logs loss, PSNR, the gradient norm,
``samples_per_sec`` and the cache's ``vae_cache_hit_rate`` through the
logger (the console and ``metrics.jsonl`` in the output directory; wandb
when ``wandb.entity`` is set); every ``logging.val_log`` steps and at the
last it scores the ``val`` split with the eval step (novel-view PSNR and
SSIM) and writes ``model_latest.ckpt``, and ``model_best.ckpt`` when the
novel PSNR is the best yet; every ``logging.loop_log`` steps it renders
the test videos of ``opt.test_generation_num`` test examples
(training/video.py). At scene level each batch's SparseUNet or PTv3 geometry
is built before its step and timed apart, as is the cache's attach.

``opt.pretrained_ckpt`` warm-starts the transformer backbone from a
reference-named ``.pth`` (``warm_start``; a resume from
``model_latest.ckpt`` overrides it), and ``opt.lpips_weights`` adds the
LPIPS term to the loss after ``opt.start_lpips_after`` steps
(utils/lpips.py; an ``.npz`` of the converted tree or a ``.pth`` of
torchvision's and lpips' weights). Unlike the JAX CLI, which skips a path
that does not exist, a set path that does not exist raises, and so does
``opt.pretrained_ckpt`` on another backbone, which JAX ignores.
``data.mix_prob > 0`` raises, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from unipre3d_tpu_torch import resolve_device
from unipre3d_tpu_torch.data import Loader, batch_to, get_dataset
from unipre3d_tpu_torch.training import checkpoint as ckpt_lib
from unipre3d_tpu_torch.training.config import load_config, save_config
from unipre3d_tpu_torch.training.feature_cache import (DeviceVAECache,
                                                       make_feature_fn)
from unipre3d_tpu_torch.training.logger import Logger
from unipre3d_tpu_torch.training.trainer import (compute_dtype_of,
                                                 create_train_state,
                                                 make_eval_step,
                                                 make_geometry_fn,
                                                 make_train_step)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config-name", default="default_config")
    p.add_argument("--config-dir", default=None)
    p.add_argument("--output-dir", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; a missing card is an "
                        "error)")
    p.add_argument("overrides", nargs="*", help="key.subkey=value overrides")
    return p.parse_intermixed_args(argv)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def validate(eval_step, state, loader, device) -> dict:
    """Mean novel-view PSNR and SSIM over the val split's batches."""
    psnrs, ssims = [], []
    for vb in loader.epoch(0):
        res = eval_step(state, batch_to(vb, device))
        psnrs.append(float(res["psnr_novel"]))
        ssims.append(float(res["ssim_novel"]))
    return {"psnr_novel": float(np.mean(psnrs)) if psnrs else 0.0,
            "ssim_novel": float(np.mean(ssims)) if ssims else 0.0}


def existing_path(cfg, key: str):
    """``opt.<key>`` when set, else None; a set path must exist."""
    path = str(cfg.opt.get(key) or "")
    if not path:
        return None
    if not os.path.exists(path):
        raise FileNotFoundError(f"opt.{key}: no file {path!r}")
    return path


def warm_start(model, state, path: str) -> int:
    """Load the transformer backbone of a reference-named torch checkpoint
    (``{"model_state_dict": ...}`` or a bare state dict) into the model's
    parameters, its BatchNorm statistics and the EMA, as the JAX CLI does
    (reference ``opt.pretrained_ckpt``, model/point_predictor.py:44-53,
    strict=False: keys it lacks keep their values). Returns the number of
    checkpoint tensors under ``point_network.encoder.``."""
    from unipre3d_tpu_torch import weights
    from unipre3d_tpu_torch.export import import_transformer_backbone
    from unipre3d_tpu_torch.training.trainer import split_frozen
    sd = torch.load(path, map_location="cpu", weights_only=False)
    sd = sd.get("model_state_dict", sd)
    prefix = "point_network.encoder"
    own = {k: v for k, v in model.state_dict().items()
           if k.startswith(prefix + ".")}
    params, stats = weights.state_dict_to_jax(own)
    import_transformer_backbone(sd, params["point_network"]["encoder"],
                                stats["point_network"]["encoder"],
                                prefix=prefix)
    new = weights.jax_to_state_dict(params, stats)
    if set(new) != set(own):
        raise ValueError(f"{path}: tensors the backbone has no place for: "
                         f"{sorted(set(new) ^ set(own))[:5]}")
    with torch.no_grad():
        for k, v in new.items():
            own[k].copy_(v)
        for n, p in split_frozen(model)[0]:
            state.ema[n].copy_(p)
    return sum(k.startswith(prefix + ".") for k in sd)


def make_cache(cfg, model, device):
    """The VAE feature cache of a config: ``tpu.vae_cache_entries`` slots
    of the conditioning views' ``decoder_block_3`` map when the config uses
    the fusion, else None."""
    entries = int((cfg.get("tpu") or {}).get("vae_cache_entries", 0))
    if entries <= 0 or not bool(cfg.opt.use_fusion):
        return None
    if "training_resolution" in cfg.data:
        h = w = int(cfg.data.training_resolution)
    else:
        h, w = int(cfg.data.training_height), int(cfg.data.training_width)
    # decoder_block_3's width is the VAE's first block width
    vo = dict(cfg.model.get("vae_overrides") or {})
    channels = int(list(vo.get("block_out_channels", [128]))[0])
    return DeviceVAECache(make_feature_fn(model), entries, h, w,
                          channels=channels, device=device)


def main(argv=None) -> dict:
    """Run the training loop; returns per-step ``losses``, ``psnrs``,
    ``grad_norms``, ``nan_skipped`` (1.0 where the NaN skip dropped the
    update), with LPIPS weights ``lpips`` (0 before the gate), ``step_ms``
    (host clock around each synchronized step), and at scene level
    ``geometry_ms`` (the geometry build before the step) and
    ``valid_rows`` (valid voxel rows, i.e. gaussians, of the batch), for
    PTv3 ``stage_rows`` (each stage's valid rows) and ``pool_dropped``
    (each pooling's parents dropped past its capacity), on the
    binned route the render's ``dups``, ``budget_dropped`` and
    ``cap_dropped`` (duplicates kept, dropped by the budget, past the
    per-tile cap), the set-up time ``setup_s`` (config, dataset with its
    GT renders, model), ``val`` (per validation: ``iteration``,
    ``psnr_novel``, ``ssim_novel``, ``ms``), ``videos`` (the written test
    videos), ``output_dir``, ``best_psnr``, ``compute_dtype`` (its config
    name), ``hit_rate`` (the feature cache's over the run; None without
    the cache) and, with the cache, ``cache_ms`` (each batch's attach,
    synchronized, before its step), ``cache_counts`` (its hits, host-tier
    hits and misses) and ``cache_gib`` (its device buffer)."""
    args = parse_args(argv)
    cfg = load_config(args.config_name, config_dir=args.config_dir,
                      overrides=args.overrides)
    device = resolve_device(args.device)
    out_dir = args.output_dir or os.path.join(
        "experiments_out", time.strftime("%Y-%m-%d/%H-%M-%S"))
    os.makedirs(out_dir, exist_ok=True)
    save_config(cfg, os.path.join(out_dir, ".hydra", "config.yaml"))
    if float(cfg.data.get("mix_prob", 0.0)) > 0.0:
        # Mix3d merges only the point-cloud keys: with rendering
        # supervision the mixed cloud would train against scene A's
        # unmixed cameras and GT images (JAX's CLI raises alike)
        raise ValueError(
            "data.mix_prob > 0 is unsupported for rendering pretraining "
            "(half-mixed clouds vs unmixed render targets); use the "
            "segmentation fine-tune engine for Mix3d.")
    pretrained = existing_path(cfg, "pretrained_ckpt")
    if pretrained and cfg.model.backbone_type != "transformer":
        raise ValueError(f"opt.pretrained_ckpt warm-starts the transformer "
                         f"backbone only, not {cfg.model.backbone_type!r}")
    lpips_path = existing_path(cfg, "lpips_weights")
    seed = int(cfg.general.random_seed)
    t0 = time.perf_counter()
    batch_size = int(cfg.opt.batch_size)
    train_loader = Loader(get_dataset(cfg, "train", device), batch_size,
                          seed=seed)
    val_ds = get_dataset(cfg, "val", device)
    val_loader = Loader(val_ds, max(1, min(batch_size, len(val_ds))),
                        shuffle=False)
    test_loader = None       # built at the first test-video iteration
    compute_dtype = compute_dtype_of(cfg)
    model, state = create_train_state(cfg, device=device, seed=seed,
                                      dtype=compute_dtype)
    if pretrained:
        n = warm_start(model, state, pretrained)
        print(f"[train] warm-started backbone from {pretrained} ({n} "
              f"tensors)", flush=True)
    lpips = None
    if lpips_path:
        from unipre3d_tpu_torch.utils.lpips import (build_lpips,
                                                    load_lpips_params)
        lpips = build_lpips(load_lpips_params(lpips_path), device)
        print(f"[train] LPIPS weights loaded from {lpips_path}", flush=True)
    cache = make_cache(cfg, model, device)
    n_in = int(cfg.data.input_images)
    train_step = make_train_step(cfg, model, lpips)
    eval_step = make_eval_step(cfg, model)
    geometry_fn = make_geometry_fn(cfg, model)
    n_params = sum(p.numel() for p in model.parameters())
    latest = os.path.join(out_dir, "model_latest.ckpt")
    best_psnr = 0.0
    if os.path.exists(latest):
        state, best_psnr = ckpt_lib.load_checkpoint(latest, model, state)
        print(f"[train] resumed from step {state.step}", flush=True)
    _sync(device)
    setup_s = time.perf_counter() - t0
    dtype_name = str(compute_dtype).replace("torch.", "")
    print(f"[train] device={device} params={n_params / 1e6:.2f}M "
          f"backbone={cfg.model.backbone_type} compute {dtype_name} "
          f"setup {setup_s:.1f} s output {out_dir}", flush=True)
    if cache is not None:
        print(f"[train] VAE feature cache: {cache.capacity} slots "
              f"({cache.nbytes / 2**30:.2f} GiB on the device)", flush=True)
    logger = Logger(cfg, out_dir)

    iterations = int(cfg.opt.iterations)
    loss_log = int(cfg.logging.loss_log)
    val_log = int(cfg.logging.val_log)
    loop_log = int(cfg.logging.get("loop_log", 2000))
    result = {"losses": [], "psnrs": [], "grad_norms": [], "nan_skipped": [],
              "step_ms": [], "geometry_ms": [], "valid_rows": [], "val": [],
              "videos": [], "setup_s": setup_s, "output_dir": out_dir,
              "compute_dtype": dtype_name}
    if cache is not None:
        result["cache_ms"] = []
    batches = train_loader.iter_from(state.step)
    t_last, samples_since = time.perf_counter(), 0
    for it in range(state.step + 1, iterations + 1):
        host_batch = next(batches)
        batch = batch_to(host_batch, device)
        if cache is not None:
            # hashed on the host from the numpy batch, before the step
            _sync(device)
            t = time.perf_counter()
            batch["vae_features"] = cache.attach(host_batch, n_in)
            _sync(device)
            result["cache_ms"].append((time.perf_counter() - t) * 1e3)
        if geometry_fn is not None:
            _sync(device)
            t = time.perf_counter()
            batch["geometry"] = geometry_fn(batch)
            _sync(device)
            result["geometry_ms"].append((time.perf_counter() - t) * 1e3)
            geo = batch["geometry"]
            result["valid_rows"].append(int(geo.fine_mask.sum()))
            if hasattr(geo, "pool_dropped"):     # PTv3's stages
                result.setdefault("stage_rows", []).append(
                    [int(geo.fine_mask.sum())]
                    + [int(c.mask.sum()) for c in geo.clusters])
                result.setdefault("pool_dropped", []).append(
                    [int(x) for x in geo.pool_dropped.sum(0)])
        _sync(device)
        t = time.perf_counter()
        metrics = train_step(state, batch)
        _sync(device)
        result["step_ms"].append((time.perf_counter() - t) * 1e3)
        result["losses"].append(metrics["loss"])
        result["psnrs"].append(metrics["psnr"])
        result["grad_norms"].append(metrics["grad_norm"])
        result["nan_skipped"].append(metrics["nan_skipped"])
        if "lpips" in metrics:
            result.setdefault("lpips", []).append(metrics["lpips"])
        for k in ("dups", "budget_dropped", "cap_dropped"):
            if k in metrics:
                result.setdefault(k, []).append(int(metrics[k]))
        samples_since += batch_size
        if it % loss_log == 0:
            now = time.perf_counter()
            metrics["samples_per_sec"] = samples_since / (now - t_last)
            metrics["step_ms"] = result["step_ms"][-1]
            if cache is not None:
                metrics["vae_cache_hit_rate"] = round(cache.hit_rate, 4)
            logger.log(it, metrics)
            t_last, samples_since = now, 0
        if it % val_log == 0 or it == iterations:
            t = time.perf_counter()
            val = validate(eval_step, state, val_loader, device)
            val.update(iteration=it, ms=(time.perf_counter() - t) * 1e3)
            result["val"].append(val)
            logger.log(it, {"psnr_novel": val["psnr_novel"],
                            "ssim_novel": val["ssim_novel"]}, prefix="val")
            ckpt_lib.save_checkpoint(latest, model, state, best_psnr)
            if val["psnr_novel"] > best_psnr:
                best_psnr = val["psnr_novel"]
                ckpt_lib.save_checkpoint(
                    os.path.join(out_dir, "model_best.ckpt"), model, state,
                    best_psnr)
        if it % loop_log == 0:
            from unipre3d_tpu_torch.training.video import \
                generate_test_examples
            if test_loader is None:
                test_loader = Loader(get_dataset(cfg, "test", device), 1,
                                     shuffle=False, drop_last=False)
            try:
                paths = generate_test_examples(
                    model, state, cfg, test_loader, out_dir, it,
                    int(cfg.opt.get("test_generation_num", 1)))
                result["videos"] += paths
                logger.log_videos(it, paths)
            except ImportError as e:     # the writer's imageio is missing
                print(f"[train] test videos rendered, not written: {e}",
                      flush=True)
    batches.close()
    for loader in (train_loader, val_loader, test_loader):
        if loader is not None:
            loader.close()
    logger.close()
    result.update(best_psnr=best_psnr, hit_rate=None)
    if cache is not None:
        result.update(hit_rate=cache.hit_rate,
                      cache_counts={"hits": cache.hits,
                                    "l2_hits": cache.l2_hits,
                                    "misses": cache.misses},
                      cache_gib=cache.nbytes / 2**30)
    print(f"[train] done at iteration {iterations}; best PSNR_novel "
          f"{best_psnr:.3f}", flush=True)
    return result


if __name__ == "__main__":
    main()
