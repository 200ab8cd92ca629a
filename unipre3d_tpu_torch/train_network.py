"""Pretraining entry point of the PyTorch port.

    python -m unipre3d_tpu_torch.train_network --config-name \
        transformer_pretraining data.dataset_root=synthetic opt.iterations=3 \
        [--device cpu] [--output-dir DIR] [key.subkey=value ...]
    python -m unipre3d_tpu_torch.train_network --config-name \
        sparseunet_pretraining data.pts_dataset_root=synthetic [...]

Counterpart of the repository's ``train_network.py``: composes the same
config tree (the port's own copy under ``unipre3d_tpu_torch/configs``),
writes it to ``<output dir>/.hydra/config.yaml`` (default
``experiments_out/<date>/<time>``), resumes from ``model_latest.ckpt`` there
if it exists, and runs the train steps up to ``opt.iterations`` on one
device (the CUDA card unless ``--device`` names another). Every
``logging.loss_log`` steps it logs loss, PSNR and the gradient norm; every
``logging.val_log`` steps and at the last it scores the ``val`` split with
the eval step (novel-view PSNR and SSIM) and writes ``model_latest.ckpt``,
and ``model_best.ckpt`` when the novel PSNR is the best yet; every
``logging.loop_log`` steps it renders the test videos of
``opt.test_generation_num`` test examples (training/video.py). At scene
level each batch's SparseUNet geometry is built before its step and timed
apart. The VAE feature cache and the wandb logger are not ported.
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
from unipre3d_tpu_torch.training.trainer import (create_train_state,
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


def main(argv=None) -> dict:
    """Run the training loop; returns per-step ``losses``, ``psnrs``,
    ``grad_norms``, ``nan_skipped`` (1.0 where the NaN skip dropped the
    update), ``step_ms`` (host clock around each synchronized step), and at
    scene level ``geometry_ms`` (the geometry build before the step) and
    ``valid_rows`` (valid voxel rows, i.e. gaussians, of the batch), on the
    binned route the render's ``dups``, ``budget_dropped`` and
    ``cap_dropped`` (duplicates kept, dropped by the budget, past the
    per-tile cap), the set-up time ``setup_s`` (config, dataset with its
    GT renders, model), ``val`` (per validation: ``iteration``,
    ``psnr_novel``, ``ssim_novel``, ``ms``), ``videos`` (the written test
    videos), ``output_dir`` and ``best_psnr``."""
    args = parse_args(argv)
    cfg = load_config(args.config_name, config_dir=args.config_dir,
                      overrides=args.overrides)
    device = resolve_device(args.device)
    out_dir = args.output_dir or os.path.join(
        "experiments_out", time.strftime("%Y-%m-%d/%H-%M-%S"))
    os.makedirs(out_dir, exist_ok=True)
    save_config(cfg, os.path.join(out_dir, ".hydra", "config.yaml"))
    seed = int(cfg.general.random_seed)
    t0 = time.perf_counter()
    batch_size = int(cfg.opt.batch_size)
    train_loader = Loader(get_dataset(cfg, "train", device), batch_size,
                          seed=seed)
    val_ds = get_dataset(cfg, "val", device)
    val_loader = Loader(val_ds, max(1, min(batch_size, len(val_ds))),
                        shuffle=False)
    test_loader = None       # built at the first test-video iteration
    model, state = create_train_state(cfg, device=device, seed=seed)
    train_step = make_train_step(cfg, model)
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
    print(f"[train] device={device} params={n_params / 1e6:.2f}M "
          f"backbone={cfg.model.backbone_type} setup {setup_s:.1f} s "
          f"output {out_dir}", flush=True)

    iterations = int(cfg.opt.iterations)
    loss_log = int(cfg.logging.loss_log)
    val_log = int(cfg.logging.val_log)
    loop_log = int(cfg.logging.get("loop_log", 2000))
    result = {"losses": [], "psnrs": [], "grad_norms": [], "nan_skipped": [],
              "step_ms": [], "geometry_ms": [], "valid_rows": [], "val": [],
              "videos": [], "setup_s": setup_s, "output_dir": out_dir}
    batches = train_loader.iter_from(state.step)
    for it in range(state.step + 1, iterations + 1):
        batch = batch_to(next(batches), device)
        if geometry_fn is not None:
            _sync(device)
            t = time.perf_counter()
            batch["geometry"] = geometry_fn(batch)
            _sync(device)
            result["geometry_ms"].append((time.perf_counter() - t) * 1e3)
            result["valid_rows"].append(int(batch["geometry"].fine_mask.sum()))
        _sync(device)
        t = time.perf_counter()
        metrics = train_step(state, batch)
        _sync(device)
        result["step_ms"].append((time.perf_counter() - t) * 1e3)
        result["losses"].append(metrics["loss"])
        result["psnrs"].append(metrics["psnr"])
        result["grad_norms"].append(metrics["grad_norm"])
        result["nan_skipped"].append(metrics["nan_skipped"])
        for k in ("dups", "budget_dropped", "cap_dropped"):
            if k in metrics:
                result.setdefault(k, []).append(int(metrics[k]))
        if it % loss_log == 0:
            print(f"[train] it {it} loss {metrics['loss']:.6f} psnr "
                  f"{metrics['psnr']:.3f} grad_norm "
                  f"{metrics['grad_norm']:.4f} step "
                  f"{result['step_ms'][-1]:.1f} ms", flush=True)
        if it % val_log == 0 or it == iterations:
            t = time.perf_counter()
            val = validate(eval_step, state, val_loader, device)
            val.update(iteration=it, ms=(time.perf_counter() - t) * 1e3)
            result["val"].append(val)
            print(f"[val] it {it} psnr_novel {val['psnr_novel']:.3f} "
                  f"ssim_novel {val['ssim_novel']:.4f}", flush=True)
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
                result["videos"] += generate_test_examples(
                    model, state, cfg, test_loader, out_dir, it,
                    int(cfg.opt.get("test_generation_num", 1)))
            except ImportError as e:     # the writer's imageio is missing
                print(f"[train] test videos rendered, not written: {e}",
                      flush=True)
    result["best_psnr"] = best_psnr
    print(f"[train] done at iteration {iterations}; best PSNR_novel "
          f"{best_psnr:.3f}", flush=True)
    return result


if __name__ == "__main__":
    main()
