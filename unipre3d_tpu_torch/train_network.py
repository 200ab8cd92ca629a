"""Pretraining entry point of the PyTorch port.

    python -m unipre3d_tpu_torch.train_network --config-name \
        transformer_pretraining data.dataset_root=synthetic opt.iterations=3 \
        [--device cpu] [key.subkey=value ...]
    python -m unipre3d_tpu_torch.train_network --config-name \
        sparseunet_pretraining data.pts_dataset_root=synthetic \
        tpu.raster_impl_train=pallas_binned [--device cpu] [...]

Counterpart of the repository's ``train_network.py``: composes the same
config tree (the port's own copy under ``unipre3d_tpu_torch/configs``),
builds the dataset, runs ``opt.iterations`` train steps on one device (the
CUDA card unless ``--device`` names another) and logs loss, PSNR and the
gradient norm every ``logging.loss_log`` steps. At scene level each
batch's SparseUNet geometry is built before its step and timed apart.
Checkpointing, the VAE feature cache, eval and the test videos are later
items (ROADMAP.md queue A).
"""

from __future__ import annotations

import argparse
import time

import torch

from unipre3d_tpu_torch import resolve_device
from unipre3d_tpu_torch.data import Loader, batch_to, get_dataset
from unipre3d_tpu_torch.training.config import load_config
from unipre3d_tpu_torch.training.trainer import (create_train_state,
                                                 make_geometry_fn,
                                                 make_train_step)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config-name", default="default_config")
    p.add_argument("--config-dir", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; a missing card is an "
                        "error)")
    p.add_argument("overrides", nargs="*", help="key.subkey=value overrides")
    return p.parse_intermixed_args(argv)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Run the training loop; returns per-step ``losses``, ``psnrs``,
    ``grad_norms``, ``nan_skipped`` (1.0 where the NaN skip dropped the
    update), ``step_ms`` (host clock around each synchronized step), and at
    scene level ``geometry_ms`` (the geometry build before the step) and
    ``valid_rows`` (valid voxel rows, i.e. gaussians, of the batch), on the
    binned route the render's ``dups``, ``budget_dropped`` and
    ``cap_dropped`` (duplicates kept, dropped by the budget, past the
    per-tile cap), and the set-up time ``setup_s`` (config, dataset with its
    GT renders, model)."""
    args = parse_args(argv)
    cfg = load_config(args.config_name, config_dir=args.config_dir,
                      overrides=args.overrides)
    device = resolve_device(args.device)
    seed = int(cfg.general.random_seed)
    t0 = time.perf_counter()
    loader = iter(Loader(get_dataset(cfg, device), int(cfg.opt.batch_size),
                         seed=seed))
    model, state = create_train_state(cfg, device=device, seed=seed)
    train_step = make_train_step(cfg, model)
    geometry_fn = make_geometry_fn(cfg, model)
    n_params = sum(p.numel() for p in model.parameters())
    _sync(device)
    setup_s = time.perf_counter() - t0
    print(f"[train] device={device} params={n_params / 1e6:.2f}M "
          f"backbone={cfg.model.backbone_type} setup {setup_s:.1f} s",
          flush=True)

    loss_log = int(cfg.logging.loss_log)
    result = {"losses": [], "psnrs": [], "grad_norms": [], "nan_skipped": [],
              "step_ms": [], "geometry_ms": [], "valid_rows": [],
              "setup_s": setup_s}
    for it in range(1, int(cfg.opt.iterations) + 1):
        batch = batch_to(next(loader), device)
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
    return result


if __name__ == "__main__":
    main()
