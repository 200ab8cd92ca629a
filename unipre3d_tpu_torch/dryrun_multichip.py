"""Multi-process dry run of the port: a tensor-parallel transformer step on a
``(data, model)`` grid, then a data-parallel SparseUNet scene step.

    UNIPRE3D_COORDINATOR=127.0.0.1:PORT UNIPRE3D_NUM_PROCESSES=4 \
        UNIPRE3D_PROCESS_ID=i python -m unipre3d_tpu_torch.dryrun_multichip \
        [--device cpu]
    torchrun --nproc-per-node 4 -m unipre3d_tpu_torch.dryrun_multichip

Counterpart of ``__graft_entry__.dryrun_multichip``. Every process of the
launch (parallel/distributed.py) runs it; with a world of 4 or more that 2
divides it folds the ranks into a grid of 2 model ranks (JAX's
``model_parallel = 2``), else the 1-D data grid, calls
``replicate(require_tp_match=True)`` and runs one step of the small
transformer (tiny VAE, 4 blocks, 32 px, one example a data rank), printing
its loss and PSNR; then one step of the small SparseUNet scene
configuration of JAX's ``_dryrun_scene`` on the data-parallel grid. It runs
on the card unless ``--device`` names another device.

``run_steps`` is the step loop behind it, which chip_smoke.py and the tests
drive too: the train steps of a config on a grid, each rank on its data
rank's shard of the global batch (the loader's ``shard_id`` = data rank,
``num_shards`` = D), with the model-group all-reduces counted and timed.
"""

from __future__ import annotations

import argparse
import hashlib
import time

import numpy as np
import torch

from unipre3d_tpu_torch.data import Loader, batch_to, get_dataset
from unipre3d_tpu_torch.parallel import distributed as dist_lib
from unipre3d_tpu_torch.parallel.mesh import (gathered_state_dict,
                                              is_model_shard, make_mesh,
                                              replicate)
from unipre3d_tpu_torch.parallel.tensor import MODEL_COMM
from unipre3d_tpu_torch.train_network import make_cache
from unipre3d_tpu_torch.training.config import load_config
from unipre3d_tpu_torch.training.trainer import (compute_dtype_of,
                                                 create_train_state,
                                                 make_geometry_fn,
                                                 make_train_step,
                                                 split_frozen)

TINY_VAE = ("model.vae_overrides={block_out_channels: [32, 32, 32, 32], "
            "layers_per_block: 1}")


def rows(batch, lo: int, hi: int):
    """Rows [lo, hi) of every array of a (nested) host batch."""
    return {k: rows(v, lo, hi) if isinstance(v, dict) else v[lo:hi]
            for k, v in batch.items()}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_steps(cfg, model_parallel: int = 1, steps: int = 1, device=None,
              batches=None, state_dict=None, keep_params: bool = False
              ) -> dict:
    """``steps`` train steps of ``cfg`` on a grid of ``model_parallel``
    model ranks over this process's world (one process: the plain run):
    the body of JAX's ``dryrun_multichip``, with its mesh, ``replicate``
    and jitted step.

    The global batch is ``opt.batch_size`` examples, D = world /
    ``model_parallel`` data ranks of ``batch_size / D``; each rank reads
    its data rank's shard from the config's train split (the loader's
    ``shard_id`` and ``num_shards``), or, given ``batches`` (host global
    batches, one a step), takes its data rank's rows of each. The model
    computes in ``tpu.compute_dtype`` from ``general.random_seed``'s init
    (or ``state_dict``), broadcast and split by
    ``replicate(require_tp_match=True)``; the VAE feature
    cache of ``tpu.vae_cache_entries`` attaches each batch's features as in
    the CLI (each rank its own); scene configs build their geometry before
    the step.

    Returns the per-step ``losses``, ``psnrs``, ``grad_norms``,
    ``nan_skipped``, ``step_ms`` (host clock around the synchronized step),
    ``model_allreduces`` and ``model_allreduce_ms`` (the model group's
    all-reduces a step and their time by CUDA events, parallel/tensor.py),
    ``reduce_ms`` (the data group's gradient all-reduce) and ``grid``; on a
    card ``peak_gib``; on a grid with a model axis ``replicated_sha1``, a
    digest of the replicated trainable parameters after the last step
    (every rank's must be the same); with ``keep_params`` the trainable
    parameters after the last step, whole (gathered over the model
    group), as numpy."""
    dev = make_mesh(device, model_parallel=model_parallel)
    g = dist_lib.grid()
    D = g.data_count
    batch_size = int(cfg.opt.batch_size)
    if batch_size % D:
        raise ValueError(f"global batch {batch_size} does not split over "
                         f"{D} data ranks")
    local = batch_size // D
    seed = int(cfg.general.random_seed)
    model, state = create_train_state(cfg, device=dev, seed=seed,
                                      state_dict=state_dict,
                                      dtype=compute_dtype_of(cfg))
    replicate(model, state, require_tp_match=True)
    if batches is None:
        loader = Loader(get_dataset(cfg, "train", dev), local, seed=seed,
                        shard_id=g.data_index, num_shards=D)
        it = loader.iter_from(0)
        batches = [next(it) for _ in range(steps)]
        it.close()
        loader.close()
    else:
        batches = [rows(b, g.data_index * local, (g.data_index + 1) * local)
                   for b in batches[:steps]]
    feature_cache = make_cache(cfg, model, dev)
    n_in = int(cfg.data.input_images)
    step = make_train_step(cfg, model)
    geometry_fn = make_geometry_fn(cfg, model)
    out = {k: [] for k in ("losses", "psnrs", "grad_norms", "nan_skipped",
                           "step_ms", "model_allreduces",
                           "model_allreduce_ms", "reduce_ms")}
    out["grid"] = {"data": D, "model": g.model_count,
                   "data_index": g.data_index, "model_index": g.model_index}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    MODEL_COMM.timed = True
    try:
        for host in batches:
            batch = batch_to(host, dev)
            if feature_cache is not None:
                batch["vae_features"] = feature_cache.attach(host, n_in)
            if geometry_fn is not None:
                batch["geometry"] = geometry_fn(batch)
            _sync(dev)
            MODEL_COMM.reset()
            t = time.perf_counter()
            m = step(state, batch)
            _sync(dev)
            out["step_ms"].append((time.perf_counter() - t) * 1e3)
            out["model_allreduces"].append(MODEL_COMM.count)
            out["model_allreduce_ms"].append(MODEL_COMM.ms())
            for k, key in (("losses", "loss"), ("psnrs", "psnr"),
                           ("grad_norms", "grad_norm"),
                           ("nan_skipped", "nan_skipped"),
                           ("reduce_ms", "reduce_ms")):
                if key in m:
                    out[k].append(m[key])
    finally:
        MODEL_COMM.timed = False
        MODEL_COMM.reset()
    if dev.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    trainable = split_frozen(model)[0]
    if g.model_count > 1:
        digest = hashlib.sha1()
        for _, p in trainable:
            if not is_model_shard(p):
                digest.update(p.detach().cpu().numpy().tobytes())
        out["replicated_sha1"] = digest.hexdigest()
    if keep_params:
        sd = gathered_state_dict(model)
        out["params"] = {n: sd[n].detach().cpu().numpy()
                         for n, _ in trainable}
    return out


def tiny_object_config(batch: int):
    """JAX's ``_tiny_cfg(batch=, tiny_vae=True)``: 32 px, the tiny VAE, 4
    blocks."""
    return load_config("transformer_pretraining", overrides=[
        "data.training_resolution=32", f"opt.batch_size={batch}",
        "data.dataset_root=synthetic", "tpu.raster_tile_capacity=128",
        "opt.ema.update_after_step=1", TINY_VAE,
        "model.backbone_overrides={depth: 4}"])


def tiny_scene_config(batch: int):
    """JAX's ``_dryrun_scene`` configuration: 2 stages of one block of 16
    channels, 256 points, the tiled renderer."""
    return load_config("sparseunet_pretraining", overrides=[
        f"opt.batch_size={batch}", "data.pts_dataset_root=synthetic",
        "data.training_width=32", "data.training_height=32",
        "data.input_images=2", "data.max_points=256",
        "model.backbone_overrides={channels: [16, 16, 16, 16], "
        "layers: [1, 1, 1, 1], pixel_capacity: 256}", TINY_VAE,
        "tpu.raster_tile_capacity=128", "tpu.raster_impl_train=xla",
        "opt.ema.update_after_step=1"])


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; a missing card is an "
                        "error)")
    args = p.parse_args(argv)
    dist_lib.maybe_initialize(device=args.device)
    n = dist_lib.process_count()
    model_parallel = 2 if n % 2 == 0 and n >= 4 else 1
    n_data = n // model_parallel
    res = run_steps(tiny_object_config(n_data), model_parallel,
                    device=args.device)
    loss, psnr = res["losses"][0], res["psnrs"][0]
    if not (np.isfinite(loss) and np.isfinite(psnr)):
        raise RuntimeError(f"dryrun: non-finite loss {loss} or PSNR {psnr}")
    rank = dist_lib.process_index()
    if rank == 0:
        print(f"dryrun_multichip({n}): mesh={{'data': {n_data}, 'model': "
              f"{model_parallel}}} loss={loss:.4f} psnr={psnr:.2f} "
              f"model all-reduces={res['model_allreduces'][0]} OK",
              flush=True)
    scene = run_steps(tiny_scene_config(n), 1, device=args.device)
    if not np.isfinite(scene["losses"][0]):
        raise RuntimeError("scene dryrun produced a non-finite loss")
    if rank == 0:
        print(f"dryrun_multichip scene({n}): mesh=DPx{n} "
              f"loss={scene['losses'][0]:.4f} OK", flush=True)
    return {"object": res, "scene": scene}


if __name__ == "__main__":
    try:
        main()
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
