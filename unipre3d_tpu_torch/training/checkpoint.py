"""Checkpoint save and load, with an exact resume.

Counterpart of unipre3d_tpu/training/checkpoint.py: one ``.npz`` of
flat, ``/``-joined keys, written under a private name and renamed, so a
reader never sees half a file. It holds the port's own state:

* ``model/<name>``: the model's ``state_dict`` (parameters, the frozen VAE
  included, and buffers such as BatchNorm running stats);
* ``ema/<name>``: the EMA of the trainable parameters;
* ``adam_mu/<name>``, ``adam_nu/<name>``, ``adam_count``: AdamW's moments
  and its update count (the StepLR schedule's step too);
* ``step``, ``best_psnr`` and ``generator`` (the DropPath generator's
  state).

With the data loader restarted at the step (``Loader.iter_from``), a
resumed run takes the same batches, DropPath draws and updates as one that
never stopped.

The fine-tuning engine's checkpoint (``save_finetune_checkpoint``,
``load_finetune_checkpoint``; training/hooks.py) is a second layout of the
same ``.npz`` format. JAX's ``save_checkpoint`` flattens whatever optax
state its ``TrainState`` holds; the port's holds:

* ``model/<name>``: the model's ``state_dict``;
* ``opt/<key>``: the factory optimizer's whole state
  (training/optim_factory.py: SGD's momentum buffers, Adam's or lamb's
  moments, Adafactor's factored rows and columns, every count);
* ``step``, ``best_metric`` and, when the state has one, ``generator``.

Loading restores them bit for bit, each tensor onto the device of the
state it replaces.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from unipre3d_tpu_torch.parallel.mesh import is_model_shard
from unipre3d_tpu_torch.training.trainer import TrainState, split_frozen


def save_checkpoint(path: str, model, state: TrainState,
                    best_psnr: float = 0.0) -> None:
    """Write the state of ``model`` and ``state``. A model split over a
    model group (parallel/mesh.py) holds parts of its tensors: it raises
    (``mesh.gathered_state_dict`` joins them)."""
    if any(is_model_shard(p) for p in model.parameters()):
        raise ValueError("save_checkpoint: the model is split over a model "
                         "group; gather it first (gathered_state_dict)")
    names = [n for n, _ in split_frozen(model)[0]]
    flat = {f"model/{k}": v for k, v in model.state_dict().items()}
    flat.update({f"ema/{k}": v for k, v in state.ema.items()})
    for key, moments in (("adam_mu", state.optimizer.mu),
                         ("adam_nu", state.optimizer.nu)):
        flat.update({f"{key}/{n}": m for n, m in zip(names, moments)})
    flat = {k: v.detach().cpu().numpy() for k, v in flat.items()}
    flat.update(adam_count=np.asarray(state.optimizer.count),
                step=np.asarray(state.step),
                best_psnr=np.asarray(best_psnr),
                generator=state.generator.get_state().numpy())
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def load_checkpoint(path: str, model, state: TrainState
                    ) -> Tuple[TrainState, float]:
    """Restore a checkpoint onto ``model`` and ``state`` in place (every
    tensor keeps its device); returns (state, best_psnr)."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}

    def group(prefix):
        return {k[len(prefix) + 1:]: torch.from_numpy(v)
                for k, v in flat.items() if k.startswith(prefix + "/")}

    model.load_state_dict(group("model"))
    names = [n for n, _ in split_frozen(model)[0]]
    ema = group("ema")
    with torch.no_grad():
        for n in names:
            state.ema[n].copy_(ema[n])
        for key, moments in (("adam_mu", state.optimizer.mu),
                             ("adam_nu", state.optimizer.nu)):
            saved = group(key)
            for n, m in zip(names, moments):
                m.copy_(saved[n])
    state.optimizer.count = int(flat["adam_count"])
    state.step = int(flat["step"])
    state.generator.set_state(torch.from_numpy(flat["generator"]))
    return state, float(flat["best_psnr"])


def save_finetune_checkpoint(path: str, state, best_metric: float = 0.0
                             ) -> None:
    """Write a fine-tune state (training/hooks.py:FinetuneState)."""
    flat = {f"model/{k}": v.detach().cpu().numpy()
            for k, v in state.model.state_dict().items()}
    flat.update({f"opt/{k}": v.detach().cpu().numpy() if torch.is_tensor(v)
                 else np.asarray(v) for k, v in state.opt_state.items()})
    flat.update(step=np.asarray(state.step),
                best_metric=np.asarray(best_metric))
    if state.generator is not None:
        flat["generator"] = state.generator.get_state().numpy()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def load_finetune_checkpoint(path: str, state):
    """Restore a fine-tune checkpoint onto ``state`` in place (its model,
    optimizer state, step and generator); returns (state, best_metric)."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    state.model.load_state_dict({k[6:]: torch.from_numpy(v)
                                 for k, v in flat.items()
                                 if k.startswith("model/")})
    opt = {}
    for k, old in state.opt_state.items():
        v = flat[f"opt/{k}"]
        opt[k] = torch.from_numpy(v).to(old.device) if torch.is_tensor(old) \
            else type(old)(v)
    state.opt_state = opt
    state.step = int(flat["step"])
    if state.generator is not None:
        state.generator.set_state(torch.from_numpy(flat["generator"]))
    return state, float(flat["best_metric"])
