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
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from unipre3d_tpu_torch.training.trainer import TrainState, split_frozen


def save_checkpoint(path: str, model, state: TrainState,
                    best_psnr: float = 0.0) -> None:
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
