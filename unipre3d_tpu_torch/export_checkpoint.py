"""Export a pretraining run of the port to a PyTorch ``.pth`` for the
downstream fine-tune repos.

    python -m unipre3d_tpu_torch.export_checkpoint <experiment_path> \
        [--out backbone.pth] [--ckpt model_latest.ckpt] [--no-ema] [--full]

Counterpart of the repository's ``export_checkpoint.py``: reads the run's
composed config (``<experiment_path>/.hydra/config.yaml``) and its ``.npz``
checkpoint (training/checkpoint.py), and writes
``{"model_state_dict": ..., "iteration", "backbone"}``
(``<experiment_path>/model_torch_export.pth`` by default) under the
reference's names (export/``export_predictor``). The EMA weights by
default: the checkpoint's ``ema/`` group holds the trainable parameters
only, so the frozen VAE and the BatchNorm statistics come from ``model/``,
as the JAX export takes them from ``params`` and ``batch_stats``.
``--no-ema`` exports the raw parameters; ``--full`` the generic flattened
state dict of any backbone. Pure data conversion: no device, no dataset.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Tuple

import numpy as np
import yaml

from unipre3d_tpu_torch.export import export_predictor, save_torch_checkpoint


def checkpoint_state_dict(path: str, ema: bool = True
                          ) -> Tuple[Dict[str, np.ndarray], int]:
    """The model's ``state_dict`` held by a checkpoint, with the EMA of
    the trainable parameters in place of their raw values when ``ema``,
    and its step."""
    with np.load(path, allow_pickle=False) as z:
        sd = {k[len("model/"):]: z[k] for k in z.files
              if k.startswith("model/")}
        if ema:
            sd.update({k[len("ema/"):]: z[k] for k in z.files
                       if k.startswith("ema/")})
        return sd, int(z["step"])


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("experiment_path")
    p.add_argument("--out", default=None)
    p.add_argument("--ckpt", default="model_latest.ckpt")
    p.add_argument("--no-ema", action="store_true",
                   help="export raw params instead of the EMA weights")
    p.add_argument("--full", action="store_true",
                   help="generic flattened export (any backbone)")
    return p.parse_args(argv)


def main(argv=None) -> str:
    """Write the export; returns its path."""
    args = parse_args(argv)
    with open(os.path.join(args.experiment_path, ".hydra",
                           "config.yaml")) as f:
        backbone = yaml.safe_load(f)["model"]["backbone_type"]
    sd, step = checkpoint_state_dict(
        os.path.join(args.experiment_path, args.ckpt), ema=not args.no_ema)
    sd = export_predictor(sd, backbone, args.full)
    out = args.out or os.path.join(args.experiment_path,
                                   "model_torch_export.pth")
    save_torch_checkpoint(out, sd, extra={"iteration": step,
                                          "backbone": backbone})
    print(f"[export] wrote {out} ({len(sd)} tensors, step {step}, "
          f"ema={not args.no_ema})", flush=True)
    return out


if __name__ == "__main__":
    main()
