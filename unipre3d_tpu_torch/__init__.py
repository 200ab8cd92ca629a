"""PyTorch/CUDA port of the UniPre3D pretraining system (unipre3d_tpu).

The JAX package ``unipre3d_tpu`` stays the reference; this package imports
nothing of it and nothing of JAX. Its entry points run on the CUDA card
unless the caller asks for the CPU (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. A missing card is an error, never a silent CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or --device "
            "cpu) to run on the CPU explicitly")
    return dev
