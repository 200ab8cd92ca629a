"""Runtime helpers of the fine-tuning engine.

Port of unipre3d_tpu/utils/misc.py: ``safe_state`` seeds every random
source and wraps stdout with timestamps; ``seeded_worker`` is a loader
worker's own stream; ``to_device`` moves a (nested) batch to a device, and
``to_numpy`` brings a model's output back to the host (the evaluators and
testers read predictions through it: a CUDA tensor needs
``.detach().cpu()`` before numpy can read it).
Where JAX's ``safe_state`` returns a PRNG key, the port's returns a seeded
``torch.Generator`` on the device asked for (the CPU by default).
"""

from __future__ import annotations

import random
import sys
import time

import numpy as np
import torch

from unipre3d_tpu_torch.data.loader import batch_to


class _TimestampedStdout:
    def __init__(self, inner):
        self._inner = inner
        self._at_line_start = True

    def write(self, text):
        out = []
        for chunk in text.splitlines(keepends=True):
            if self._at_line_start and chunk.strip():
                out.append(time.strftime("[%d/%m %H:%M:%S] "))
            out.append(chunk)
            self._at_line_start = chunk.endswith("\n")
        self._inner.write("".join(out))

    def flush(self):
        self._inner.flush()

    def __getattr__(self, name):
        return getattr(self._inner, name)


def safe_state(seed: int, timestamp_stdout: bool = True,
               device="cpu") -> torch.Generator:
    """Seed ``random``, ``numpy`` and ``torch``; return a generator on
    ``device`` seeded with ``seed``; optionally wrap stdout with
    timestamps."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if timestamp_stdout and not isinstance(sys.stdout, _TimestampedStdout):
        sys.stdout = _TimestampedStdout(sys.stdout)
    return torch.Generator(device=device).manual_seed(seed)


def seeded_worker(worker_id: int, base_seed: int) -> np.random.Generator:
    """A loader worker's own random stream."""
    return np.random.default_rng(base_seed + worker_id * 1013)


def to_device(batch, device):
    """A (nested) numpy batch as tensors on ``device`` (float arrays as
    float32): ``data.loader.batch_to``."""
    return batch_to(batch, device)


def to_numpy(x):
    """A tensor (on any device, in autograd or not), or a dict of them, as
    numpy arrays; anything else through ``np.asarray``."""
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)
