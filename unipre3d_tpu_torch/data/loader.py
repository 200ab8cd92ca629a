"""Batching: the collate part of unipre3d_tpu/data/loader.py.

Stacks numpy example dicts into batches in a seeded per-epoch order
(``seed + epoch``), and moves a batch to a device as float32 tensors. The
JAX loader's host sharding and background prefetch are not ported.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch


def collate(examples) -> Dict[str, np.ndarray]:
    """List of example dicts (possibly nested) -> dict of stacked arrays."""
    out = {}
    for k in examples[0]:
        if isinstance(examples[0][k], dict):
            out[k] = collate([e[k] for e in examples])
        else:
            out[k] = np.stack([e[k] for e in examples])
    return out


def batch_to(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Numpy batch -> tensors on ``device`` (float arrays as float32)."""
    def conv(a):
        t = torch.as_tensor(np.asarray(a))
        if t.is_floating_point():
            t = t.float()
        return t.to(device)
    return {k: batch_to(v, device) if isinstance(v, dict) else conv(v)
            for k, v in batch.items()}


class Loader:
    """Shuffled batches of ``batch_size`` examples (order seeded by
    ``seed + epoch``); a ragged last batch is dropped."""

    def __init__(self, dataset, batch_size: int, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        idx = np.random.default_rng(self.seed + epoch).permutation(n)
        for b in range(n // self.batch_size):
            sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
            yield collate([self.dataset[int(i)] for i in sel])

    def __iter__(self):
        """Infinite iterator over epochs."""
        epoch = 0
        while True:
            yield from self.epoch(epoch)
            epoch += 1
