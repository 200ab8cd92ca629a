"""Batching: the collate part of unipre3d_tpu/data/loader.py.

Stacks numpy example dicts into batches in a seeded per-epoch order
(``seed + epoch``) or in order, and moves a batch to a device as float32
tensors (integer and boolean arrays keep their type). Nested dicts stack field by
field: the scene schema's ``point_cloud`` dict (``coord``, ``grid_coord``,
``feat``, ``mask``, ``min_coord``) becomes a dict of [B, ...] arrays beside
``unprojected_coords`` [B, V, H, W, 4]. The JAX loader's host sharding and
background prefetch are not ported.
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
    """Batches of ``batch_size`` examples, shuffled (order seeded by
    ``seed + epoch``) or in order; a ragged last batch is dropped unless
    ``drop_last`` is False."""

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 shuffle: bool = True, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last

    def batches_per_epoch(self) -> int:
        n, b = len(self.dataset), self.batch_size
        return n // b if self.drop_last else -(-n // b)

    def epoch(self, epoch: int = 0, start: int = 0
              ) -> Iterator[Dict[str, np.ndarray]]:
        """The epoch's batches from batch ``start`` on."""
        n = len(self.dataset)
        idx = np.random.default_rng(self.seed + epoch).permutation(n) \
            if self.shuffle else np.arange(n)
        for b in range(start, self.batches_per_epoch()):
            sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
            yield collate([self.dataset[int(i)] for i in sel])

    def iter_from(self, step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite iterator over epochs, starting after the first ``step``
        batches (a resumed run takes the batches it would have taken)."""
        epoch, start = divmod(step, self.batches_per_epoch())
        while True:
            yield from self.epoch(epoch, start)
            epoch, start = epoch + 1, 0

    def __iter__(self):
        return self.iter_from(0)
