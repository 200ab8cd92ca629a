"""Batching with background prefetch: port of unipre3d_tpu/data/loader.py.

Stacks numpy example dicts into batches in a seeded per-epoch order
(``seed + epoch``) or in order, and moves a batch to a device as float32
tensors (integer and boolean arrays keep their type). Nested dicts stack
field by field: the scene schema's ``point_cloud`` dict (``coord``,
``grid_coord``, ``feat``, ``mask``, ``min_coord``) becomes a dict of
[B, ...] arrays beside ``unprojected_coords`` [B, V, H, W, 4].

As in JAX, ``iter_from`` reads ahead on a background thread into a
bounded queue of ``prefetch`` batches, each batch's examples read by a
pool of ``num_workers`` threads; a resumed run skips the batches it has
taken by their indices alone and then yields what an uninterrupted run
would. A reader with random draws (``takes_draws``: the ShapeNet and
ScanNet readers) reads each example with the draws of its (seed, epoch,
position in the epoch) (data/draws.py), so a batch does not depend on
which thread read which example; the JAX readers' global draws do. The
synthetic datasets seed their own draws by index. A ``collate_hook``
(``hook(examples, rng) -> examples``, e.g. ``transforms.make_mix3d_collate``)
runs on each batch's examples before they are stacked, with the batch's
own generator (``draws.batch_rng`` of (seed, epoch, batch index)): JAX's
hook carries one generator from batch to batch, so its draws depend on
how many batches were read before; the port's do not, and a resumed run
mixes as an uninterrupted one.

Under several processes each rank reads its shard (``shard_id``,
``num_shards``), with JAX's index rule: the epoch's order, resized
(``np.resize``, repeating its head) to a multiple of ``num_shards`` with
``pad_shards`` (training and the CLI's validation: every rank takes as many
batches), or as it is without (standalone eval: no example scored twice),
then every ``num_shards``-th entry from ``shard_id``. An example's draws are
keyed by its position in the unsharded (padded) order, so the ranks' batch
``b`` together hold exactly the one-process loader's batch ``b`` of the
global batch size, draws included; the collate hook's generator differs by
shard.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np
import torch

from unipre3d_tpu_torch.data.draws import batch_rng, example_draws
from unipre3d_tpu_torch.telemetry import count, span


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
    """Numpy batch -> tensors on ``device`` (float arrays as float32), in
    the span ``data/batch_to``, counting the bytes moved as
    ``h2d_bytes``."""
    moved = []

    def conv(a):
        t = torch.as_tensor(np.asarray(a))
        if t.is_floating_point():
            t = t.float()
        moved.append(t.nbytes)
        # a pageable copy: the host waits for it
        with span("sync/batch_to"):
            return t.to(device)

    def walk(b):
        return {k: walk(v) if isinstance(v, dict) else conv(v)
                for k, v in b.items()}

    with span("data/batch_to"):
        out = walk(batch)
        count("h2d_bytes", sum(moved))
    return out


class Loader:
    """Batches of ``batch_size`` examples of shard ``shard_id`` of
    ``num_shards`` (the whole dataset by default), shuffled (order seeded
    by ``seed + epoch``) or in order; a ragged last batch is dropped unless
    ``drop_last`` is False; ``collate_hook(examples, rng)`` runs on each
    batch's examples before stacking."""

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 shuffle: bool = True, drop_last: bool = True,
                 prefetch: int = 2, num_workers: int = 4,
                 collate_hook=None, shard_id: int = 0, num_shards: int = 1,
                 pad_shards: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = max(1, prefetch)
        self.num_workers = max(1, num_workers)
        self.collate_hook = collate_hook
        self.shard_id, self.num_shards = shard_id, num_shards
        self.pad_shards = pad_shards
        self._pool = None

    def _shard_len(self) -> int:
        n, s = len(self.dataset), self.num_shards
        return -(-n // s) if self.pad_shards else len(
            range(self.shard_id, n, s))

    def batches_per_epoch(self) -> int:
        """Batches of this shard in an epoch."""
        n, b = self._shard_len(), self.batch_size
        return n // b if self.drop_last else -(-n // b)

    def _example(self, index: int, epoch: int, position: int):
        if getattr(self.dataset, "takes_draws", False):
            return self.dataset.get(
                index, example_draws(self.seed, epoch, position))
        return self.dataset[index]

    def _fetch(self, epoch: int, idx: np.ndarray, b: int
               ) -> Dict[str, np.ndarray]:
        """Batch ``b`` of the epoch whose example order is ``idx``."""
        first = b * self.batch_size
        # draws keyed by the position in the unsharded order
        jobs = [(int(i), epoch, self.shard_id + self.num_shards * (first + j))
                for j, i in enumerate(idx[first:first + self.batch_size])]
        if self.num_workers > 1 and len(jobs) > 1:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(self.num_workers)
            examples = list(self._pool.map(lambda a: self._example(*a), jobs))
        else:
            examples = [self._example(*a) for a in jobs]
        if self.collate_hook is not None:
            examples = self.collate_hook(
                examples, batch_rng(self.seed, epoch, b, self.shard_id))
        return collate(examples)

    def _order(self, epoch: int) -> np.ndarray:
        """This shard's example indices in epoch ``epoch`` (JAX's
        ``Loader._epoch_indices``)."""
        n = len(self.dataset)
        idx = np.random.default_rng(self.seed + epoch).permutation(n) \
            if self.shuffle else np.arange(n)
        if self.pad_shards:
            idx = np.resize(idx, -(-n // self.num_shards) * self.num_shards)
        return idx[self.shard_id::self.num_shards]

    def epoch(self, epoch: int = 0, start: int = 0
              ) -> Iterator[Dict[str, np.ndarray]]:
        """The epoch's batches from batch ``start`` on, read in the calling
        thread (its examples by the pool)."""
        idx = self._order(epoch)
        for b in range(start, self.batches_per_epoch()):
            yield self._fetch(epoch, idx, b)

    def iter_from(self, step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite iterator over epochs, starting after the first ``step``
        batches (skipped by index: a resumed run takes the batches it would
        have taken), read ahead on a background thread. A reading error
        is raised where the batch is taken; closing the iterator stops the
        thread."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        epoch0, start0 = divmod(step, max(1, self.batches_per_epoch()))

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            epoch, start = epoch0, start0
            try:
                if self.batches_per_epoch() == 0:
                    raise ValueError(f"{len(self.dataset)} examples make no "
                                     f"batch of {self.batch_size}")
                while True:
                    idx = self._order(epoch)
                    for b in range(start, self.batches_per_epoch()):
                        if not put(self._fetch(epoch, idx, b)):
                            return
                    epoch, start = epoch + 1, 0
            except Exception as e:   # handed to the consumer
                put(e)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                with span("data/wait"):
                    item = q.get()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()

    def __iter__(self):
        return self.iter_from(0)

    def close(self) -> None:
        """Stop the example-reading pool (a loader reads again after it,
        with a new pool)."""
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None
