"""Device-resident cache of the frozen VAE's conditioning features.

Port of unipre3d_tpu/training/feature_cache.py. The VAE is frozen and an
example's conditioning images never change across epochs (the rotation
augmentation turns the cloud and the cameras, not the pixels), so its
``decoder_block_3`` map per (example, view) is a function of the image
bytes alone. The cache:

* keys entries by a blake2b hash of each conditioning image's bytes,
  hashed on the host from the loader's numpy batch before it goes to the
  device (never copied back from the card);
* keeps the features in a fixed ring buffer ``[C, feat_ch, H, W]`` on the
  device (bfloat16 by default, ``dtype=`` otherwise), slots handed out
  from a free list and then evicted least recently used first; duplicate
  keys within a batch share one slot;
* on a miss runs the VAE once over the batch's distinct missing images and
  writes their features into their slots;
* optionally moves the entries it evicts into a host-RAM tier
  (``host_capacity`` slots, LRU), from which a later miss re-uploads them
  instead of running the VAE (an ``l2`` hit).

``attach`` returns the batch's features read from the buffer on a miss as
on a hit, as the JAX cache does: a step sees the same (buffer-dtype)
features whether its images were cached before or not, so a resumed run
equals an uninterrupted one bit for bit. The counters ``hits``,
``l2_hits`` and ``misses`` and the key -> slot map follow the JAX cache's
on every sequence of batches.

One departure: JAX pads each miss batch to a power-of-two bucket
(``_bucket``, ``_pad_rows``) only so that XLA compiles the extractor once
per bucket; eager torch compiles nothing, so the port runs the VAE on the
missing images as they are. The slots, the eviction order and the
counters are the same.

With a float32 buffer the features equal the live VAE's bit for bit; a
bfloat16 buffer rounds them once on insert (within 1e-2 of the live
float32 features, relative to their largest magnitude). Under the
bfloat16 compute dtype the VAE's output is bfloat16 already and the
rounding is the identity.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from unipre3d_tpu_torch import resolve_device
from unipre3d_tpu_torch.telemetry import span


def _image_key(img: np.ndarray) -> bytes:
    return hashlib.blake2b(np.ascontiguousarray(img).tobytes(),
                           digest_size=16).digest()


class DeviceVAECache:
    """LRU cache of ``decoder_block_3`` features in device memory.

    ``feature_fn``: images [N, 3, H, W] on ``device`` -> [N, channels, H,
    W] (``make_feature_fn``). ``capacity``: slots on the device (one batch
    of conditioning views at least). ``host_capacity``: slots of the host
    tier (0: none). ``device``: the buffer's (default: the card)."""

    def __init__(self, feature_fn: Callable[[torch.Tensor], torch.Tensor],
                 capacity: int, img_h: int, img_w: int, channels: int = 128,
                 dtype: torch.dtype = torch.bfloat16, host_capacity: int = 0,
                 device=None):
        self.feature_fn = feature_fn
        self.capacity = int(capacity)
        self.shape = (channels, img_h, img_w)
        self.device = resolve_device(device)
        self.buf = torch.zeros((self.capacity, *self.shape), dtype=dtype,
                               device=self.device)
        # key -> slot; the OrderedDict's order is the LRU order
        self.slots: "OrderedDict[bytes, int]" = OrderedDict()
        self.free = list(range(self.capacity - 1, -1, -1))
        self.host_capacity = int(host_capacity)
        self.host: "OrderedDict[bytes, torch.Tensor]" = OrderedDict()
        self.hits = 0
        self.l2_hits = 0
        self.misses = 0

    def _slot_for(self, key: bytes) -> Optional[int]:
        slot = self.slots.get(key)
        if slot is not None:
            self.slots.move_to_end(key)
        return slot

    def _alloc(self, key: bytes) -> Tuple[int, Optional[bytes]]:
        """Reserve a slot for ``key``; returns (slot, evicted key)."""
        evicted = None
        if self.free:
            slot = self.free.pop()
        else:
            evicted, slot = self.slots.popitem(last=False)
        self.slots[key] = slot
        return slot, evicted

    def _spill_to_host(self, pairs: List[Tuple[bytes, int]]) -> None:
        """Copy evicted entries (key, slot) to the host tier, in one
        gather and transfer, before their slots are overwritten."""
        if not pairs or not self.host_capacity:
            return
        with span("cache/spill"):
            idx = torch.tensor([s for _, s in pairs], device=self.device)
            feats = self.buf[idx].cpu()
        for (key, _), feat in zip(pairs, feats):
            self.host[key] = feat
            self.host.move_to_end(key)
        while len(self.host) > self.host_capacity:
            self.host.popitem(last=False)

    def _insert(self, slot_list: List[int], feats: torch.Tensor) -> None:
        with span("sync/cache_insert"):
            idx = torch.tensor(slot_list, device=self.device)
        self.buf[idx] = feats.to(self.device, self.buf.dtype)

    def attach(self, batch: Dict[str, np.ndarray], n_in: int
               ) -> torch.Tensor:
        """``vae_features`` [B, n_in, channels, H, W] on the device for the
        host (numpy) batch's conditioning images ``gt_images[:, :n_in]``,
        updating the cache. Under a profiler its parts are the spans
        ``cache/attach`` > ``cache/hash``, ``cache/spill``,
        ``cache/upload``, ``cache/vae`` (the true misses' images to the
        device and the extractor over them), ``cache/gather``."""
        with span("cache/attach"):
            return self._attach(batch, n_in)

    def _attach(self, batch, n_in):
        images = np.asarray(batch["gt_images"][:, :n_in])
        B, V = images.shape[:2]
        flat = images.reshape(B * V, *images.shape[2:])
        with span("cache/hash"):
            keys = [_image_key(flat[i]) for i in range(B * V)]
        slot_of = [self._slot_for(k) for k in keys]

        miss_idx = [i for i, s in enumerate(slot_of) if s is None]
        if miss_idx:
            if len(keys) > self.capacity:
                raise ValueError(
                    f"DeviceVAECache: {self.capacity} slots cannot hold one "
                    f"batch of {len(keys)} conditioning views")
            # split the misses into host-tier hits (upload) and true misses
            # (the VAE); a key repeated in the batch is materialized once
            upload_idx, compute_idx, seen = [], [], set()
            for i in miss_idx:
                if keys[i] in seen:
                    continue
                seen.add(keys[i])
                (upload_idx if keys[i] in self.host else compute_idx).append(i)
            self.l2_hits += len(upload_idx)
            self.misses += len(compute_idx)
            # take the host payloads out before spilling, so an eviction
            # cascade cannot drop one about to be promoted
            upload_feats = [self.host.pop(keys[i]) for i in upload_idx]
            spills: List[Tuple[bytes, int]] = []
            for i in upload_idx + compute_idx:
                slot, evicted = self._alloc(keys[i])
                slot_of[i] = slot
                if evicted is not None:
                    spills.append((evicted, slot))
            self._spill_to_host(spills)
            if upload_idx:
                with span("cache/upload"):
                    self._insert([slot_of[i] for i in upload_idx],
                                 torch.stack(upload_feats))
            if compute_idx:
                with span("cache/vae"):
                    with span("sync/cache_images"):
                        imgs = torch.as_tensor(flat[compute_idx]).to(
                            self.device)
                    self._insert([slot_of[i] for i in compute_idx],
                                 self.feature_fn(imgs))
            # duplicate keys within the batch take the first one's slot
            for i in miss_idx:
                if slot_of[i] is None:
                    slot_of[i] = self.slots[keys[i]]
        self.hits += len(keys) - len(miss_idx)
        with span("cache/gather"):
            with span("sync/cache_gather"):
                idx = torch.tensor(slot_of, device=self.device)
            out = self.buf[idx]
        return out.reshape(B, V, *self.shape)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.l2_hits + self.misses
        return (self.hits + self.l2_hits) / total if total else 0.0

    @property
    def nbytes(self) -> int:
        """Bytes of the device buffer."""
        return self.buf.numel() * self.buf.element_size()


def make_feature_fn(model) -> Callable[[torch.Tensor], torch.Tensor]:
    """The frozen VAE of a ``GaussianSplatPredictor`` as the cache's
    extractor: images [N, 3, H, W] -> ``decoder_block_3`` [N, feat_ch, H,
    W], no gradient, in the model's compute dtype."""
    return model.extract_vae_features
