"""Dataset dispatch: port of unipre3d_tpu/data/dataset_factory.py.

``synthetic`` as the root selects the procedural datasets; a ShapeNet
(``data.dataset_root``) or ScanNet (``data.pts_dataset_root``) root that is
a directory selects the real reader. Held difference: where JAX falls back
to the synthetic dataset when the root is not a directory, the port raises,
so that a mistyped path never trains on synthetic data.
"""

from __future__ import annotations

import os

from unipre3d_tpu_torch.data.synthetic import SyntheticDataset
from unipre3d_tpu_torch.data.synthetic_scene import SyntheticSceneDataset


def get_dataset(cfg, split: str = "train", device=None):
    """The ``train``, ``val`` or ``test`` split of the dataset a config
    names; the synthetic datasets render their GT views, and the ShapeNet
    reader runs its FPS, on ``device``."""
    category = cfg.data.category
    root = cfg.data.get("dataset_root", cfg.data.get("pts_dataset_root"))
    if str(root) == "synthetic":
        seed = int(cfg.general.random_seed)
        if category == "scannet":
            return SyntheticSceneDataset(cfg, split, seed=seed, device=device)
        return SyntheticDataset(cfg, split, seed=seed, device=device)
    if not (root and os.path.isdir(str(root))):
        raise FileNotFoundError(
            f"dataset root {root!r} is not a directory (data.dataset_root for "
            "ShapeNet, data.pts_dataset_root for ScanNet; 'synthetic' for "
            "the procedural datasets)")
    if category == "shapenet":
        from unipre3d_tpu_torch.data.shapenet import ShapeNetDataset
        return ShapeNetDataset(cfg, split, device=device)
    if category == "scannet":
        from unipre3d_tpu_torch.data.scannet import ScanNetDataset
        return ScanNetDataset(cfg, split, device=device)
    raise ValueError(f"unknown dataset category: {category}")
