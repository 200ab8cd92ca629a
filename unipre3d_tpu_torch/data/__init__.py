"""Datasets and batching of the PyTorch port (counterpart of
unipre3d_tpu/data/: the synthetic object and scene datasets and the collate
part of the loader)."""

from unipre3d_tpu_torch.data.loader import Loader, batch_to, collate
from unipre3d_tpu_torch.data.synthetic import SyntheticDataset, random_batch
from unipre3d_tpu_torch.data.synthetic_scene import SyntheticSceneDataset


def get_dataset(cfg, device=None):
    """The training set a config names. Only the synthetic datasets are
    ported (``data.dataset_root=synthetic`` for objects,
    ``data.pts_dataset_root=synthetic`` for ScanNet scenes); the ShapeNet
    and ScanNet readers are later items (ROADMAP.md queue A)."""
    root = cfg.data.get("dataset_root", cfg.data.get("pts_dataset_root"))
    if str(root) != "synthetic":
        raise NotImplementedError(
            "only the synthetic datasets are ported (data.dataset_root="
            "synthetic, or data.pts_dataset_root=synthetic for scannet); the "
            "ShapeNet and ScanNet loaders are later items of ROADMAP.md "
            "queue A")
    seed = int(cfg.general.random_seed)
    if cfg.data.category == "scannet":
        return SyntheticSceneDataset(cfg, seed=seed, device=device)
    return SyntheticDataset(cfg, seed=seed, device=device)


__all__ = ["Loader", "SyntheticDataset", "SyntheticSceneDataset", "batch_to",
           "collate", "get_dataset", "random_batch"]
