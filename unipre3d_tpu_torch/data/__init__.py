"""Datasets and batching of the PyTorch port (counterpart of
unipre3d_tpu/data/: the synthetic object dataset and the collate part of
the loader)."""

from unipre3d_tpu_torch.data.loader import Loader, batch_to, collate
from unipre3d_tpu_torch.data.synthetic import SyntheticDataset, random_batch


def get_dataset(cfg, device=None):
    """The training set a config names. Only ``data.dataset_root=synthetic``
    is ported; the ShapeNet reader is a later item (ROADMAP.md queue A)."""
    if str(cfg.data.get("dataset_root")) != "synthetic":
        raise NotImplementedError(
            "only data.dataset_root=synthetic is ported (the ShapeNet loader "
            "is a later item of ROADMAP.md queue A)")
    return SyntheticDataset(cfg, seed=int(cfg.general.random_seed),
                            device=device)


__all__ = ["Loader", "SyntheticDataset", "batch_to", "collate",
           "get_dataset", "random_batch"]
