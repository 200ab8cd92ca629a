"""Datasets and batching of the PyTorch port (counterpart of
unipre3d_tpu/data/): the synthetic object and scene datasets, the ShapeNet
and ScanNet readers with their transforms, the dataset factory and the
prefetching loader."""

from unipre3d_tpu_torch.data.dataset_factory import get_dataset
from unipre3d_tpu_torch.data.draws import Draws, example_draws
from unipre3d_tpu_torch.data.loader import Loader, batch_to, collate
from unipre3d_tpu_torch.data.synthetic import SyntheticDataset, random_batch
from unipre3d_tpu_torch.data.synthetic_scene import SyntheticSceneDataset

__all__ = ["Draws", "Loader", "SyntheticDataset", "SyntheticSceneDataset",
           "batch_to", "collate", "example_draws", "get_dataset",
           "random_batch"]
