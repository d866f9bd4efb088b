"""paddle_tpu_torch.io — datasets, samplers, DataLoader (port of
``paddle_tpu/io/``; the parameter server's ``heavy_dataset.py`` is not
ported yet, see ROADMAP.md)."""

from .collate import default_collate_fn
from .dataloader import DataLoader
from .worker_info import WorkerInfo, get_worker_info
from .dataset import (ChainDataset, ComposeDataset, ConcatDataset, Dataset,
                      IterableDataset, Subset, TensorDataset, random_split)
from .sampler import (BatchSampler, DistributedBatchSampler, RandomSampler,
                      Sampler, SequenceSampler, WeightedRandomSampler)

__all__ = ["BatchSampler", "ChainDataset", "ComposeDataset",
           "ConcatDataset", "DataLoader", "Dataset",
           "DistributedBatchSampler", "IterableDataset", "RandomSampler",
           "Sampler", "SequenceSampler", "Subset", "TensorDataset",
           "WeightedRandomSampler", "WorkerInfo", "default_collate_fn",
           "get_worker_info", "random_split"]
