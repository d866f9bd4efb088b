"""Datasets (port of ``paddle_tpu/io/dataset.py``): ``Dataset``,
``IterableDataset``, ``TensorDataset``, ``ComposeDataset``,
``ChainDataset``, ``ConcatDataset``, ``Subset`` and ``random_split``.
Samples are host data (numpy); ``random_split`` draws from
``np.random.default_rng(generator)``, so a seed splits as in JAX."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError(
            f"{type(self).__name__} must implement __getitem__")

    def __len__(self):
        raise NotImplementedError(
            f"{type(self).__name__} must implement __len__")


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError(
            f"{type(self).__name__} must implement __iter__")

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors: Sequence):
        arrays = [t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)
                  for t in tensors]
        n = arrays[0].shape[0]
        assert all(a.shape[0] == n for a in arrays), \
            "all tensors must share dim 0"
        self.tensors = arrays

    def __getitem__(self, idx):
        return tuple(a[idx] for a in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets: Sequence[Dataset]):
        self.datasets = list(datasets)
        n = len(self.datasets[0])
        assert all(len(d) == n for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, tuple) else (item,))
        return tuple(out)

    def __len__(self):
        return len(self.datasets[0])


class ChainDataset(IterableDataset):
    def __init__(self, datasets: Sequence[IterableDataset]):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets: Sequence[Dataset]):
        self.datasets = list(datasets)
        self._cum = np.cumsum([len(d) for d in self.datasets])

    def __len__(self):
        return int(self._cum[-1])

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = int(np.searchsorted(self._cum, idx, side="right"))
        prev = 0 if ds_idx == 0 else int(self._cum[ds_idx - 1])
        return self.datasets[ds_idx][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset: Dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset: Dataset, lengths: Sequence[int], generator=None
                 ) -> List[Subset]:
    total = sum(lengths)
    assert total == len(dataset), "lengths must sum to dataset size"
    rng = np.random.default_rng(generator)
    perm = rng.permutation(total)
    out, offset = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[offset:offset + n].tolist()))
        offset += n
    return out
