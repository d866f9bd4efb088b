"""Batch collation (port of ``paddle_tpu/io/collate.py``): samples stack
into numpy arrays, keeping tuple / list / dict structure. Collation runs
in the workers and stays numpy; the loader moves the batch to the
device in the main thread."""

from __future__ import annotations

import numbers
from collections.abc import Mapping, Sequence

import numpy as np


def default_collate_fn(batch):
    """Stack a list of samples into batched numpy arrays, preserving
    tuple/dict structure."""
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        return np.stack(batch, axis=0)
    if isinstance(sample, numbers.Number):
        return np.asarray(batch)
    if isinstance(sample, (str, bytes)):
        return batch
    if isinstance(sample, Mapping):
        return {k: default_collate_fn([d[k] for d in batch])
                for k in sample}
    if isinstance(sample, Sequence):
        transposed = list(zip(*batch))
        return [default_collate_fn(list(fields)) for fields in transposed]
    # tensor leaves
    try:
        return np.stack([s.cpu().numpy() if hasattr(s, "cpu")
                         else np.asarray(s) for s in batch], axis=0)
    except Exception:
        return batch


def default_convert_fn(batch):
    return batch
