"""DataLoader (port of ``paddle_tpu/io/dataloader.py``): batches are
assembled on the host by a thread pool (a process pool with
``use_process_workers=True``, whose workers start by spawn, so its
dataset must pickle), collated to numpy there, and moved to the device
in the main thread with a short prefetch.

``places=None`` means the port's default device, CUDA (raising without a
GPU); the tests pass ``places="cpu"``. A batch goes to CUDA through
pinned memory with ``non_blocking=True``, so the copy of batch k + 1
overlaps the step on batch k, as the JAX loader's asynchronous
``device_put`` does. Workers never touch CUDA. As in JAX, float64 arrays
arrive float32 and int64 arrays int32.
"""

from __future__ import annotations

import itertools
import queue
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch

from ..device import resolve_device
from .collate import default_collate_fn
from .dataset import Dataset, IterableDataset
from .sampler import BatchSampler


def _to_device(batch, device: torch.device):
    """numpy leaves of ``batch`` as tensors on ``device``; the nesting of
    lists, tuples and dicts kept."""
    if isinstance(batch, np.ndarray):
        if batch.dtype == np.float64:
            batch = batch.astype(np.float32)
        if batch.dtype == np.int64:
            batch = batch.astype(np.int32)
        t = torch.from_numpy(np.ascontiguousarray(batch))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)
    if isinstance(batch, dict):
        return {k: _to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_to_device(v, device) for v in batch)
    return batch


def _worker_initializer(counter, num_workers, dataset, worker_init_fn):
    """Pool initializer: this worker's identity for
    ``io.get_worker_info()``; ids are unique within one loader, for
    thread and process workers alike."""
    from .worker_info import WorkerInfo, _set_worker_info
    with counter.get_lock():
        wid = counter.value
        counter.value += 1
    _set_worker_info(WorkerInfo(wid, num_workers, dataset))
    if worker_init_fn is not None:
        worker_init_fn(wid)


class _Fetcher:
    """Picklable indices -> batch function for the workers. Assembly is
    the ``dataloader.fetch`` fault site, and transient failures retry by
    that site's policy; other errors propagate at once."""

    def __init__(self, dataset, collate_fn):
        self.dataset = dataset
        self.collate_fn = collate_fn

    def __call__(self, indices):
        from ..distributed.fault_inject import fault_point
        from ..distributed.resilience import get_retry_policy

        def _fetch():
            fault_point("dataloader.fetch")
            return self.collate_fn([self.dataset[i] for i in indices])

        return get_retry_policy("dataloader.fetch").call(
            _fetch, site="dataloader.fetch")


class DataLoader:
    def __init__(self, dataset: Dataset, feed_list=None, places=None,
                 return_list: bool = True, batch_sampler=None,
                 batch_size: Optional[int] = 1, shuffle: bool = False,
                 drop_last: bool = False, collate_fn: Optional[Callable]
                 = None, num_workers: int = 0, use_buffer_reader: bool = True,
                 prefetch_factor: int = 2, use_shared_memory: bool = True,
                 timeout: int = 0, worker_init_fn=None,
                 use_process_workers: bool = False):
        self.dataset = dataset
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = max(0, int(num_workers))
        self.prefetch_factor = max(1, int(prefetch_factor))
        self.use_buffer_reader = use_buffer_reader
        place = places[0] if isinstance(places, (list, tuple)) else places
        self.places = places
        self.device = resolve_device(place)
        self.worker_init_fn = worker_init_fn
        self._iterable_mode = isinstance(dataset, IterableDataset)
        self.use_process_workers = use_process_workers
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = batch_sampler.batch_size
        else:
            self.batch_sampler = BatchSampler(
                dataset=dataset, shuffle=shuffle,
                batch_size=batch_size or 1, drop_last=drop_last)
            self.batch_size = batch_size or 1

    def __len__(self):
        if self._iterable_mode:
            raise RuntimeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    def _batches_sync(self):
        if self._iterable_mode:
            it = iter(self.dataset)
            while True:
                items = list(itertools.islice(it, self.batch_size))
                if not items:
                    return
                yield self.collate_fn(items)
        else:
            fetch = _Fetcher(self.dataset, self.collate_fn)
            for indices in self.batch_sampler:
                yield fetch(indices)

    def _batches_pool(self):
        import multiprocessing as mp
        fetch = _Fetcher(self.dataset, self.collate_fn)
        # process workers start by spawn: a fork of a process that runs
        # torch's threads may copy a held lock
        ctx = mp.get_context("spawn")
        init = dict(initializer=_worker_initializer,
                    initargs=(ctx.Value("i", 0), self.num_workers,
                              self.dataset, self.worker_init_fn))
        pool = (ProcessPoolExecutor(self.num_workers, mp_context=ctx, **init)
                if self.use_process_workers else
                ThreadPoolExecutor(self.num_workers, **init))
        with pool:
            pending = queue.Queue()
            it = iter(self.batch_sampler)

            def submit_next():
                try:
                    indices = next(it)
                except StopIteration:
                    return False
                pending.put(pool.submit(fetch, indices))
                return True

            for _ in range(self.num_workers * self.prefetch_factor):
                submit_next()
            while not pending.empty():
                fut = pending.get()
                submit_next()
                yield fut.result()

    def __iter__(self):
        if self.num_workers > 0 and not self._iterable_mode:
            gen = self._batches_pool()
        else:
            gen = self._batches_sync()
        if not self.use_buffer_reader:
            for b in gen:
                yield self._finalize(_to_device(b, self.device))
            return
        # device prefetch: a few transfers in flight
        buf = []
        for b in gen:
            buf.append(_to_device(b, self.device))
            if len(buf) > self.prefetch_factor:
                yield self._finalize(buf.pop(0))
        for b in buf:
            yield self._finalize(b)

    def _finalize(self, batch):
        if self.return_list and isinstance(batch, dict):
            return list(batch.values())
        return batch
