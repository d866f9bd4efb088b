"""Trainer / device-worker runtime over datasets (port of
``paddle_tpu/framework/trainer.py``): :class:`MultiTrainer` runs N
:class:`HogwildWorker` threads, each pulling batches from its channel
and calling the trainer's step function; ``static.Executor.
train_from_dataset`` drives it.

Each step runs under the trainer's lock, as in the JAX package: one
device runs one step at a time (a ``jit.TrainStep`` updates its model's
parameters in place), while the workers overlap their host-side batch
preparation. ``DistMultiTrainer`` and ``DownpourWorker`` (the parameter
server's push / pull around each step) wait for the parameter server
(ROADMAP.md, Queue 1 item 5) and are not importable.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List

import numpy as np


class DeviceWorker:
    """Base: one worker thread bound to a dataset channel."""

    def __init__(self):
        self.metrics: Dict[str, float] = {"steps": 0, "loss_sum": 0.0}

    def bind(self, trainer, worker_id: int, channel) -> None:
        self.trainer = trainer
        self.worker_id = worker_id
        self.channel = channel

    def train_loop(self) -> None:
        raise NotImplementedError

    @property
    def avg_loss(self) -> float:
        n = max(1, int(self.metrics["steps"]))
        return self.metrics["loss_sum"] / n


class HogwildWorker(DeviceWorker):
    """Lock-free shared-state worker: pulls batches from its channel and
    calls the trainer's step function against the shared state."""

    def train_loop(self) -> None:
        for batch in self.channel:
            loss = self.trainer._run_step(batch, self.worker_id)
            self.metrics["steps"] += 1
            if loss is not None and np.ndim(loss) == 0:
                self.metrics["loss_sum"] += float(loss)


class MultiTrainer:
    """Runs N device workers over a dataset's channels.
    ``step_fn(batch, worker_id) -> loss`` (a 0-d loss is summed into the
    workers' metrics; None contributes nothing)."""

    worker_cls = HogwildWorker

    def __init__(self, step_fn: Callable[[Any, int], Any],
                 thread_num: int = 2):
        self.step_fn = step_fn
        self.thread_num = max(1, int(thread_num))
        self.workers: List[DeviceWorker] = []
        self._lock = threading.RLock()

    def _run_step(self, batch, worker_id: int):
        with self._lock:
            return self.step_fn(batch, worker_id)

    def run(self, dataset, debug: bool = False) -> Dict[str, float]:
        channels = self._channels(dataset)
        self.workers = []
        threads = []
        for i, ch in enumerate(channels):
            w = self.worker_cls()
            w.bind(self, i, ch)
            self.workers.append(w)
        errors: List[BaseException] = []

        def guarded(w):
            try:
                w.train_loop()
            except BaseException as e:  # propagate to the caller
                errors.append(e)

        for w in self.workers:
            t = threading.Thread(target=guarded, args=(w,), daemon=True)
            threads.append(t)
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        steps = sum(int(w.metrics["steps"]) for w in self.workers)
        loss_sum = sum(w.metrics["loss_sum"] for w in self.workers)
        return {"steps": steps, "avg_loss": loss_sum / max(1, steps)}

    def _channels(self, dataset) -> List[Any]:
        """One channel a worker: a dataset with ``channels(n)`` (the
        reference's in-memory dataset) is cut into batches of its
        ``batch_size`` (the last short one kept unless ``drop_last``);
        any other iterable of batches is streamed from one shared
        iterator, so its own bounded queue keeps the backpressure."""
        bs = getattr(dataset, "batch_size", 1)
        drop_last = getattr(dataset, "drop_last", False)

        def batched(samples):
            out, cur = [], []
            for s in samples:
                cur.append(s)
                if len(cur) == bs:
                    out.append(cur)
                    cur = []
            if cur and not drop_last:
                out.append(cur)
            return out

        if hasattr(dataset, "channels"):
            return [batched(c) for c in dataset.channels(self.thread_num)]
        src = iter(dataset)
        src_lock = threading.Lock()

        def shared_stream():
            while True:
                with src_lock:
                    try:
                        b = next(src)
                    except StopIteration:
                        return
                yield b

        return [shared_stream() for _ in range(self.thread_num)]


class TrainerFactory:
    """Picks the trainer class from a mode string."""

    _TRAINERS = {"MultiTrainer": MultiTrainer}

    @classmethod
    def create(cls, name: str, *args, **kwargs):
        if name not in cls._TRAINERS:
            raise KeyError(f"unknown trainer {name!r}; have "
                           f"{sorted(cls._TRAINERS)} (DistMultiTrainer "
                           f"waits for the parameter server, ROADMAP.md)")
        return cls._TRAINERS[name](*args, **kwargs)
