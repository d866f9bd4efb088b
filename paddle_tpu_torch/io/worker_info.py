"""DataLoader worker identity (port of ``paddle_tpu/io/worker_info.py``).

Worker state is thread-local (thread-pool workers) or process-global
(process-pool workers — one worker per process), assigned by the pool
initializer in io.dataloader.
"""

from __future__ import annotations

import threading
from typing import Any, Optional


class WorkerInfo:
    __slots__ = ("id", "num_workers", "dataset", "seed")

    def __init__(self, id: int, num_workers: int,  # noqa: A002
                 dataset: Any = None, seed: int = 0):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset
        self.seed = seed

    def __repr__(self):
        return (f"WorkerInfo(id={self.id}, num_workers={self.num_workers}, "
                f"seed={self.seed})")


_tls = threading.local()


def get_worker_info() -> Optional[WorkerInfo]:
    """Inside a DataLoader worker: that worker's WorkerInfo; in the main
    process/thread: None (reference: paddle.io.get_worker_info)."""
    return getattr(_tls, "info", None)


def _set_worker_info(info: Optional[WorkerInfo]) -> None:
    _tls.info = info
