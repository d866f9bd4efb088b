"""Global named-stat registry (host copy of ``paddle_tpu/core/monitor.py``:
the ``StatRegistry`` and ``GLOBAL_STATS`` that ``serving/metrics.py``
counts into)."""

from __future__ import annotations

import threading
from typing import Dict


class StatValue:
    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def add(self, delta: int = 1) -> int:
        with self._lock:
            self._value += delta
            return self._value

    def set(self, value: int) -> None:
        with self._lock:
            self._value = int(value)

    def get(self) -> int:
        with self._lock:
            return self._value

    def reset(self) -> None:
        self.set(0)


class StatRegistry:
    def __init__(self) -> None:
        self._stats: Dict[str, StatValue] = {}
        self._lock = threading.Lock()

    def get(self, name: str) -> StatValue:
        with self._lock:
            if name not in self._stats:
                self._stats[name] = StatValue(name)
            return self._stats[name]

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {k: v.get() for k, v in self._stats.items()}

    def reset_all(self) -> None:
        with self._lock:
            for v in self._stats.values():
                v.reset()


GLOBAL_STATS = StatRegistry()

