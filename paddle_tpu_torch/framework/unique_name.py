"""Unique-name generator (port of ``paddle_tpu/framework/unique_name.py``;
reference: python/paddle/fluid/unique_name.py — generate/switch/guard over
a per-scope counter stack)."""

from __future__ import annotations

import contextlib
from collections import defaultdict

__all__ = ["generate", "switch", "guard"]


class _NameGenerator:
    def __init__(self):
        self.ids: dict[str, int] = defaultdict(int)

    def __call__(self, key: str) -> str:
        n = self.ids[key]
        self.ids[key] += 1
        return f"{key}_{n}"


_generator = _NameGenerator()


def generate(key: str) -> str:
    """Return `key_N` with a process-wide increasing N per key."""
    return _generator(key)


def switch(new_generator: _NameGenerator | None = None) -> _NameGenerator:
    """Swap the active generator, returning the previous one."""
    global _generator
    old = _generator
    _generator = new_generator if new_generator is not None \
        else _NameGenerator()
    return old


@contextlib.contextmanager
def guard(new_generator: _NameGenerator | None = None):
    """Scope with a fresh (or given) name generator."""
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)
