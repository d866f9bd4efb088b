"""Random-number scopes for dropout (port of ``paddle_tpu/core/rng.py:
80-130``, ``next_key`` and ``key_scope``).

The JAX package threads a PRNG key through ``key_scope`` so that every
dropout draw inside a traced train step comes from that step's key. The
port's counterpart is a ``torch.Generator``: :func:`key_scope` makes it
the source of every :func:`next_generator` draw in this thread for the
duration, and ``jit.TrainStep`` opens one around each step, so dropout
in training never touches torch's global generators. Outside a scope
:func:`next_generator` returns None, which torch's samplers read as the
device's default generator (the JAX package's global fallback).

The scope is thread-local. Autograd runs the backward of CUDA tensors on
its own threads, so code that re-runs a forward there (the remat
recompute in ``models/gpt.py``) re-opens the scope with the generator it
captured.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional

import torch

_SCOPE = threading.local()


def next_generator() -> Optional[torch.Generator]:
    """The generator of the innermost :func:`key_scope` in this thread,
    or None (the device's default generator)."""
    return getattr(_SCOPE, "generator", None)


@contextlib.contextmanager
def key_scope(generator: Optional[torch.Generator]
              ) -> Iterator[Optional[torch.Generator]]:
    """Route :func:`next_generator` to ``generator`` in this thread
    (``None`` routes it back to the default generators)."""
    prev = getattr(_SCOPE, "generator", None)
    _SCOPE.generator = generator
    try:
        yield generator
    finally:
        _SCOPE.generator = prev
