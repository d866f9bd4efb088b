"""The kernel build cache (port of ``paddle_tpu/core/compile_cache.py``).

``PADDLE_TPU_COMPILE_CACHE=<dir>`` points every process at a shared
directory of built kernels, as it points the JAX package at a shared
cache of compiled XLA executables. In the port what is compiled is the
CUDA kernel library: ``ops/kernels/_build.py`` builds
``libpt_kernels.so`` (keyed by the digest of ``csrc/`` and the ``nvcc``
flags, in its ``.hash`` stamp) into :func:`compile_cache_dir` when the
cache is on and into ``build/kernels/`` beside the package when it is
off, and loads it from there. A directory that already holds the
library of the current digest serves it without running ``nvcc``; one
that does not gets it built there, and without ``nvcc`` that build
raises (nothing falls back).

Call sites: the engine's constructor (``ContinuousBatchingEngine.
__init__``), as in the JAX package, and the library's first load, so
the variable holds for every entry point. An explicit
``enable_compile_cache(path)`` wins over the variable; with neither,
:func:`compile_cache_dir` is None.

One process loads one copy of the library: captured CUDA graphs hold
its function pointers. Once it is loaded, a call that would move the
cache to another directory (:func:`enable_compile_cache` with another
path, or :func:`disable_compile_cache` of the directory it came from)
raises ``RuntimeError``; a call naming the directory it was loaded from
changes nothing.
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["enable_compile_cache", "disable_compile_cache",
           "compile_cache_dir", "ENV_VAR"]

ENV_VAR = "PADDLE_TPU_COMPILE_CACHE"

_enabled_dir: Optional[str] = None


def compile_cache_dir() -> Optional[str]:
    """The directory the cache was enabled with (None = off)."""
    return _enabled_dir


def _refuse_move(to: Optional[str]) -> None:
    from ..ops.kernels import _build
    loaded = _build.loaded_from()
    if loaded is not None and loaded != (to or _build.BUILD_DIR):
        raise RuntimeError(
            f"the kernel library is already loaded from {loaded!r}; one "
            f"process loads one copy (captured CUDA graphs hold its "
            f"function pointers), so the kernel cache cannot move to "
            f"{to or _build.BUILD_DIR!r} now")


def enable_compile_cache(path: Optional[str] = None) -> Optional[str]:
    """Point the kernel builds at ``path`` (default: $PADDLE_TPU_COMPILE_
    CACHE; unset or empty = no change). Returns the active cache
    directory, or None when the cache is off."""
    global _enabled_dir
    if path is None:
        path = os.environ.get(ENV_VAR, "").strip() or None
    if path is None:
        return _enabled_dir
    path = os.path.abspath(path)
    if _enabled_dir == path:
        return _enabled_dir
    _refuse_move(path)
    os.makedirs(path, exist_ok=True)
    _enabled_dir = path
    return _enabled_dir


def disable_compile_cache() -> None:
    """Send later builds back to ``build/kernels/``;
    :func:`enable_compile_cache` re-attaches."""
    global _enabled_dir
    if _enabled_dir is None:
        return
    _refuse_move(None)
    _enabled_dir = None
