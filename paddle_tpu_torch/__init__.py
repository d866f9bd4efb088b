"""paddle_tpu_torch: the PyTorch + CUDA port of ``paddle_tpu``.

The package mirrors ``paddle_tpu``'s module layout (``models/gpt.py``,
``inference/continuous_batching.py``, ``serving/server.py``, ...) so each
module's JAX counterpart is easy to find. It imports ``torch``, numpy
and the standard library only: never ``jax`` and nothing of
``paddle_tpu``.

The hot path runs hand-written CUDA kernels for Hopper (``csrc/*.cu``,
built with ``nvcc`` into ``build/kernels/`` at first use and bound with
``ctypes``; see ``ops/kernels/_build.py``). Each kernel has a plain
PyTorch version beside it, which a wrapper takes only for CPU tensors.
"""

from .core.flags import get_flags, set_flags
from .device import DEFAULT_DEVICE, resolve_device, setup_precision

__all__ = ["DEFAULT_DEVICE", "get_flags", "resolve_device", "set_flags",
           "setup_precision"]
