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

``import paddle_tpu_torch as paddle`` gives the reference's dygraph
surface (``paddle.to_tensor``, the op library, ``paddle.grad``,
``paddle.nn.Layer``, ...; ``_api.py``), loaded on the first read of one
of its names so that importing the package stays light. Tensors live on
the card unless ``paddle.set_device("cpu")`` says otherwise.
Subpackages load on first use; those not ported yet raise
``NotImplementedError`` naming ROADMAP.md.
"""

import importlib as _importlib

from .core.flags import get_flags, set_flags
from .device import DEFAULT_DEVICE, resolve_device, setup_precision

__version__ = "0.1.0"

_SUBPACKAGES = ("nn", "optimizer", "amp", "io", "static", "jit",
                "distributed", "metric", "vision", "models", "hapi",
                "framework", "inference", "serving", "autograd", "ops",
                "quantization", "sparsity", "regularizer", "device", "core",
                "dispatch", "tensor", "linalg", "fft", "profiler", "utils",
                "sysconfig", "distribution", "incubate", "text", "hub",
                "onnx")

# the JAX package's subpackages that wait for ROADMAP.md's Queue 1
_NOT_PORTED = {"native": "paddle_tpu/native.py"}


def _eager():
    return _importlib.import_module("._api", __name__)


def __getattr__(name):
    if name.startswith("_"):
        raise AttributeError(
            f"module 'paddle_tpu_torch' has no attribute {name!r}")
    if name in _SUBPACKAGES:
        return _importlib.import_module(f".{name}", __name__)
    if name in _NOT_PORTED:
        from ._not_ported import NotPorted
        return NotPorted(name, _NOT_PORTED[name])
    if name == "ParamAttr":
        from .nn.initializer import ParamAttr
        return ParamAttr
    api = _eager()
    if name in api.EAGER_NAMES:
        return getattr(api, name)
    raise AttributeError(
        f"module 'paddle_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_SUBPACKAGES) | set(_NOT_PORTED)
                  | {"ParamAttr"} | set(_eager().EAGER_NAMES))


__all__ = ["DEFAULT_DEVICE", "get_flags", "resolve_device", "set_flags",
           "setup_precision"]
