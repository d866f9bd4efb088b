"""Autograd (port of ``paddle_tpu/autograd/``): ``backward``, ``grad``,
the grad-mode switches and ``PyLayer``, on torch's autograd."""

from .engine import (backward, enable_grad, grad,  # noqa: F401
                     is_grad_enabled, no_grad, set_grad_enabled)
from .py_layer import PyLayer, PyLayerContext  # noqa: F401
