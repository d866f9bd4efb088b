"""Activation layers (port of ``paddle_tpu/nn/activation.py``): the 27
layers over the activation functionals of ``ops/nn_functional.py``, with
the JAX layers' arguments. ``PReLU`` holds the one parameter, ``weight``
(``num_parameters`` entries, each ``init``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..ops import nn_functional as NF
from .initializer import Constant, create_parameter
from .layer import Layer


class _Act(Layer):
    _op = ""
    _kwargs: dict = {}

    def __init__(self, name=None, **kwargs):
        super().__init__()
        self._extra = {**self._kwargs, **kwargs}

    def forward(self, x):
        return getattr(NF, self._op)(x, **self._extra)

    def extra_repr(self):
        return ", ".join(f"{k}={v}" for k, v in self._extra.items())


class _Args(Layer):
    """An activation whose arguments (``_names``, set by the constructor)
    follow ``x`` to ``NF.<_op>`` in order, as the JAX layer passes
    them."""

    _op = ""
    _names: tuple = ()

    def forward(self, x):
        return getattr(NF, self._op)(
            x, *(getattr(self, k) for k in self._names))

    def extra_repr(self):
        return ", ".join(f"{k}={getattr(self, k)}" for k in self._names)


class ReLU(_Act):
    _op = "relu"


class ReLU6(_Act):
    _op = "relu6"


class SELU(_Act):
    _op = "selu"


class Silu(_Act):
    _op = "silu"


class Swish(_Act):
    _op = "swish"


class Mish(_Act):
    _op = "mish"


class Sigmoid(_Act):
    _op = "sigmoid"


class LogSigmoid(_Act):
    _op = "log_sigmoid"


class Hardsigmoid(_Act):
    _op = "hardsigmoid"


class Hardswish(_Act):
    _op = "hardswish"


class Tanhshrink(_Act):
    _op = "tanhshrink"


class Softsign(_Act):
    _op = "softsign"


class Tanh(_Act):
    _op = "tanh"


class LeakyReLU(_Args):
    _op, _names = "leaky_relu", ("negative_slope",)

    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self.negative_slope = negative_slope


class ELU(_Args):
    _op, _names = "elu", ("alpha",)

    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self.alpha = alpha


class CELU(ELU):
    _op = "celu"


class GELU(_Args):
    _op, _names = "gelu", ("approximate",)

    def __init__(self, approximate=False, name=None):
        super().__init__()
        self.approximate = approximate


class Hardtanh(_Args):
    _op, _names = "hardtanh", ("min", "max")

    def __init__(self, min=-1.0, max=1.0, name=None):  # noqa: A002
        super().__init__()
        self.min, self.max = min, max


class Hardshrink(_Args):
    _op, _names = "hardshrink", ("threshold",)

    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self.threshold = threshold


class Softshrink(Hardshrink):
    _op = "softshrink"


class ThresholdedReLU(Hardshrink):
    _op = "thresholded_relu"

    def __init__(self, threshold=1.0, name=None):
        super().__init__(threshold)


class Softplus(_Args):
    _op, _names = "softplus", ("beta", "threshold")

    def __init__(self, beta=1.0, threshold=20.0, name=None):
        super().__init__()
        self.beta, self.threshold = beta, threshold


class Softmax(_Args):
    _op, _names = "softmax", ("axis",)

    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis


class LogSoftmax(Softmax):
    _op = "log_softmax"


class GLU(Softmax):
    _op = "glu"


class Maxout(_Args):
    _op, _names = "maxout", ("groups", "axis")

    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self.groups, self.axis = groups, axis


class PReLU(Layer):
    """``where(x >= 0, x, weight * x)`` with ``weight [num_parameters]``
    (one slope, or one a channel on axis 1), each ``init``."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 name=None, data_format="NCHW", *, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = create_parameter(
            (num_parameters,), attr=weight_attr,
            default_initializer=Constant(init),
            device=resolve_device(device), dtype=dtype, generator=generator)

    def forward(self, x):
        return NF.prelu(x, self.weight)
