"""Pooling layers (port of ``paddle_tpu/nn/pooling.py``): the 13 layers
over the pools of ``ops/nn_functional.py``, with the JAX layers'
arguments (``AdaptiveMaxPool1D`` keeps ``return_mask`` and returns no
mask, and ``AdaptiveMaxPool2D`` / ``3D`` take no ``data_format``, as
there)."""

from __future__ import annotations

from torch import nn

from ..ops import nn_functional as NF
from .layer import Layer


class MaxPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.return_mask, self.ceil_mode = return_mask, ceil_mode

    def forward(self, x):
        return NF.max_pool1d(x, self.k, self.s, self.p, self.ceil_mode,
                             self.return_mask)


class AvgPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.exclusive, self.ceil_mode = exclusive, ceil_mode

    def forward(self, x):
        return NF.avg_pool1d(x, self.k, self.s, self.p, self.ceil_mode,
                             self.exclusive)


class MaxPool2D(Layer):
    _fn = staticmethod(NF.max_pool2d)

    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCHW",
                 name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.return_mask, self.ceil_mode = return_mask, ceil_mode
        self.data_format = data_format

    def forward(self, x):
        return self._fn(x, self.k, self.s, self.p, self.ceil_mode,
                        self.return_mask, self.data_format)


class MaxPool3D(MaxPool2D):
    _fn = staticmethod(NF.max_pool3d)

    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCDHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, return_mask,
                         ceil_mode, data_format)


class AvgPool2D(Layer):
    _fn = staticmethod(NF.avg_pool2d)

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.ceil_mode, self.exclusive = ceil_mode, exclusive
        self.divisor_override = divisor_override
        self.data_format = data_format

    def forward(self, x):
        return self._fn(x, self.k, self.s, self.p, self.ceil_mode,
                        self.exclusive, self.divisor_override,
                        self.data_format)


class AvgPool3D(AvgPool2D):
    _fn = staticmethod(NF.avg_pool3d)

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode, exclusive,
                         divisor_override, data_format)


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return NF.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveMaxPool1D(AdaptiveAvgPool1D):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size)

    def forward(self, x):
        return NF.adaptive_max_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(Layer):
    _fn = staticmethod(NF.adaptive_avg_pool2d)

    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return self._fn(x, self.output_size, self.data_format)


class AdaptiveAvgPool3D(AdaptiveAvgPool2D):
    _fn = staticmethod(NF.adaptive_avg_pool3d)

    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__(output_size, data_format)


class AdaptiveMaxPool2D(Layer):
    _fn = staticmethod(NF.adaptive_max_pool2d)

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size
        self.return_mask = return_mask

    def forward(self, x):
        return self._fn(x, self.output_size, self.return_mask)


class AdaptiveMaxPool3D(AdaptiveMaxPool2D):
    _fn = staticmethod(NF.adaptive_max_pool3d)


class LPPool2D(Layer):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__()
        self._args = (norm_type, kernel_size, stride, padding, ceil_mode,
                      data_format)

    def forward(self, x):
        p, k, s, pad, cm, fmt = self._args
        return NF.lp_pool2d(x, p, k, stride=s, padding=pad, ceil_mode=cm,
                            data_format=fmt)
