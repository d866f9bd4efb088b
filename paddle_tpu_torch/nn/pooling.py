"""Pooling layers (port of ``paddle_tpu/nn/pooling.py``): the 2-D max,
average and adaptive average pools, with the JAX layers' arguments."""

from __future__ import annotations

from torch import nn

from ..ops import nn_functional as NF


class MaxPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCHW",
                 name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.return_mask, self.ceil_mode = return_mask, ceil_mode
        self.data_format = data_format

    def forward(self, x):
        return NF.max_pool2d(x, self.k, self.s, self.p, self.ceil_mode,
                             self.return_mask, self.data_format)


class AvgPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.ceil_mode, self.exclusive = ceil_mode, exclusive
        self.divisor_override = divisor_override
        self.data_format = data_format

    def forward(self, x):
        return NF.avg_pool2d(x, self.k, self.s, self.p, self.ceil_mode,
                             self.exclusive, self.divisor_override,
                             self.data_format)


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return NF.adaptive_avg_pool2d(x, self.output_size, self.data_format)
