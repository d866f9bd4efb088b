"""``Conv2D`` (port of ``paddle_tpu/nn/conv.py:14-76``).

The weight is ``[out, in/groups, kh, kw]`` whatever ``data_format`` is,
initialised like the JAX package's ``KaimingUniform(fan_in)``
(``nn/initializer.py:113-131``: uniform in ``±sqrt(2) * sqrt(3 /
fan_in)``) and the bias like ``Uniform(±1/sqrt(fan_in))``, both drawn
from the given generator. The private attributes ``_stride``,
``_padding``, ``_dilation``, ``_groups`` and ``_data_format`` are the
JAX layer's; the fused-bottleneck gate reads them.

Not ported yet: ``Conv1D``, ``Conv3D`` and the transposed convolutions.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..ops import nn_functional as NF


def _uniform(shape, bound: float, device, dtype, generator) -> nn.Parameter:
    w = torch.empty(shape, device=device, dtype=torch.float32)
    w.uniform_(-bound, bound, generator=generator)
    return nn.Parameter(w.to(dtype))


class Conv2D(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if weight_attr is not None or bias_attr not in (None, False):
            raise NotImplementedError("Conv2D weight_attr / bias_attr "
                                      "objects are not yet ported, see "
                                      "ROADMAP.md")
        dev = resolve_device(device)
        self._in_channels = in_channels
        self._out_channels = out_channels
        k = kernel_size if isinstance(kernel_size, (list, tuple)) else \
            (kernel_size,) * 2
        self._kernel_size = tuple(k)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        # the JAX layer keeps padding_mode and pads with zeros whatever it
        # says; so does this one
        self._padding_mode = padding_mode
        fan_in = (in_channels // groups) * math.prod(self._kernel_size)
        self.weight = _uniform(
            (out_channels, in_channels // groups) + self._kernel_size,
            math.sqrt(2.0) * math.sqrt(3.0 / fan_in), dev, dtype, generator)
        self.bias = None if bias_attr is False else _uniform(
            (out_channels,), 1.0 / math.sqrt(fan_in), dev, dtype, generator)

    def forward(self, x):
        return NF.conv2d(x, self.weight, self.bias, self._stride,
                         self._padding, self._dilation, self._groups,
                         self._data_format)

    def extra_repr(self) -> str:
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")
