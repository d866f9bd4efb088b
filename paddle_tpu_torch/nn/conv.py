"""Convolution layers (port of ``paddle_tpu/nn/conv.py``): ``Conv1D``,
``Conv2D``, ``Conv3D`` and the transposed ``Conv1DTranspose``,
``Conv2DTranspose`` and ``Conv3DTranspose``.

The weight is ``[out, in/groups, *k]`` (transposed: ``[in, out/groups,
*k]``) whatever ``data_format`` is, initialised like the JAX package's
``KaimingUniform(fan_in)`` (``nn/initializer.py:113-131``: uniform in
``±sqrt(2) * sqrt(3 / fan_in)``, ``fan_in = in/groups * prod(k)``) and
the bias like ``Uniform(±1/sqrt(fan_in))``, both drawn from the given
generator, unless a ``ParamAttr`` names another initializer;
``bias_attr=False`` gives no bias. The private attributes ``_stride``,
``_padding``, ``_dilation``, ``_groups`` and ``_data_format`` are the
JAX layer's; the fused-bottleneck gate reads them.

The transposed layers pass ``data_format`` to their functional by
keyword. The JAX layers pass it by position, where it lands in
``output_size``, and every call of theirs raises ``ValueError``; the
tests hold these layers against the JAX functionals on the JAX layers'
weights.

``DeformConv2D`` convolves at offset sampling positions through
``ops/vision_extra.py`` ``deformable_conv``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..ops import nn_functional as NF
from ..ops import vision_extra as VE
from .initializer import KaimingUniform, Uniform, create_parameter
from .layer import Layer


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding, dilation, groups, bias_attr, weight_attr,
                 data_format, ndim, transposed=False, output_padding=0, *,
                 device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self._in_channels = in_channels
        self._out_channels = out_channels
        k = kernel_size if isinstance(kernel_size, (list, tuple)) else \
            (kernel_size,) * ndim
        self._kernel_size = tuple(k)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        self._output_padding = output_padding
        if transposed:
            w_shape = (in_channels, out_channels // groups) + \
                self._kernel_size
        else:
            w_shape = (out_channels, in_channels // groups) + \
                self._kernel_size
        fan_in = (in_channels // groups) * math.prod(self._kernel_size)
        kw = dict(device=dev, dtype=dtype, generator=generator)
        self.weight = create_parameter(
            w_shape, attr=weight_attr,
            default_initializer=KaimingUniform(fan_in=fan_in), **kw)
        bound = 1.0 / math.sqrt(fan_in)
        self.bias = None if bias_attr is False else create_parameter(
            (out_channels,), attr=bias_attr, is_bias=True,
            default_initializer=Uniform(-bound, bound), **kw)

    def extra_repr(self) -> str:
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL", **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, bias_attr, weight_attr,
                         data_format, 1, **kw)

    def forward(self, x):
        return NF.conv1d(x, self.weight, self.bias, self._stride,
                         self._padding, self._dilation, self._groups,
                         self._data_format)


class Conv2D(_ConvNd):
    """The JAX layer keeps ``padding_mode`` and pads with zeros whatever
    it says; so does this one."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, bias_attr, weight_attr,
                         data_format, 2, **kw)
        self._padding_mode = padding_mode

    def forward(self, x):
        return NF.conv2d(x, self.weight, self.bias, self._stride,
                         self._padding, self._dilation, self._groups,
                         self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, bias_attr, weight_attr,
                         data_format, 3, **kw)

    def forward(self, x):
        return NF.conv3d(x, self.weight, self.bias, self._stride,
                         self._padding, self._dilation, self._groups,
                         self._data_format)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCL", **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, bias_attr, weight_attr,
                         data_format, 1, transposed=True,
                         output_padding=output_padding, **kw)

    def forward(self, x):
        return NF.conv1d_transpose(x, self.weight, self.bias, self._stride,
                                   self._padding, self._output_padding,
                                   self._dilation, self._groups,
                                   data_format=self._data_format)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, bias_attr, weight_attr,
                         data_format, 2, transposed=True,
                         output_padding=output_padding, **kw)

    def forward(self, x):
        return NF.conv2d_transpose(x, self.weight, self.bias, self._stride,
                                   self._padding, self._output_padding,
                                   self._dilation, self._groups,
                                   data_format=self._data_format)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, bias_attr, weight_attr,
                         data_format, 3, transposed=True,
                         output_padding=output_padding, **kw)

    def forward(self, x):
        return VE.conv3d_transpose(x, self.weight, self.bias, self._stride,
                                   self._padding, self._output_padding,
                                   self._dilation, self._groups,
                                   data_format=self._data_format)


class DeformConv2D(_ConvNd):
    """Deformable convolution v1, or v2 with a ``mask`` at the call, over
    ``ops/vision_extra.py`` ``deformable_conv`` (NCHW; the weight and
    bias as ``Conv2D``'s, with the JAX layer's names)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None, **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, bias_attr, weight_attr,
                         "NCHW", 2, **kw)
        self._deformable_groups = deformable_groups

    def forward(self, x, offset, mask=None):
        return VE.deformable_conv(x, offset, self.weight, mask, self.bias,
                                  self._stride, self._padding,
                                  self._dilation, self._deformable_groups,
                                  self._groups)
