"""MobileNet v1 and v2 (port of ``paddle_tpu/vision/models/
mobilenet.py``): ``scale`` multiplies every width (at least 8),
depthwise convolutions are ``groups=in_c`` ``Conv2D``s, v2 uses ReLU6
and inverted residuals.

``data_format="NHWC"`` runs the network channel-last while the public
input and output stay NCHW (``_layout.py``). Module names are the JAX
model's (``_ConvBNRelu``'s ``conv`` / ``bn``, which ``inference/
fusion.py`` folds, and the ``Sequential`` pairs of v2's projections), so
its ``state_dict()`` loads with :func:`paddle_tpu_torch.nn.layer.
load_jax_state`. Models are built on ``device`` (``None`` means CUDA)
and initialised from ``generator`` (``None``: a generator on that
device seeded with 0).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...device import resolve_device
from ...nn.activation import ReLU, ReLU6
from ...nn.common import Dropout, Linear
from ...nn.container import Sequential
from ...nn.conv import Conv2D
from ...nn.norm import BatchNorm2D
from ...nn.pooling import AdaptiveAvgPool2D
from ._layout import boundary_in, boundary_out, flatten_nchw_order
from ...nn.layer import Layer


def _norm_kw(kw):
    return dict(device=kw["device"], dtype=kw["dtype"])


class _ConvBNRelu(Layer):
    def __init__(self, in_c, out_c, k, stride=1, padding=0, groups=1,
                 relu6=False, data_format="NCHW", **kw):
        super().__init__()
        self.conv = Conv2D(in_c, out_c, k, stride=stride, padding=padding,
                           groups=groups, bias_attr=False,
                           data_format=data_format, **kw)
        self.bn = BatchNorm2D(out_c, data_format=data_format, **_norm_kw(kw))
        self.act = ReLU6() if relu6 else ReLU()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class _DepthwiseSep(Layer):
    def __init__(self, in_c, out_c, stride, data_format="NCHW", **kw):
        super().__init__()
        self.dw = _ConvBNRelu(in_c, in_c, 3, stride, 1, groups=in_c,
                              data_format=data_format, **kw)
        self.pw = _ConvBNRelu(in_c, out_c, 1, data_format=data_format, **kw)

    def forward(self, x):
        return self.pw(self.dw(x))


def _model_kw(device, dtype, generator):
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return dict(device=dev, dtype=dtype, generator=generator)


class MobileNetV1(Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 data_format="NCHW", *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = _model_kw(device, dtype, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.data_format = data_format

        def c(ch):
            return max(int(ch * scale), 8)

        cfg = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
               (256, 256, 1), (256, 512, 2)] + [(512, 512, 1)] * 5 + \
            [(512, 1024, 2), (1024, 1024, 1)]
        layers = [_ConvBNRelu(3, c(32), 3, 2, 1, data_format=data_format,
                              **kw)]
        for in_c, out_c, s in cfg:
            layers.append(_DepthwiseSep(c(in_c), c(out_c), s,
                                        data_format=data_format, **kw))
        self.features = Sequential(*layers)
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1, data_format=data_format)
        if num_classes > 0:
            self.fc = Linear(c(1024), num_classes, **kw)

    def forward(self, x):
        x = boundary_in(x, self.data_format)
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = flatten_nchw_order(x, self.data_format, self.with_pool)
            x = self.fc(x)
        else:
            x = boundary_out(x, self.data_format)
        return x


class _InvertedResidual(Layer):
    def __init__(self, in_c, out_c, stride, expand_ratio,
                 data_format="NCHW", **kw):
        super().__init__()
        hidden = int(round(in_c * expand_ratio))
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if expand_ratio != 1:
            layers.append(_ConvBNRelu(in_c, hidden, 1, relu6=True,
                                      data_format=data_format, **kw))
        layers.append(_ConvBNRelu(hidden, hidden, 3, stride, 1,
                                  groups=hidden, relu6=True,
                                  data_format=data_format, **kw))
        layers.append(Conv2D(hidden, out_c, 1, bias_attr=False,
                             data_format=data_format, **kw))
        layers.append(BatchNorm2D(out_c, data_format=data_format,
                                  **_norm_kw(kw)))
        self.conv = Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 data_format="NCHW", *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = _model_kw(device, dtype, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.data_format = data_format
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]

        def c(ch):
            return max(int(ch * scale), 8)

        in_c = c(32)
        layers = [_ConvBNRelu(3, in_c, 3, 2, 1, relu6=True,
                              data_format=data_format, **kw)]
        for t, ch, n, s in cfg:
            out_c = c(ch)
            for i in range(n):
                layers.append(_InvertedResidual(in_c, out_c,
                                                s if i == 0 else 1, t,
                                                data_format=data_format,
                                                **kw))
                in_c = out_c
        self.last_c = c(1280) if scale > 1.0 else 1280
        layers.append(_ConvBNRelu(in_c, self.last_c, 1, relu6=True,
                                  data_format=data_format, **kw))
        self.features = Sequential(*layers)
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1, data_format=data_format)
        if num_classes > 0:
            self.classifier = Sequential(
                Dropout(0.2), Linear(self.last_c, num_classes, **kw))

    def forward(self, x):
        x = boundary_in(x, self.data_format)
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = flatten_nchw_order(x, self.data_format, self.with_pool)
            x = self.classifier(x)
        else:
            x = boundary_out(x, self.data_format)
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV2(scale=scale, **kwargs)
