"""VGG (port of ``paddle_tpu/vision/models/vgg.py``): ``vgg11/13/16/19``,
with ``batch_norm=True`` a ``BatchNorm2D`` after every convolution.

``data_format="NHWC"`` runs the network channel-last while the public
input and output stay NCHW (``_layout.py``); the 7x7 pooled map is
flattened in NCHW order for the classifier. Module names are the JAX
model's, so its ``state_dict()`` loads with
:func:`paddle_tpu_torch.nn.layer.load_jax_state`. Models are built on
``device`` (``None`` means CUDA) and initialised from ``generator``
(``None``: a generator on that device seeded with 0).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...device import resolve_device
from ...nn.activation import ReLU
from ...nn.common import Dropout, Linear
from ...nn.container import Sequential
from ...nn.conv import Conv2D
from ...nn.norm import BatchNorm2D
from ...nn.pooling import AdaptiveAvgPool2D, MaxPool2D
from ._layout import boundary_in, boundary_out, flatten_nchw_order
from ...nn.layer import Layer

_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512,
          512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


def _make_features(cfg, batch_norm, data_format, kw):
    layers = []
    in_c = 3
    for v in cfg:
        if v == "M":
            layers.append(MaxPool2D(2, 2, data_format=data_format))
        else:
            layers.append(Conv2D(in_c, v, 3, padding=1,
                                 data_format=data_format, **kw))
            if batch_norm:
                layers.append(BatchNorm2D(v, data_format=data_format,
                                          device=kw["device"],
                                          dtype=kw["dtype"]))
            layers.append(ReLU())
            in_c = v
    return Sequential(*layers)


class VGG(Layer):
    def __init__(self, features, num_classes=1000, with_pool=True,
                 data_format="NCHW", *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        kw = dict(device=dev, dtype=dtype, generator=generator)
        self.features = features
        self.with_pool = with_pool
        self.num_classes = num_classes
        self.data_format = data_format
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((7, 7), data_format=data_format)
        if num_classes > 0:
            self.classifier = Sequential(
                Linear(512 * 7 * 7, 4096, **kw), ReLU(), Dropout(),
                Linear(4096, 4096, **kw), ReLU(), Dropout(),
                Linear(4096, num_classes, **kw))

    def forward(self, x):
        x = boundary_in(x, self.data_format)
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            # the 7x7 pooled map is not 1x1: flatten in NCHW order
            x = flatten_nchw_order(x, self.data_format, False)
            x = self.classifier(x)
        else:
            x = boundary_out(x, self.data_format)
        return x


def _vgg(cfg_key, batch_norm, device=None, dtype=torch.float32,
         generator=None, **kwargs):
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    kw = dict(device=dev, dtype=dtype, generator=generator)
    fmt = kwargs.get("data_format", "NCHW")
    # the features draw first, then the classifier, as in the JAX model
    features = _make_features(_CFGS[cfg_key], batch_norm, fmt, kw)
    return VGG(features, **kwargs, **kw)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", batch_norm, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", batch_norm, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", batch_norm, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", batch_norm, **kwargs)
