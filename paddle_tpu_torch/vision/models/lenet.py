"""LeNet (port of ``paddle_tpu/vision/models/lenet.py``): two convolutions
with max pools over a ``[N, 1, 28, 28]`` input, then three linears to
``num_classes`` (none for ``num_classes <= 0``). NCHW only, as in the
JAX model. Module names are the JAX model's, so its ``state_dict()``
loads with :func:`paddle_tpu_torch.nn.layer.load_jax_state`."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...device import resolve_device
from ...nn.activation import ReLU
from ...nn.common import Linear
from ...nn.container import Sequential
from ...nn.conv import Conv2D
from ...nn.pooling import MaxPool2D
from ...nn.layer import Layer


class LeNet(Layer):
    def __init__(self, num_classes=10, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        kw = dict(device=dev, dtype=dtype, generator=generator)
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1, **kw), ReLU(),
            MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0, **kw), ReLU(),
            MaxPool2D(2, 2))
        if num_classes > 0:
            self.fc = Sequential(Linear(400, 120, **kw),
                                 Linear(120, 84, **kw),
                                 Linear(84, num_classes, **kw))

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x
