"""ResNet family (port of ``paddle_tpu/vision/models/resnet.py``):
``resnet18/34/50/101/152`` and ``wide_resnet50_2`` with ``BasicBlock``
and ``BottleneckBlock``.

``data_format="NHWC"`` runs the network channel-last while the public
input and output stay NCHW (``_layout.py``). Module and parameter names
are the JAX model's, so its ``state_dict()`` as numpy loads with
:func:`paddle_tpu_torch.nn.layer.load_jax_state`.

In eval mode a ``BottleneckBlock`` that the fused gate admits
(``ops/kernels/fused_conv_block.py``: opted in, stride 1, identity,
plain ``BatchNorm2D``, NHWC, a plane of at least 784 positions,
``C == 4M``, a CUDA input) runs as ONE launch of the fused-bottleneck
kernel on BN-folded weights; every other block, and every block in
train mode, runs the eager conv / BN / relu chain.

Models are built on ``device`` (``None`` means CUDA, and raises without
a GPU) and initialised from ``generator`` (``None`` means a generator
on that device seeded with 0).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...device import resolve_device
from ...nn.activation import ReLU
from ...nn.container import Sequential
from ...nn.conv import Conv2D
from ...nn.layers import Linear
from ...nn.norm import BatchNorm2D
from ...nn.pooling import AdaptiveAvgPool2D, MaxPool2D
from ...ops.kernels import fused_conv_block as FC
from ._layout import boundary_in, boundary_out, flatten_nchw_order


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW", *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        kw = dict(device=device, dtype=dtype)
        self.conv1 = Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                            bias_attr=False, data_format=data_format,
                            generator=generator, **kw)
        self.bn1 = norm_layer(planes, data_format=data_format, **kw)
        self.relu = ReLU()
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                            data_format=data_format, generator=generator,
                            **kw)
        self.bn2 = norm_layer(planes, data_format=data_format, **kw)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW", *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        kw = dict(device=device, dtype=dtype)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False,
                            data_format=data_format, generator=generator,
                            **kw)
        self.bn1 = norm_layer(width, data_format=data_format, **kw)
        self.conv2 = Conv2D(width, width, 3, padding=dilation, stride=stride,
                            groups=groups, dilation=dilation,
                            bias_attr=False, data_format=data_format,
                            generator=generator, **kw)
        self.bn2 = norm_layer(width, data_format=data_format, **kw)
        self.conv3 = Conv2D(width, planes * self.expansion, 1,
                            bias_attr=False, data_format=data_format,
                            generator=generator, **kw)
        self.bn3 = norm_layer(planes * self.expansion,
                              data_format=data_format, **kw)
        self.relu = ReLU()
        self.downsample = downsample
        self._fused_pack = None

    def forward(self, x):
        if not self.training and self._try_fused_eval_gate(x):
            return self._fused_eval(x)
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)

    def _try_fused_eval_gate(self, x) -> bool:
        """The eval-only fused-block gate (``resnet.py:77-88``)."""
        return x.dim() == 4 and FC.fused_bottleneck_supported(
            self, tuple(x.shape), self._block_data_format(), x.device.type)

    def _block_data_format(self) -> str:
        return getattr(self.conv1, "_data_format", "NCHW")

    def _pack_key(self):
        """``(data_ptr, _version)`` of every tensor the fold reads. The
        JAX package keys its pack on array identity, which works there
        because loading weights swaps the arrays; here
        ``load_jax_state`` and ``fuse_conv_bn`` write in place, which
        keeps the pointer and bumps the version."""
        tensors = [self.conv1.weight, self.conv2.weight, self.conv3.weight]
        for bn in (self.bn1, self.bn2, self.bn3):
            tensors += [bn.weight, bn.bias, bn._mean, bn._variance]
        return tuple((t.data_ptr(), t._version) if t is not None else None
                     for t in tensors)

    def _fused_eval(self, x):
        """Fold and pack once per weight version, then one kernel launch
        (``resnet.py:93-116``)."""
        key = self._pack_key()
        if self._fused_pack is None or self._fused_pack[0] != key:
            self._fused_pack = (key, FC.pack_bottleneck(self))
        return FC.fused_bottleneck_eval(x.contiguous(), *self._fused_pack[1])


class ResNet(nn.Module):
    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, data_format="NCHW", *,
                 device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        kw = dict(device=dev, dtype=dtype)
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = layer_cfg[depth]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.inplanes = 64
        self.dilation = 1
        self.data_format = data_format
        self.conv1 = Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                            bias_attr=False, data_format=data_format,
                            generator=generator, **kw)
        self.bn1 = BatchNorm2D(self.inplanes, data_format=data_format, **kw)
        self.relu = ReLU()
        self.maxpool = MaxPool2D(3, stride=2, padding=1,
                                 data_format=data_format)
        kw["generator"] = generator
        self.layer1 = self._make_layer(block, 64, layers[0], 1, kw)
        self.layer2 = self._make_layer(block, 128, layers[1], 2, kw)
        self.layer3 = self._make_layer(block, 256, layers[2], 2, kw)
        self.layer4 = self._make_layer(block, 512, layers[3], 2, kw)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1), data_format=data_format)
        if num_classes > 0:
            self.fc = Linear(512 * block.expansion, num_classes, **kw)

    def _make_layer(self, block, planes, blocks, stride, kw):
        norm_kw = dict(device=kw["device"], dtype=kw["dtype"])
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False,
                       data_format=self.data_format, **kw),
                BatchNorm2D(planes * block.expansion,
                            data_format=self.data_format, **norm_kw))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width,
                        data_format=self.data_format, **kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width,
                                data_format=self.data_format, **kw))
        return Sequential(*layers)

    def forward(self, x):
        x = boundary_in(x, self.data_format)
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = flatten_nchw_order(x, self.data_format, self.with_pool)
            x = self.fc(x)
        else:
            x = boundary_out(x, self.data_format)
        return x


def resnet18(pretrained=False, **kwargs):
    return ResNet(BasicBlock, 18, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return ResNet(BasicBlock, 34, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 50, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 101, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 152, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 50, width=128, **kwargs)
