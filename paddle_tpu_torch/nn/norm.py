"""Batch normalisation (port of ``paddle_tpu/nn/norm.py:16-93``).

Parameters ``weight`` (ones) and ``bias`` (zeros); running statistics
in the f32 buffers ``_mean`` and ``_variance``, named as in the JAX
package so that its state dict loads as it is (there is no
``num_batches_tracked``). Train mode normalises with the batch
statistics and updates the buffers in place the Paddle way
(``nn_functional.batch_norm``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from ..ops import nn_functional as NF


class _BatchNormBase(nn.Module):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        if weight_attr not in (None, False) or bias_attr not in (None,
                                                                  False):
            raise NotImplementedError("batch-norm weight_attr / bias_attr "
                                      "objects are not yet ported, see "
                                      "ROADMAP.md")
        dev = resolve_device(device)
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = None if weight_attr is False else nn.Parameter(
            torch.ones(num_features, device=dev, dtype=dtype))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros(num_features, device=dev, dtype=dtype))
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance",
                             torch.ones(num_features, device=dev))

    def forward(self, x):
        training = self.training and self._use_global_stats is not True
        out, new_m, new_v = NF.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format)
        if training:
            with torch.no_grad():
                self._mean.copy_(new_m)
                self._variance.copy_(new_v)
        return out

    def extra_repr(self) -> str:
        return f"num_features={self._num_features}"


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass
