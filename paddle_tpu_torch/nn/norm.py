"""Normalisation layers (port of ``paddle_tpu/nn/norm.py``).

- ``BatchNorm1D/2D/3D`` and the fluid-era ``BatchNorm`` (with ``act``):
  parameters ``weight`` (ones) and ``bias`` (zeros, or the global bias
  initializer), running statistics in the f32 buffers ``_mean`` and
  ``_variance``, named as in the JAX package so that its state dict
  loads as it is (there is no ``num_batches_tracked``). Train mode
  normalises with the batch statistics and updates the buffers in place
  the Paddle way (``nn_functional.batch_norm``).
- ``SyncBatchNorm`` and ``convert_sync_batchnorm``: one process holds
  the whole batch, so its statistics are the local ones. The fused
  bottleneck admits only ``BatchNorm2D`` and so refuses a converted
  block, as in the JAX package.
- ``LayerNorm``, ``RMSNorm``, ``GroupNorm``, ``InstanceNorm1D/2D/3D``,
  ``LocalResponseNorm``, ``DataNorm`` (buffers ``batch_size``,
  ``batch_sum``, ``batch_square_sum``, accumulated in training) and
  ``SpectralNorm`` (buffers ``weight_u`` / ``weight_v``, the power
  iteration's vectors, drawn from the given generator and updated at
  every call).

Weight and bias attributes are ``ParamAttr`` objects (``False``: no such
parameter) as in the JAX layers.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..ops import nn_functional as NF
from .initializer import Constant, create_parameter
from .layer import Layer


def _scale_and_shift(shape, weight_attr, bias_attr, device, dtype):
    """``weight`` (ones) and ``bias`` (zeros) of ``shape``, or None where
    the attribute is False."""
    kw = dict(device=device, dtype=dtype)
    weight = None if weight_attr is False else create_parameter(
        shape, attr=weight_attr, default_initializer=Constant(1.0), **kw)
    bias = None if bias_attr is False else create_parameter(
        shape, attr=bias_attr, is_bias=True, **kw)
    return weight, bias


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight, self.bias = _scale_and_shift(
            (num_features,), weight_attr, bias_attr, dev, NF.as_dtype(dtype))
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


class BatchNorm(_BatchNormBase):
    """The fluid-era signature (``norm.py:56-84``): ``act`` names an
    activation of ``ops/nn_functional.py`` applied after the norm;
    ``is_test`` starts the layer in eval mode."""

    def __init__(self, num_channels, act=None, is_test=False, momentum=0.9,
                 epsilon=1e-5, param_attr=None, bias_attr=None,
                 dtype="float32", data_layout="NCHW", in_place=False,
                 moving_mean_name=None, moving_variance_name=None,
                 do_model_average_for_mean_and_var=True,
                 use_global_stats=False, trainable_statistics=False, *,
                 device=None):
        super().__init__(num_channels, momentum=momentum, epsilon=epsilon,
                         weight_attr=param_attr, bias_attr=bias_attr,
                         data_format=data_layout,
                         use_global_stats=use_global_stats or None,
                         device=device, dtype=dtype)
        self._act = act
        if is_test:
            self.eval()

    def forward(self, x):
        out = super().forward(x)
        if self._act:
            out = getattr(NF, self._act)(out)
        return out


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica batch norm. In one process the batch is the local
    one, so it normalises exactly as ``BatchNorm2D`` does."""

    @classmethod
    def convert_sync_batchnorm(cls, layer: nn.Module) -> nn.Module:
        """Every batch norm of ``layer`` (not already a ``SyncBatchNorm``)
        replaced by one that shares its parameters and running
        statistics (``norm.py:108-123``)."""
        for name, sub in list(layer._modules.items()):
            if sub is not None:
                layer._modules[name] = cls.convert_sync_batchnorm(sub)
        if isinstance(layer, _BatchNormBase) and not isinstance(
                layer, SyncBatchNorm):
            new = SyncBatchNorm(layer._num_features, layer._momentum,
                                layer._epsilon,
                                data_format=layer._data_format,
                                device=layer._mean.device)
            new.weight = layer.weight
            new.bias = layer.bias
            new._mean = layer._mean
            new._variance = layer._variance
            return new
        return layer


class LayerNorm(Layer):
    """Layer norm over the trailing ``normalized_shape`` dims (an int or
    a list; ``norm.py:126-152``), with ``weight`` (ones) and ``bias``
    (zeros) named as in the JAX package's checkpoints, either left out
    by ``weight_attr=False`` / ``bias_attr=False``. It is the models'
    norm too. An input of another dtype than the parameters (bf16
    activations with the bf16 recipe's fp32 norms) is normalised and
    scaled in the parameters' dtype and returned in its own, as the JAX
    function multiplies by its fp32 weight and casts back
    (``nn_functional.layer_norm``); PyTorch's CUDA layer norm takes no
    mixed dtypes."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self._normalized_shape = tuple(normalized_shape)
        self._epsilon = epsilon
        self.weight, self.bias = _scale_and_shift(
            self._normalized_shape, weight_attr, bias_attr,
            resolve_device(device), dtype)

    def forward(self, x):
        return NF.layer_norm(x, self._normalized_shape, self.weight,
                             self.bias, self._epsilon)

    def extra_repr(self) -> str:
        return f"normalized_shape={self._normalized_shape}"


class RMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-6, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self._epsilon = epsilon
        self.weight = create_parameter(
            (hidden_size,), default_initializer=Constant(1.0),
            device=resolve_device(device), dtype=dtype)

    def forward(self, x):
        return NF.rms_norm(x, self.weight, self._epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight, self.bias = _scale_and_shift(
            (num_channels,), weight_attr, bias_attr, resolve_device(device),
            dtype)

    def forward(self, x):
        return NF.group_norm(x, self._num_groups, self.weight, self.bias,
                             self._epsilon, self._data_format)


class InstanceNorm1D(Layer):
    """Per sample and channel over the spatial dims. ``weight_attr=False``
    drops both parameters; a ``bias_attr`` of False does not drop the
    bias, as in the JAX layer (``norm.py:178-194``)."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__()
        self._epsilon = epsilon
        if weight_attr is False:
            self.weight, self.bias = None, None
        else:
            kw = dict(device=resolve_device(device), dtype=dtype)
            self.weight = create_parameter(
                (num_features,), attr=weight_attr,
                default_initializer=Constant(1.0), **kw)
            self.bias = create_parameter((num_features,), attr=bias_attr,
                                         is_bias=True, **kw)

    def forward(self, x):
        return NF.instance_norm(x, self.weight, self.bias, self._epsilon)


class InstanceNorm2D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, **kw):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format, name, **kw)


class InstanceNorm3D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 name=None, **kw):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format, name, **kw)


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self._data_format = data_format

    def forward(self, x):
        return NF.local_response_norm(x, self.size, self.alpha, self.beta,
                                      self.k, self._data_format)


class DataNorm(Layer):
    """Normalisation by accumulated statistics (``norm.py:222-266``):
    the output uses the buffers as they are, then training folds the
    batch in (``size * decay + n``, ``sum * decay + sum(x)``, ``square_sum
    * decay + sum((x - old mean)^2)``)."""

    def __init__(self, num_features, epsilon=1e-4, slot_dim: int = -1,
                 summary_decay_rate: float = 0.9999999, name=None, *,
                 device=None):
        super().__init__()
        if slot_dim > 0:
            raise NotImplementedError(
                "DataNorm slot_dim>0 (show/click slot handling) is not "
                "implemented; pass slot_dim=-1 for plain per-feature "
                "normalization")
        dev = resolve_device(device)
        self._epsilon = epsilon
        self._decay = summary_decay_rate
        init_size = 1e4
        self.register_buffer("batch_size", torch.full(
            (num_features,), init_size, device=dev))
        self.register_buffer("batch_sum", torch.zeros(num_features,
                                                      device=dev))
        self.register_buffer("batch_square_sum", torch.full(
            (num_features,), init_size, device=dev))

    def forward(self, x):
        out = NF.data_norm(x, self.batch_size, self.batch_sum,
                           self.batch_square_sum, self._epsilon)
        if self.training:
            with torch.no_grad():
                xv = x.detach()
                d = self._decay
                mean = self.batch_sum / self.batch_size
                self.batch_size.copy_(self.batch_size * d + x.shape[0])
                self.batch_sum.copy_(self.batch_sum * d + xv.sum(0))
                self.batch_square_sum.copy_(
                    self.batch_square_sum * d + ((xv - mean) ** 2).sum(0))
        return out


class SpectralNorm(Layer):
    """``weight / sigma(weight)`` by power iteration (``norm.py:269-319``):
    ``weight_u [h]`` and ``weight_v [w]`` start as normalised normal
    draws from ``generator`` and are updated at every call; sigma is a
    constant to autograd, as the JAX layer divides by a fresh tensor."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32", *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        dt = NF.as_dtype(dtype)
        self.dim = dim
        self.power_iters = power_iters
        self.eps = eps
        h = int(weight_shape[dim])
        w = 1
        for i, s in enumerate(weight_shape):
            if i != dim:
                w *= int(s)
        u = torch.empty(h, device=dev, dtype=dt).normal_(
            generator=generator)
        v = torch.empty(w, device=dev, dtype=dt).normal_(
            generator=generator)
        self.register_buffer("weight_u", u / (torch.linalg.norm(u) + eps))
        self.register_buffer("weight_v", v / (torch.linalg.norm(v) + eps))

    def forward(self, weight):
        with torch.no_grad():
            wm = torch.movedim(weight.detach(), self.dim, 0).reshape(
                weight.shape[self.dim], -1)
            u, v = self.weight_u, self.weight_v
            for _ in range(max(1, self.power_iters)):
                v = wm.t() @ u
                v = v / (torch.linalg.norm(v) + self.eps)
                u = wm @ v
                u = u / (torch.linalg.norm(u) + self.eps)
            self.weight_u.copy_(u)
            self.weight_v.copy_(v)
            sigma = u @ wm @ v
        return weight / sigma
