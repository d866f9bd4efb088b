"""The JAX package's common layers (port of ``paddle_tpu/nn/common.py``):
``Linear``, ``Identity``, ``Embedding``, ``Flatten`` and the dropouts
``Dropout``, ``Dropout2D``, ``Dropout3D`` and ``AlphaDropout``.

- ``Linear`` keeps the JAX layout (weight ``[in, out]``, ``y = x @ W +
  b``) and draws ``xavier_uniform`` weights and zero biases, as the JAX
  layer's ``create_parameter`` does by default (the global initializer,
  or a ``ParamAttr``'s, where set). The GPT layers of ``nn/layers.py``
  keep their normal(0.02) draws.
- ``Embedding`` draws ``normal(0, 1)`` and zeroes the rows it looks up
  at ``padding_idx``; with a ``weight_attr`` it takes that attribute's
  initializer, or the default of ``create_parameter``, as in the JAX
  layer.
- ``Dropout`` is ``nn/layers.py``'s; all the dropouts draw from the
  ``core.rng.key_scope`` generator that ``jit.TrainStep`` opens.

Constructors with parameters take ``device`` (``None`` means CUDA and
raises without a GPU) and ``generator`` (``None``: the device's default
generator).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..ops import nn_functional as NF
from .initializer import Normal, create_parameter
from .layers import Dropout  # noqa: F401
from .layers import Linear as _Linear


class Identity(nn.Module):
    def forward(self, x):
        return x


class Linear(_Linear):
    """``y = x @ weight + bias``, weight ``[in_features, out_features]``
    (``xavier_uniform``), bias zeros (none for ``bias_attr=False``). The
    forward is the GPT layer's; the parameters are created here, as the
    JAX layer's ``create_parameter`` creates them."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        nn.Module.__init__(self)
        kw = dict(device=resolve_device(device), dtype=dtype,
                  generator=generator)
        self.in_features = in_features
        self.out_features = out_features
        self.weight = create_parameter((in_features, out_features),
                                       attr=weight_attr, **kw)
        self.bias = None if bias_attr is False else create_parameter(
            (out_features,), attr=bias_attr, is_bias=True, **kw)

    def extra_repr(self) -> str:
        return f"in={self.in_features}, out={self.out_features}"


class Embedding(nn.Module):
    """Row lookup into ``weight [num_embeddings, embedding_dim]``."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx: Optional[int] = None, sparse: bool = False,
                 weight_attr=None, name=None, *, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self.weight = create_parameter(
            (num_embeddings, embedding_dim), attr=weight_attr,
            default_initializer=Normal() if weight_attr is None else None,
            device=resolve_device(device), dtype=dtype, generator=generator)

    def forward(self, x):
        return NF.embedding(x, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self) -> str:
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Flatten(nn.Module):
    """Dims ``start_axis..stop_axis`` into one (``manipulation.py:95``)."""

    def __init__(self, start_axis: int = 1, stop_axis: int = -1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        if x.dim() == 0:
            return x.reshape(-1)
        return torch.flatten(x, self.start_axis, self.stop_axis)


class Dropout2D(nn.Module):
    """Whole channels of an NCHW / NHWC input."""

    _fn = staticmethod(NF.dropout2d)

    def __init__(self, p: float = 0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return self._fn(x, p=self.p, training=self.training,
                        data_format=self.data_format)


class Dropout3D(Dropout2D):
    _fn = staticmethod(NF.dropout3d)

    def __init__(self, p: float = 0.5, data_format="NCDHW", name=None):
        super().__init__(p, data_format)


class AlphaDropout(nn.Module):
    def __init__(self, p: float = 0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return NF.alpha_dropout(x, p=self.p, training=self.training)
