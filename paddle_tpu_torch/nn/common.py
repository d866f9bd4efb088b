"""The JAX package's default-initialised common layers (port of
``paddle_tpu/nn/common.py:18-85``): ``Linear``, ``Identity``,
``Embedding`` and ``Dropout``.

- ``Linear`` keeps the JAX layout (weight ``[in, out]``, ``y = x @ W +
  b``) and draws ``xavier_uniform`` weights and zero biases, as the JAX
  layer's ``create_parameter`` does by default. The GPT layers of
  ``nn/layers.py`` keep their normal(0.02) draws.
- ``Embedding`` draws ``normal(0, 1)`` and zeroes the rows it looks up
  at ``padding_idx``.
- ``Dropout`` is ``nn/layers.py``'s (the ``core.rng.key_scope``
  generator).

Constructors take ``device`` (``None`` means CUDA and raises without a
GPU) and ``generator`` (``None``: the device's default generator).
``ParamAttr`` objects raise: they are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..ops import nn_functional as NF
from . import initializer as init
from .layers import Dropout  # noqa: F401
from .layers import Linear as _Linear


class Identity(nn.Module):
    def forward(self, x):
        return x


class Linear(_Linear):
    """``y = x @ weight + bias``, weight ``[in_features, out_features]``
    (``xavier_uniform``), bias zeros (none for ``bias_attr=False``)."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        init.check_no_attr("Linear", weight_attr=weight_attr,
                           bias_attr=bias_attr)
        super().__init__(in_features, out_features,
                         has_bias=bias_attr is not False,
                         device=resolve_device(device), dtype=dtype,
                         generator=generator)

    @staticmethod
    def _draw_weight(shape, std, device, dtype, generator) -> nn.Parameter:
        return init.xavier_uniform(shape, device=device, dtype=dtype,
                                   generator=generator)

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
        init.check_no_attr("Embedding", weight_attr=weight_attr)
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self.weight = init.normal((num_embeddings, embedding_dim),
                                  device=resolve_device(device),
                                  dtype=dtype, generator=generator)

    def forward(self, x):
        return NF.embedding(x, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self) -> str:
        return f"{self._num_embeddings}, {self._embedding_dim}"
