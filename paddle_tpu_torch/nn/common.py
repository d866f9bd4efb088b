"""The JAX package's common layers (port of ``paddle_tpu/nn/common.py``):
``Linear``, ``Identity``, ``Embedding``, ``Flatten``, the dropouts
``Dropout``, ``Dropout2D``, ``Dropout3D`` and ``AlphaDropout``, the pads
``Pad1D`` / ``Pad2D`` / ``Pad3D`` / ``ZeroPad2D``, the resamplers
``Upsample`` / ``UpsamplingNearest2D`` / ``UpsamplingBilinear2D`` /
``PixelShuffle``, ``Unfold`` / ``Fold``, ``Bilinear``,
``CosineSimilarity`` and ``PairwiseDistance``.

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
- ``Bilinear`` draws its ``[out, in1, in2]`` weight with the default of
  ``create_parameter`` (``xavier_uniform``) and zero biases, as the JAX
  layer does; the resamplers are ``ops/nn_functional.py``'s, with the
  JAX package's semantics (``interpolate`` ignores ``align_corners``
  outside ``"nearest"``, so ``UpsamplingBilinear2D`` is the half-pixel
  antialiased resize there too).

Constructors with parameters take ``device`` (``None`` means CUDA and
raises without a GPU) and ``generator`` (``None``: the device's default
generator).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..amp.auto_cast import amp_cast
from ..device import resolve_device
from ..ops import nn_functional as NF
from .initializer import Normal, create_parameter
from .layers import Dropout  # noqa: F401
from .layers import Linear as _Linear
from .layer import Layer


class Identity(Layer):
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


class Embedding(Layer):
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


class Flatten(Layer):
    """Dims ``start_axis..stop_axis`` into one (``manipulation.py:95``)."""

    def __init__(self, start_axis: int = 1, stop_axis: int = -1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        if x.dim() == 0:
            return x.reshape(-1)
        return torch.flatten(x, self.start_axis, self.stop_axis)


class Dropout2D(Layer):
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


class AlphaDropout(Layer):
    def __init__(self, p: float = 0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return NF.alpha_dropout(x, p=self.p, training=self.training)


class Pad1D(Layer):
    """``ops/nn_functional.py`` ``pad`` over the last (NCL) or middle
    (NLC) dim; an int pads both sides."""

    _n = 2

    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL"):
        super().__init__()
        self._pad = padding if isinstance(padding, (list, tuple)) else \
            [padding] * self._n
        self._mode, self._value, self._fmt = mode, value, data_format

    def forward(self, x):
        return NF.pad(x, self._pad, mode=self._mode, value=self._value,
                      data_format=self._fmt)


class Pad2D(Pad1D):
    _n = 4

    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW"):
        super().__init__(padding, mode, value, data_format)


class Pad3D(Pad1D):
    _n = 6

    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW"):
        super().__init__(padding, mode, value, data_format)

    def forward(self, x):
        return NF.pad3d(x, self._pad, mode=self._mode, value=self._value,
                        data_format=self._fmt)


class ZeroPad2D(Layer):
    def __init__(self, padding, data_format="NCHW"):
        super().__init__()
        self._pad = padding if isinstance(padding, (list, tuple)) else \
            [padding] * 4
        self._fmt = data_format

    def forward(self, x):
        return NF.zeropad2d(x, self._pad, data_format=self._fmt)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW"):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners = mode, align_corners
        self.align_mode = align_mode
        self.data_format = data_format

    def forward(self, x):
        return NF.interpolate(x, self.size, self.scale_factor, self.mode,
                              self.align_corners, self.align_mode,
                              self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW"):
        super().__init__(size, scale_factor, "nearest",
                         align_corners=False, data_format=data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW"):
        super().__init__(size, scale_factor, "bilinear",
                         align_corners=True, data_format=data_format)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor: int, data_format="NCHW"):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return NF.pixel_shuffle(x, self.upscale_factor, self.data_format)


class Bilinear(Layer):
    """``out[b, o] = x1[b] @ weight[o] @ x2[b] + bias[o]``."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype,
                  generator=generator)
        self.weight = create_parameter(
            (out_features, in1_features, in2_features), attr=weight_attr,
            **kw)
        self.bias = None if bias_attr is False else create_parameter(
            (out_features,), attr=bias_attr, is_bias=True, **kw)

    def forward(self, x1, x2):
        return NF.bilinear(x1, x2, self.weight, self.bias)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return NF.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self._args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        k, s, p, d = self._args
        return NF.unfold(x, k, strides=s, paddings=p, dilations=d)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self._args = (output_sizes, kernel_sizes, strides, paddings,
                      dilations)

    def forward(self, x):
        o, k, s, p, d = self._args
        return NF.fold(x, o, k, strides=s, paddings=p, dilations=d)


class PairwiseDistance(Layer):
    """``||x - y + epsilon||_p`` over the last dim."""

    def __init__(self, p: float = 2.0, epsilon: float = 1e-6,
                 keepdim: bool = False, name=None):
        super().__init__()
        self.p = p
        self.epsilon = epsilon
        self.keepdim = keepdim

    def forward(self, x, y):
        (d,) = amp_cast("norm", x - y + self.epsilon)
        return torch.linalg.vector_norm(d, ord=self.p, dim=-1,
                                        keepdim=self.keepdim)
