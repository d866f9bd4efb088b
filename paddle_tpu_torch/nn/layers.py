"""The layers GPT serving and training need, in the JAX package's
conventions.

- ``Linear`` keeps the JAX layout: weight ``[in, out]``, ``y = x @ W +
  b`` (``paddle_tpu/distributed/mp_layers.py:128,158``), so checkpoints
  load without transposes and the tests compare like with like.
- ``ColumnParallelLinear`` / ``RowParallelLinear`` /
  ``VocabParallelEmbedding`` are their single-device meaning: a plain
  ``Linear`` / ``Embedding``. Tensor-parallel serving is not ported yet.
- ``gelu`` is the tanh form the GPT MLP uses.
- ``Dropout`` (``paddle_tpu/nn/common.py:72``) draws from the
  ``core.rng.key_scope`` generator that ``jit.TrainStep`` opens, not
  from torch's global one; ``ParallelCrossEntropy``
  (``distributed/mp_layers.py:178-190``) is its single-device meaning,
  the per-position hard-label cross entropy.

Parameters are created on an explicit ``device`` and initialised from an
explicit ``torch.Generator`` (normal(0, std) weights, zero biases, unit
layer-norm scales).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import nn_functional as NF


def _normal(shape, std: float, device, dtype, generator) -> nn.Parameter:
    w = torch.empty(shape, device=device, dtype=dtype)
    w.normal_(0.0, std, generator=generator)
    return nn.Parameter(w)


class Linear(nn.Module):
    """``y = x @ weight + bias`` with ``weight`` of shape ``[in, out]``."""

    def __init__(self, in_features: int, out_features: int,
                 has_bias: bool = True, *, device=None,
                 dtype=torch.float32, std: float = 0.02,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = _normal((in_features, out_features), std, device,
                              dtype, generator)
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device,
                                              dtype=dtype))
                     if has_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.matmul(x, self.weight)
        if self.bias is not None:
            out = out + self.bias
        return out


class ColumnParallelLinear(Linear):
    """Single-device ColumnParallelLinear: a plain ``Linear``."""


class RowParallelLinear(Linear):
    """Single-device RowParallelLinear: a plain ``Linear``."""


class Embedding(nn.Module):
    """Row lookup into ``weight [num_embeddings, dim]``."""

    def __init__(self, num_embeddings: int, dim: int, *, device=None,
                 dtype=torch.float32, std: float = 0.02,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = _normal((num_embeddings, dim), std, device, dtype,
                              generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)


class VocabParallelEmbedding(Embedding):
    """Single-device VocabParallelEmbedding: a plain ``Embedding``."""


class LayerNorm(nn.Module):
    """Layer norm over the last dim with ``weight``/``bias`` named as in
    the JAX package's checkpoints. An input of another dtype than the
    parameters (bf16 activations with the bf16 recipe's fp32 norms) is
    normalised and scaled in the parameters' dtype and returned in its
    own, as the JAX function multiplies by its fp32 weight and casts
    back (``ops/nn_functional.py`` ``layer_norm``); PyTorch's CUDA layer
    norm takes no mixed dtypes."""

    def __init__(self, dim: int, epsilon: float = 1e-5, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.epsilon = float(epsilon)
        self.weight = nn.Parameter(torch.ones(dim, device=device,
                                              dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device,
                                             dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != self.weight.dtype:
            return F.layer_norm(x.to(self.weight.dtype), (x.shape[-1],),
                                self.weight, self.bias,
                                self.epsilon).to(x.dtype)
        return F.layer_norm(x, (x.shape[-1],), self.weight, self.bias,
                            self.epsilon)


class Dropout(nn.Module):
    """``nn_functional.dropout`` in ``self.training`` mode."""

    def __init__(self, p: float = 0.5, axis=None,
                 mode: str = "upscale_in_train"):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return NF.dropout(x, p=self.p, training=self.training,
                          mode=self.mode, axis=self.axis)

    def extra_repr(self) -> str:
        return f"p={self.p}"


class ParallelCrossEntropy(nn.Module):
    """Per-position cross entropy (``reduction="none"``) that gives 0 at
    ``ignore_index`` labels."""

    def __init__(self, ignore_index: int = -100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, input: torch.Tensor,  # noqa: A002
                label: torch.Tensor) -> torch.Tensor:
        return NF.cross_entropy(input, label, reduction="none",
                                ignore_index=self.ignore_index)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU (``paddle_tpu/models/gpt.py:905``)."""
    return F.gelu(x, approximate="tanh")
