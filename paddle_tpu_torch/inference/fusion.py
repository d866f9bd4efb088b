"""Eval-graph BN folding (port of ``paddle_tpu/inference/fusion.py:
36-171``).

A BatchNorm that follows a convolution folds into the conv's weights at
eval time: ``W' = W * gamma / sqrt(var + eps)`` per output channel (in
f32, cast back to W's dtype) and ``b' = beta + (b - mean) * gamma /
sqrt(var + eps)``; the BN becomes an ``Identity``. Pairs are found as
in the JAX package: adjacent ``(Conv2D, BatchNorm2D)`` children of a
``Sequential``, and sibling attributes ``convN`` / ``bnN`` of any other
module (the ResNet block convention). The pass refuses a model in train
mode. A folded block no longer holds three ``BatchNorm2D``s, so the
fused-bottleneck gate declines it, as in the JAX package.

The weights are written in place (``copy_``), which bumps their version
counters.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from ..nn.common import Identity
from ..nn.conv import Conv2D
from ..nn.norm import BatchNorm2D


def _fold_pair(conv: Conv2D, bn: BatchNorm2D) -> None:
    w = conv.weight
    n = bn._num_features
    with torch.no_grad():
        gamma = bn.weight if bn.weight is not None else \
            torch.ones(n, device=w.device)
        beta = bn.bias if bn.bias is not None else \
            torch.zeros(n, device=w.device)
        scale = gamma / torch.sqrt(bn._variance + bn._epsilon)
        w.copy_((w.to(torch.float32) * scale.reshape(-1, 1, 1, 1))
                .to(w.dtype))
        old_b = conv.bias if conv.bias is not None else 0.0
        new_b = beta + (old_b - bn._mean) * scale
        if conv.bias is not None:
            conv.bias.copy_(new_b.to(conv.bias.dtype))
        else:
            conv.bias = nn.Parameter(new_b.to(w.dtype), requires_grad=False)


def _foldable(conv, bn) -> bool:
    """The conv's output channels must be what the BN normalises."""
    return (type(conv) is Conv2D and isinstance(bn, BatchNorm2D) and
            conv.weight.shape[0] == bn._num_features)


def _conv_bn_attr_pairs(layer: nn.Module):
    """(conv, bn, bn_attr_name) for the convN/bnN naming convention; it
    assumes the post-norm order (conv feeds bn), as the JAX pass does."""
    subs = dict(layer._modules)
    for name, sub in list(subs.items()):
        m = re.fullmatch(r"conv(\d*)", name)
        if not m or not isinstance(sub, Conv2D):
            continue
        bn_name = f"bn{m.group(1)}"
        bn = subs.get(bn_name)
        if bn is not None and _foldable(sub, bn):
            yield sub, bn, bn_name


def find_foldable_pairs(model: nn.Module):
    """Read-only scan for ``(parent, kind, conv, bn, bn_key)`` fold sites,
    ``kind`` being ``"seq"`` or ``"attr"``."""
    for layer in list(model.modules()):
        if isinstance(layer, nn.Sequential):
            subs = list(layer._modules.items())
            for (_, a), (n2, b) in zip(subs, subs[1:]):
                if _foldable(a, b):
                    yield layer, "seq", a, b, n2
        else:
            for conv, bn, bn_name in _conv_bn_attr_pairs(layer):
                yield layer, "attr", conv, bn, bn_name


def fuse_conv_bn(model: nn.Module) -> int:
    """Fold every recognised Conv2D -> BatchNorm2D pair of ``model`` in
    place; returns the number of folded pairs (53 on ResNet-50). The
    model must be in eval mode: the fold bakes in the running
    statistics."""
    if model.training:
        raise RuntimeError(
            "fuse_conv_bn folds running statistics into the conv weights "
            "and is only valid in eval() mode; call model.eval() first")
    count = 0
    for layer, kind, conv, bn, bn_key in list(find_foldable_pairs(model)):
        _fold_pair(conv, bn)
        if kind == "seq":
            layer._modules[bn_key] = Identity()
        else:
            setattr(layer, bn_key, Identity())
        count += 1
    return count


def fold_preserves_outputs(original: nn.Module, folded: nn.Module,
                           example_inputs, rtol: float = 3e-2) -> bool:
    """Compare the eval forwards of ``original`` and ``folded`` on one
    example (a list of input tensors) or a list of several, element by
    element, relative to ``max(|ref|, 0.1 * max|ref|)`` of each output
    (``fusion.py:120-171``)."""
    def is_single(ex):
        return not ex or not isinstance(ex[0], (tuple, list))

    batches = [example_inputs] if is_single(example_inputs) \
        else example_inputs

    def run(m, ex):
        with torch.no_grad():
            outs = m(*ex)
        leaves = outs if isinstance(outs, (tuple, list)) else [outs]
        return [o.detach().to(torch.float32).cpu().numpy() for o in leaves]

    for ex in batches:
        ref, got = run(original, ex), run(folded, ex)
        if len(ref) != len(got):
            return False
        for r, g in zip(ref, got):
            if r.shape != g.shape:
                return False
            scale = max(float(np.max(np.abs(r))), 1e-6)
            denom = np.maximum(np.abs(r), 0.1 * scale)
            if not np.all(np.abs(r - g) / denom <= rtol):
                return False
    return True
