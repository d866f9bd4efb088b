"""Activation layers (port of ``paddle_tpu/nn/activation.py``)."""

from __future__ import annotations

from torch import nn

from ..ops import nn_functional as NF


class ReLU(nn.Module):
    def forward(self, x):
        return NF.relu(x)
