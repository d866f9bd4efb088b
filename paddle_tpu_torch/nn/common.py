"""``Identity`` (port of ``paddle_tpu/nn/common.py:43``)."""

from __future__ import annotations

from torch import nn


class Identity(nn.Module):
    def forward(self, x):
        return x
