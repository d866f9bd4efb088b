"""The default initializers of the JAX package's layers (port of
``paddle_tpu/nn/initializer.py:53-96``, ``Normal``, ``Uniform`` and
``XavierUniform``, as ``resolve_initializer`` picks them by default:
``xavier_uniform`` weights and zero biases).

Only what the port's layers draw from is here. ``ParamAttr`` and the
rest of the initializers are not ported yet (ROADMAP.md, Queue 1 item
3(b)); the layers raise when given one.

Each function draws in float32 from an explicit ``torch.Generator``
(``None``: the device's default generator) and returns a
``nn.Parameter`` of ``dtype``. Torch's streams are not JAX's, so weights
cross between the packages through ``nn.layer.load_jax_state``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


def normal(shape, *, device=None, dtype=torch.float32,
           generator: Optional[torch.Generator] = None) -> nn.Parameter:
    """``Normal()`` at its defaults: mean 0, std 1."""
    w = torch.empty(shape, device=device, dtype=torch.float32)
    w.normal_(0.0, 1.0, generator=generator)
    return nn.Parameter(w.to(dtype))


def uniform(shape, low: float, high: float, *, device=None,
            dtype=torch.float32,
            generator: Optional[torch.Generator] = None) -> nn.Parameter:
    w = torch.empty(shape, device=device, dtype=torch.float32)
    w.uniform_(low, high, generator=generator)
    return nn.Parameter(w.to(dtype))


def xavier_uniform(shape, *, device=None, dtype=torch.float32,
                   generator: Optional[torch.Generator] = None
                   ) -> nn.Parameter:
    """Uniform in ``±sqrt(6 / (fan_in + fan_out))`` for a 2-D ``[in,
    out]`` weight (the JAX package's ``_fans`` of one)."""
    fi, fo = shape
    limit = math.sqrt(6.0 / (fi + fo))
    return uniform(shape, -limit, limit, device=device, dtype=dtype,
                   generator=generator)


def check_no_attr(owner: str, **attrs) -> None:
    """Raise for a ``ParamAttr`` (or any attribute object): only None,
    and False where the JAX layer reads it as "no bias", are ported."""
    for name, attr in attrs.items():
        if attr is not None and attr is not False:
            raise NotImplementedError(
                f"{owner}: {name} objects (ParamAttr, initializers) are "
                f"not yet ported, see ROADMAP.md")
