"""Moving weights between the JAX package and the port.

The port's modules name their parameters and buffers as the JAX
package's ``Layer`` does (``nn/layer.py:239-252``), so a JAX model's
``state_dict()`` turned into numpy, or ``paddle_tpu.models.gpt.
checkpoint_state``, loads without renaming or transposing: keys such as
``gpt.h.0.attn.qkv_proj.weight (E, 3E)``, ``layer1.0.bn1._mean`` or
``fc.weight (2048, 1000)``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn


def checkpoint_state(model: nn.Module) -> Dict[str, np.ndarray]:
    """The model's parameters and persistent buffers as host numpy arrays
    keyed by structured name, the JAX package's keys."""
    return {name: t.detach().cpu().numpy()
            for name, t in model.state_dict().items()}


def load_jax_state(model: nn.Module, state: Dict[str, Any]) -> None:
    """Copy ``state`` (name -> array) into the model's parameters and
    buffers in place. Missing or unexpected keys and shape mismatches
    raise. The copies bump each tensor's version counter, which is what
    a cache keyed on ``(data_ptr(), _version)`` sees."""
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"state does not match the model: missing "
                       f"{missing[:4]}, unexpected {extra[:4]}")
    with torch.no_grad():
        for name, t in own.items():
            src = torch.from_numpy(np.array(state[name]))
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                                 f"{tuple(t.shape)}")
            t.copy_(src.to(dtype=t.dtype))
