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


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype a tensor of ``dtype`` travels as in a host state
    dict. numpy has no bfloat16: bf16 travels as its bit patterns in
    the prefix cache's ``BF16`` dtype, as bf16 pages do. Raises for a
    dtype outside the map."""
    if dtype == torch.bfloat16:
        from ..serving.prefix_cache import BF16
        return BF16
    try:
        return _NUMPY_DTYPES[dtype]
    except KeyError:
        raise TypeError(f"no host dtype for {dtype}") from None


_NUMPY_DTYPES = {torch.float32: np.dtype(np.float32),
                 torch.float64: np.dtype(np.float64),
                 torch.float16: np.dtype(np.float16),
                 torch.int8: np.dtype(np.int8),
                 torch.uint8: np.dtype(np.uint8),
                 torch.int16: np.dtype(np.int16),
                 torch.int32: np.dtype(np.int32),
                 torch.int64: np.dtype(np.int64),
                 torch.bool: np.dtype(np.bool_)}


def _to_host(t: torch.Tensor) -> np.ndarray:
    # a copy even on the CPU, where .cpu() would return the tensor
    # itself: a snapshot must not change when the model is later loaded
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(numpy_dtype(t.dtype))
    return t.numpy()


def _from_host(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    if arr.dtype == numpy_dtype(torch.bfloat16):
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def checkpoint_state(model: nn.Module) -> Dict[str, np.ndarray]:
    """A snapshot of the model's parameters and persistent buffers as
    host numpy arrays keyed by structured name, the JAX package's keys;
    bf16 tensors as ``BF16`` bit patterns (``numpy_dtype``). The arrays
    are copies on every device, so loading other weights into the model
    later leaves them as they were."""
    return {name: _to_host(t) for name, t in model.state_dict().items()}


def _convert_for_state(model: nn.Module, state: Dict[str, Any]) -> None:
    """Where ``state`` holds a weight-only int8 layer (``X.weight_int8``
    and ``X.weight_scale``, no ``X.weight``) and the model a float
    linear at ``X``, convert that layer in place first, so the state of
    a converted JAX model loads into a float port model."""
    from ..quantization.quant import WeightOnlyInt8Linear, _linear_types
    types = _linear_types()
    for name, sub in list(model.named_modules()):
        pre = f"{name}." if name else ""
        if (type(sub) in types and f"{pre}weight_int8" in state
                and f"{pre}weight" not in state):
            parent_name, _, attr = name.rpartition(".")
            setattr(model.get_submodule(parent_name), attr,
                    WeightOnlyInt8Linear(sub))


def load_jax_state(model: nn.Module, state: Dict[str, Any]) -> None:
    """Copy ``state`` (name -> array) into the model's parameters and
    buffers in place (``copy_``: every tensor keeps its storage, so a
    CUDA graph captured before reads the new values). Missing or
    unexpected keys and shape mismatches raise. The copies bump each
    tensor's version counter, which is what a cache keyed on
    ``(data_ptr(), _version)`` sees. The state of a model converted by
    ``convert_to_weight_only_int8`` converts the matching float layers
    first (new tensors, so graphs captured before are rebuilt), then
    loads its int8 weights and scales byte for byte."""
    _convert_for_state(model, state)
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"state does not match the model: missing "
                       f"{missing[:4]}, unexpected {extra[:4]}")
    with torch.no_grad():
        for name, t in own.items():
            src = _from_host(state[name])
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                                 f"{tuple(t.shape)}")
            t.copy_(src.to(dtype=t.dtype))
