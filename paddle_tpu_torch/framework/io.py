"""Checkpoint save / load (port of ``paddle_tpu/framework/io.py``):
``save(obj, path)`` and ``load(path)`` of state-dict-like nests (dicts,
lists and tuples of tensors, numpy arrays and Python values), with the
encrypted envelope of :mod:`.crypto` under ``cipher_key``.

The payload is ``torch.save``'s: tensors are written from the CPU (a
CUDA tensor is copied down; a ``Parameter`` stays one), numpy arrays as
tensors tagged to come back as arrays. :func:`load` reads it with
``torch.load(weights_only=True)``, which unpickles tensors, containers
and plain values only; a payload that holds other objects is read with
full unpickling, as the JAX package reads every file (its payload is a
pickle). An encrypted payload's HMAC is checked before either.
"""

from __future__ import annotations

import io
import os
import pickle
from typing import Any, Optional

import numpy as np
import torch

from .crypto import _MAGIC, AESCipher

_NDARRAY = "__pt_ndarray__"


def _to_saveable(obj):
    if isinstance(obj, torch.nn.Parameter):
        return torch.nn.Parameter(obj.detach().cpu(),
                                  requires_grad=obj.requires_grad)
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, np.ndarray):
        return {_NDARRAY: True, "data": torch.from_numpy(
            np.ascontiguousarray(obj))}
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_saveable(v) for v in obj)
    return obj


def _from_saveable(obj, return_numpy: bool = False):
    if isinstance(obj, dict):
        if obj.get(_NDARRAY) is True:
            return obj["data"].numpy()
        return {k: _from_saveable(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_saveable(v, return_numpy) for v in obj)
    if return_numpy and isinstance(obj, torch.Tensor):
        return obj.detach().numpy()
    return obj


def save(obj: Any, path: str, protocol: Optional[int] = None,
         cipher_key: bytes = None) -> None:
    """``paddle.save``: write ``obj`` to ``path``; with ``cipher_key``
    the file is the AES-128-CTR envelope of the payload. ``protocol``
    None is ``torch.save``'s own pickle protocol, the one its
    weights-only reader is written for."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    payload = _to_saveable(obj)
    kw = {} if protocol is None else {"pickle_protocol": protocol}
    if cipher_key is None:
        torch.save(payload, path, **kw)
        return
    buf = io.BytesIO()
    torch.save(payload, buf, **kw)
    blob = AESCipher(cipher_key).encrypt(buf.getvalue())
    with open(path, "wb") as f:
        f.write(blob)


def load(path: str, return_numpy: bool = False, cipher_key: bytes = None,
         **kwargs) -> Any:
    """``paddle.load``: the nest :func:`save` wrote, tensors on the CPU
    (``return_numpy`` makes them numpy arrays)."""
    with open(path, "rb") as f:
        head = f.read(len(_MAGIC))
        if cipher_key is not None:
            src = io.BytesIO(AESCipher(cipher_key).decrypt(head + f.read()))
        elif head == _MAGIC:
            raise ValueError(
                f"{path!r} is an encrypted artifact; pass cipher_key=")
        else:
            src = io.BytesIO(head + f.read())
    try:
        raw = torch.load(src, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        src.seek(0)
        raw = torch.load(src, map_location="cpu", weights_only=False)
    return _from_saveable(raw, return_numpy)
