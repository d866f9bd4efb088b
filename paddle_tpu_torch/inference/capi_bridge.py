"""Marshalling bridge for a C inference API (port of
``paddle_tpu/inference/capi_bridge.py``).

A C host embedding CPython calls these helpers; payloads cross the
boundary as raw bytes + (shape, dtype), and predictors are held behind
integer handles. ``device="cpu"`` maps to ``Config.disable_gpu()``;
``"auto"`` takes the program's own device (CUDA for a program exported
on the card, which raises without a GPU). The C library itself
(``native/pt_capi.cc``) waits with the rest of ``native/`` (ROADMAP.md
3(e)).
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Tuple

import numpy as np

_handles: Dict[int, "object"] = {}
_ids = itertools.count(1)

_DTYPES = {"float32": np.float32, "float16": np.float16,
           "int32": np.int32, "int64": np.int64, "uint8": np.uint8,
           "bool": np.bool_}


def create(prefix: str, precision: str = "float32",
           device: str = "auto") -> int:
    from .predictor import Config, Predictor
    cfg = Config(prefix)
    cfg.set_precision(precision)
    if device == "cpu":
        cfg.disable_gpu()
    h = next(_ids)
    _handles[h] = Predictor(cfg)
    return h


def _p(h: int):
    p = _handles.get(h)
    if p is None:
        raise KeyError(f"invalid predictor handle {h}")
    return p


def input_names(h: int) -> List[str]:
    return _p(h).get_input_names()


def set_input(h: int, name: str, data: bytes, shape: Tuple[int, ...],
              dtype: str) -> None:
    arr = np.frombuffer(data, _DTYPES[dtype]).reshape(shape)
    _p(h).get_input_handle(name).copy_from_cpu(arr)


def run(h: int) -> int:
    p = _p(h)
    p.run()
    return len(p.get_output_names())


def output_names(h: int) -> List[str]:
    return _p(h).get_output_names()


def get_output(h: int, name: str) -> Tuple[bytes, Tuple[int, ...], str]:
    arr = np.ascontiguousarray(_p(h).get_output_handle(name).copy_to_cpu())
    return arr.tobytes(), tuple(int(s) for s in arr.shape), str(arr.dtype)


def destroy(h: int) -> None:
    _handles.pop(h, None)
