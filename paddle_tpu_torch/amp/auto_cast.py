"""``auto_cast``: the eager autocast context (port of
``paddle_tpu/amp/auto_cast.py``).

The JAX package casts in its dispatch layer: every op asks
``amp_target_dtype(name)`` (``paddle_tpu/dispatch.py:117-121``), and a
white-list op (matmul- and conv-class) casts its floating inputs down to
the amp dtype, a black-list op (numerically sensitive) up to float32
under O1, inside the op's vjp, so gradients come back in each input's
own dtype. The port has no dispatch layer: each of its functions whose
JAX op is on a list calls :func:`amp_cast` with that op's name where
the JAX package dispatches it (``Linear``, the tied head's ``matmul``,
``scaled_dot_product_attention``, ``layer_norm``, ``cross_entropy``,
the loss ``mean``, ``conv2d``, ``batch_norm``). The casts are
``Tensor.to``, which autograd differentiates, so gradients return in
the parameters' dtype.

``torch.autocast`` is not used: its op lists are not the reference's,
and it caches the casts of weights across calls. The lists below are
the JAX package's, and they alone decide which ops cast. The state is
thread-local, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Optional, Set, Tuple

import torch

# the reference's white list (imperative/amp_auto_cast.cc): matmul- and
# conv-class ops
white_list: Set[str] = {
    "matmul", "mm", "bmm", "dot", "addmm", "linear", "conv1d", "conv2d",
    "conv3d", "conv1d_transpose", "conv2d_transpose", "einsum",
    "scaled_dot_product_attention", "flash_attention",
}

# the reference's black list: numerically sensitive ops stay fp32
black_list: Set[str] = {
    "exp", "log", "log2", "log10", "log1p", "logsumexp", "mean", "sum",
    "softmax", "log_softmax", "cross_entropy", "softmax_with_cross_entropy",
    "layer_norm", "rms_norm", "batch_norm", "instance_norm", "group_norm",
    "local_response_norm", "nll_loss", "binary_cross_entropy", "kl_div",
    "binary_cross_entropy_with_logits", "mse_loss", "cosine_similarity",
    "norm", "var", "std", "logcumsumexp", "erf", "erfinv", "pow",
}

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32, "bf16": torch.bfloat16,
           "fp16": torch.float16, "fp32": torch.float32}


def _dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"amp: unsupported dtype {dtype!r}") from None


class _AmpTLS(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.custom_white: Set[str] = set()
        self.custom_black: Set[str] = set()
        self.record: Optional[List[Tuple[str, Optional[torch.dtype]]]] = \
            None


_tls = _AmpTLS()


def amp_state() -> Optional[_AmpTLS]:
    """The thread's amp state when ``auto_cast`` is on, else None."""
    return _tls if _tls.enabled else None


def effective_lists():
    return (white_list | _tls.custom_white) - _tls.custom_black, \
        (black_list | _tls.custom_black) - _tls.custom_white


@contextlib.contextmanager
def auto_cast(enable: bool = True, custom_white_list=None,
              custom_black_list=None, level: str = "O1",
              dtype: str = "bfloat16"):
    """Enable autocast for the enclosed eager region (reference:
    ``paddle.amp.auto_cast``)."""
    prev = (_tls.enabled, _tls.dtype, _tls.level, _tls.custom_white,
            _tls.custom_black)
    _tls.enabled = enable
    _tls.dtype = _dtype(dtype)
    _tls.level = level
    _tls.custom_white = set(custom_white_list or ())
    _tls.custom_black = set(custom_black_list or ())
    try:
        yield
    finally:
        (_tls.enabled, _tls.dtype, _tls.level, _tls.custom_white,
         _tls.custom_black) = prev


def current_args() -> dict:
    """The thread's state as :func:`auto_cast` arguments: a recompute on
    another thread (autograd's, in remat's backward) re-enters it."""
    return dict(enable=_tls.enabled, custom_white_list=_tls.custom_white,
                custom_black_list=_tls.custom_black, level=_tls.level,
                dtype=_tls.dtype)


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2 decoration: cast the models' floating parameters and buffers to
    the amp dtype in place (reference: ``paddle.amp.decorate``; JAX
    ``auto_cast.py:79-90``). Returns ``models``, or ``(models,
    optimizers)`` when optimizers are given."""
    model_list = list(models) if isinstance(models, (list, tuple)) \
        else [models]
    if level == "O2":
        for m in model_list:
            m.to(dtype=_dtype(dtype))
    if optimizers is None:
        return models
    return models, optimizers


def amp_target_dtype(name: str) -> Optional[torch.dtype]:
    """The dtype op ``name``'s floating inputs are cast to under the
    active autocast scope, or None to run as they are."""
    wl, bl = effective_lists()
    if name in wl:
        return _tls.dtype
    if name in bl and _tls.level == "O1":
        return torch.float32
    return None


def amp_cast(name: str, *tensors):
    """The port's dispatch hook: ``tensors`` as op ``name`` takes them
    under the thread's autocast state, as a tuple. Floating tensors are
    cast to :func:`amp_target_dtype` (through autograd); None and other
    dtypes pass. Outside ``auto_cast`` the tensors come back as they
    are."""
    if not _tls.enabled:
        return tensors
    target = amp_target_dtype(name)
    if _tls.record is not None:
        _tls.record.append((name, target))
    if target is None:
        return tensors
    return tuple(t.to(target) if isinstance(t, torch.Tensor)
                 and t.is_floating_point() and t.dtype != target else t
                 for t in tensors)


@contextlib.contextmanager
def record_casts():
    """Collect the ``(op name, target dtype or None)`` of every
    :func:`amp_cast` this thread makes under ``auto_cast`` into the
    yielded list (the JAX ``call_fn`` seen by the same ops)."""
    prev = _tls.record
    _tls.record = []
    try:
        yield _tls.record
    finally:
        _tls.record = prev
