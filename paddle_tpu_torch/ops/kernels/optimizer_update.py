"""The Adam / AdamW update of a list of tensors: one CUDA pass
(``csrc/adam_update.cu``) and its plain version.

The port's own kernel, with no TPU counterpart: the JAX package traces
the update (``paddle_tpu/optimizer/optimizer.py`` ``Adam._update`` with
``_apply_flat``'s decay) into its jitted train step, where XLA fuses it
into one loop a parameter, or a dtype group under ``fuse_optimizer``.
Eager PyTorch has no such fusion, so :func:`adam_update` does it by
hand: for each element of each tensor it reads p, g, m, v once and
writes p, m, v once.

:func:`adam_update_reference` is the plain version: the eager chain of
PyTorch ops the optimizer ran before the kernel, one tensor at a time.
On the card the kernel gives its bits exactly (the source says how);
the wrapper takes it only for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import numpy as np
import torch

from . import _build

# decay modes of the kernel: none, L2 added to the gradient (Adam),
# decoupled (AdamW)
DECAY_NONE, DECAY_L2, DECAY_DECOUPLED = 0, 1, 2
# (param dtype, slot dtype) pairs the kernel takes
KERNEL_DTYPES = ((torch.float32, torch.float32),
                 (torch.bfloat16, torch.bfloat16),
                 (torch.bfloat16, torch.float32))
MAX_TENSORS = 512  # csrc/adam_update.cu kMaxTensors: tensors a launch


def bias_corrections(beta1: float, beta2: float, step: int):
    """``1 - beta ** step`` for both moments, in float32 as the JAX step
    takes them (a float32 step and float32 betas)."""
    s = np.float32(step)
    one = np.float32(1.0)
    return (one - np.float32(beta1) ** s, one - np.float32(beta2) ** s)


def adam_update_reference(params: Sequence[torch.Tensor],
                          grads: Sequence[torch.Tensor],
                          exp_avgs: Sequence[torch.Tensor],
                          exp_avg_sqs: Sequence[torch.Tensor], *, lr: float,
                          beta1: float, beta2: float, eps: float, step: int,
                          weight_decay: float = 0.0,
                          decay: int = DECAY_NONE) -> None:
    """The plain version, in place: per tensor, the eager chain of the
    JAX rule (``optimizer.py`` ``Adam._update`` and ``_apply_flat``):
    L2 adds ``wd * p`` to the gradient before the moments; decoupled
    decay subtracts ``p * (lr * wd)`` (the value before the update, the
    product taken in float32) after it; the new value is computed in the
    slots' dtype and stored in the parameter's."""
    lr = np.float32(lr)
    bc1, bc2 = (float(b) for b in bias_corrections(beta1, beta2, step))
    lr_wd = float(lr * np.float32(weight_decay))
    for p, g, m, v in zip(params, grads, exp_avgs, exp_avg_sqs):
        if decay == DECAY_L2:
            g = g + weight_decay * p
        dec = p * lr_wd if decay == DECAY_DECOUPLED else None
        g = g.to(m.dtype)
        m.mul_(beta1).add_(g * (1 - beta1))
        v.mul_(beta2).add_(g * (1 - beta2) * g)
        upd = (m / bc1).mul_(float(lr)).div_((v / bc2).sqrt_().add_(eps))
        nv = (p.to(m.dtype) - upd).to(p.dtype)
        if dec is not None:
            nv = nv - dec
        p.copy_(nv)


def _check(params, grads, exp_avgs, exp_avg_sqs):
    """One CUDA device, contiguous tensors, shared shapes, and one
    (param, slot) dtype pair of ``KERNEL_DTYPES`` for the whole list."""
    n = len(params)
    if not (len(grads) == len(exp_avgs) == len(exp_avg_sqs) == n):
        raise ValueError("adam_update: lists of different lengths")
    pd, sd = params[0].dtype, exp_avgs[0].dtype
    if (pd, sd) not in KERNEL_DTYPES:
        raise TypeError(f"adam_update: params {pd} with slots {sd} are not "
                        f"taken by the kernel")
    for p, g, m, v in zip(params, grads, exp_avgs, exp_avg_sqs):
        _build.require_cuda("adam_update", p, g, m, v)
        if p.dtype != pd or g.dtype != pd or m.dtype != sd or v.dtype != sd:
            raise TypeError("adam_update: one param dtype (gradients "
                            "alike) and one slot dtype per call")
        if not (g.shape == m.shape == v.shape == p.shape):
            raise ValueError("adam_update: a gradient or slot shape "
                             "differs from its parameter's")
    if len({p.device for p in params}) != 1:
        raise ValueError("adam_update: tensors on more than one device")


def adam_update(params: List[torch.Tensor], grads: List[torch.Tensor],
                exp_avgs: List[torch.Tensor], exp_avg_sqs: List[torch.Tensor],
                *, lr: float, beta1: float, beta2: float, eps: float,
                step: int, weight_decay: float = 0.0,
                decay: int = DECAY_NONE) -> None:
    """Update ``params`` and both moments in place. CPU tensors take
    :func:`adam_update_reference`; CUDA tensors one kernel launch per
    ``MAX_TENSORS`` non-empty tensors (one for any model's dtype group
    here), on the current stream, without a host sync."""
    if not params:
        return
    if params[0].device.type == "cpu":
        adam_update_reference(params, grads, exp_avgs, exp_avg_sqs, lr=lr,
                              beta1=beta1, beta2=beta2, eps=eps, step=step,
                              weight_decay=weight_decay, decay=decay)
        return
    _check(params, grads, exp_avgs, exp_avg_sqs)
    rows = [(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
             p.numel()) for p, g, m, v in
            zip(params, grads, exp_avgs, exp_avg_sqs) if p.numel() > 0]
    f32 = np.float32
    lr32 = f32(lr)
    bc1, bc2 = bias_corrections(beta1, beta2, step)
    # the scalars as PyTorch's eager CUDA ops take them: Python floats
    # cast to float32, and x / bc as x * (1 / bc) with the reciprocal
    # taken on the host in float32
    scalars = [float(lr32), float(f32(beta1)), float(f32(1 - beta1)),
               float(f32(beta2)), float(f32(1 - beta2)),
               float(f32(1.0) / bc1), float(f32(1.0) / bc2), float(f32(eps)),
               float(f32(weight_decay)),
               float(lr32 * f32(weight_decay))]
    codes = (_build.DTYPE_CODES[params[0].dtype],
             _build.DTYPE_CODES[exp_avgs[0].dtype])
    lib = _build.lib()
    stream = _build.stream(params[0].device)
    for i in range(0, len(rows), MAX_TENSORS):
        chunk = rows[i:i + MAX_TENSORS]
        table = (ctypes.c_longlong * (5 * len(chunk)))(
            *[x for row in chunk for x in row])
        err = lib.pt_adam_update(table, len(chunk), *codes, *scalars,
                                 int(decay), stream)
        _build.check(err, "adam_update")
        adam_update.launches += 1


adam_update.launches = 0
