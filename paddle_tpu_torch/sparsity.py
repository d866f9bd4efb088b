"""Structured n:m sparsity (port of ``paddle_tpu/sparsity.py``; the
reference's ASP, ``python/paddle/fluid/contrib/sparsity/``): 2:4 masks
on the prunable weights (:func:`prune_model`), an optimizer whose
updates keep them (:func:`decorate`), and :func:`check_sparsity`.

As in the JAX package this is model compression (mask-enforced
training, smaller checkpoints): the products stay dense. The masks are
computed in numpy on the host with the JAX package's rule, so they are
bitwise its masks; the JAX function loops over rows and groups in
Python, the port sorts every group of the weight in one ``np.argsort``
call (the same per-row sort, so ties fall the same way).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

# id(parameter) -> its mask (the parameter's dtype and device)
_MASKS: Dict[int, torch.Tensor] = {}


def _host(weight) -> np.ndarray:
    if torch.is_tensor(weight):
        return weight.detach().cpu().numpy()
    return np.asarray(weight)


def compute_mask_2d_best(weight, n: int = 2, m: int = 4) -> np.ndarray:
    """n:m sparsity along the last axis: keep the ``n`` largest
    magnitudes of every ``m`` (a trailing remainder of fewer than ``m``
    columns is kept whole). A boolean numpy mask of ``weight``'s
    shape."""
    w = _host(weight)
    flat = np.abs(w.reshape(-1, w.shape[-1]))
    mask = np.ones_like(flat, dtype=bool)
    cols = flat.shape[1]
    usable = cols - cols % m
    groups = flat[:, :usable].reshape(-1, m)
    keep = np.argsort(-groups, axis=1)[:, :n]
    gmask = np.zeros_like(groups, dtype=bool)
    np.put_along_axis(gmask, keep, True, axis=1)
    mask[:, :usable] = gmask.reshape(flat.shape[0], usable)
    return mask.reshape(w.shape)


def check_sparsity(weight, n: int = 2, m: int = 4) -> bool:
    """Whether every full group of ``m`` along the last axis holds at
    most ``n`` nonzeros."""
    w = _host(weight)
    flat = (w.reshape(-1, w.shape[-1]) != 0)
    cols = flat.shape[1]
    usable = cols - cols % m
    groups = flat[:, :usable].reshape(-1, m)
    return bool((groups.sum(axis=1) <= n).all())


def _prunable(name: str, p: torch.Tensor) -> bool:
    return (p is not None and p.dim() == 2 and p.shape[-1] % 4 == 0 and
            "weight" in name)


def prune_model(model: nn.Module, n: int = 2, m: int = 4,
                mask_algo: str = "mask_1d") -> Dict[str, np.ndarray]:
    """Apply n:m masks to every prunable weight (2-D, a last axis that
    is a multiple of 4, ``weight`` in its name) in place and remember
    them, so a :func:`decorate`-d optimizer applies them again after each
    update. Returns ``{name: mask}`` (numpy)."""
    masks = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if _prunable(name, p):
                mask = compute_mask_2d_best(p, n, m)
                t = torch.as_tensor(mask, device=p.device).to(p.dtype)
                p.mul_(t)
                _MASKS[id(p)] = t
                masks[name] = mask
    return masks


def decorate(optimizer):
    """Wrap the optimizer's update (``_step``, which both ``step()`` and
    ``jit.TrainStep`` run) so the pruned weights are masked again after
    it (the reference's ``OptimizerWithSparsityGuarantee``)."""
    orig = optimizer._step

    def _step(lr):
        orig(lr)
        with torch.no_grad():
            for _, p in optimizer._named or ():
                mask = _MASKS.get(id(p))
                if mask is not None:
                    p.mul_(mask)

    optimizer._step = _step
    return optimizer


def reset_masks() -> None:
    _MASKS.clear()
