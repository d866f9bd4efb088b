"""Gradient clipping (port of ``paddle_tpu/optimizer/clip.py``):
``ClipGradByValue``, ``ClipGradByNorm`` (each tensor by its own norm)
and ``ClipGradByGlobalNorm``.

A clip maps a ``{name: grad}`` dict to a dict of clipped gradients, as
in the JAX package. Everything stays on the device: the global norm and
the scale are 0-d tensors, so clipping costs no host synchronisation.
"""

from __future__ import annotations

from typing import Dict

import torch


class GradClipBase:
    def apply(self, grads: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    __call__ = apply


class ClipGradByValue(GradClipBase):
    """Clamp every gradient element to ``[min, max]`` (``min`` defaults
    to ``-max``)."""

    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def apply(self, grads):
        return {k: torch.clamp(g, self.min, self.max)
                for k, g in grads.items()}


class ClipGradByNorm(GradClipBase):
    """Scale each gradient by ``min(clip_norm / max(||g||, 1e-12), 1)``
    with ``||g||`` its own L2 norm, taken in fp32."""

    def __init__(self, clip_norm: float):
        self.clip_norm = float(clip_norm)

    def apply(self, grads):
        out = {}
        for k, g in grads.items():
            g32 = g.to(torch.float32)
            norm = torch.sqrt(torch.sum(torch.square(g32)))
            scale = torch.clamp_max(self.clip_norm / norm.clamp_min(1e-12),
                                    1.0)
            out[k] = (g32 * scale).to(g.dtype)
        return out


class ClipGradByGlobalNorm(GradClipBase):
    """Scale every gradient by ``min(clip_norm / max(||g||, 1e-12), 1)``
    where ``||g||`` is the L2 norm over all of them, taken in fp32."""

    def __init__(self, clip_norm: float):
        self.clip_norm = float(clip_norm)

    def global_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        sq = sum(torch.sum(torch.square(g.to(torch.float32)))
                 for g in grads.values())
        return torch.sqrt(sq)

    def apply(self, grads):
        if not grads:
            return {}
        gnorm = self.global_norm(grads)
        scale = torch.clamp_max(self.clip_norm / gnorm.clamp_min(1e-12), 1.0)
        return {k: (g.to(torch.float32) * scale).to(g.dtype)
                for k, g in grads.items()}
