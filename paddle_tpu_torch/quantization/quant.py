"""int8 KV-cache quantization (port of ``paddle_tpu/quantization/quant.py``
``quantize_kv`` / ``dequantize_kv``, :329-354).

Symmetric per-(token, head) abs-max over the head dim: ``deq = q * s /
127`` — the convention the paged-decode kernel applies to int8 pages.
"""

from __future__ import annotations

import torch

KV_QMAX_INT8 = 127.0


def quantize_kv(x: torch.Tensor, eps: float = 1e-8):
    """``(int8 values [..., H, D], float32 scales [..., H])``."""
    xf = x.to(torch.float32)
    s = torch.clamp_min(xf.abs().amax(dim=-1), eps)
    q = torch.clamp(torch.round(xf / s[..., None] * KV_QMAX_INT8),
                    -KV_QMAX_INT8, KV_QMAX_INT8).to(torch.int8)
    return q, s


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: ``q * scale / 127``."""
    return (q.to(torch.float32) *
            (scale.to(torch.float32) / KV_QMAX_INT8)[..., None]).to(dtype)
