"""int8 KV-cache quantization (port of ``paddle_tpu/quantization/quant.py``
``quantize_kv`` / ``dequantize_kv``, :325-354) and the host-side KV
blob scale math of the prefix cache's spill codecs (:356-430).

Symmetric per-(token, head) abs-max over the head dim: ``deq = q * s /
qmax`` — the convention the paged-decode kernel applies to int8 pages,
and the one every blob format decodes with (``KV_QMAX_INT8`` = 127,
``KV_QMAX_INT4`` = 7). The ``*_np`` twins are pure numpy: they run on
page blocks already copied off the device (``serving/prefix_cache.py
pack_page_blob``), and are bitwise the JAX package's on the same arrays.
int4 packs two values a byte along the head dim (low nibble first,
``ceil(D / 2)`` bytes a row).
"""

from __future__ import annotations

import numpy as np
import torch

KV_QMAX_INT8 = 127.0
KV_QMAX_INT4 = 7.0


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


def quantize_kv_np(x: np.ndarray, eps: float = 1e-8):
    """Numpy twin of :func:`quantize_kv`: ``q = clip(round(x / s *
    127))`` int8, scales float32. Returns ``(q [..., H, D], s [...,
    H])``."""
    raw = np.asarray(x, np.float32)
    s = np.maximum(np.max(np.abs(raw), axis=-1), eps).astype(np.float32)
    q = np.clip(np.round(raw / s[..., None] * KV_QMAX_INT8),
                -KV_QMAX_INT8, KV_QMAX_INT8).astype(np.int8)
    return q, s


def dequantize_kv_np(q: np.ndarray, scale: np.ndarray,
                     dtype=np.float32) -> np.ndarray:
    """Numpy twin of :func:`dequantize_kv`: deq = q * s / 127."""
    return (np.asarray(q, np.float32) *
            (np.asarray(scale, np.float32) / KV_QMAX_INT8)[..., None]
            ).astype(dtype)


def quantize_kv_int4_np(x: np.ndarray, eps: float = 1e-8):
    """Symmetric int4 KV quantization: per-(token, head) abs-max scales,
    ``q = clip(round(x / s * 7), -7, 7)``, two nibbles a byte along the
    head dim (low nibble = even index; an odd head dim zero-pads the
    last high nibble). Returns ``(packed uint8 [..., H, ceil(D/2)], s
    float32 [..., H])``."""
    raw = np.asarray(x, np.float32)
    s = np.maximum(np.max(np.abs(raw), axis=-1), eps).astype(np.float32)
    q = np.clip(np.round(raw / s[..., None] * KV_QMAX_INT4),
                -KV_QMAX_INT4, KV_QMAX_INT4).astype(np.int8)
    d = q.shape[-1]
    if d % 2:
        q = np.concatenate(
            [q, np.zeros(q.shape[:-1] + (1,), np.int8)], axis=-1)
    # two's-complement nibbles: q & 0xF maps [-7, 7] into [0, 15]
    lo = (q[..., 0::2].astype(np.uint8)) & 0x0F
    hi = (q[..., 1::2].astype(np.uint8)) & 0x0F
    return (lo | (hi << 4)).astype(np.uint8), s


def dequantize_kv_int4_np(packed: np.ndarray, scale: np.ndarray,
                          head_dim: int, dtype=np.float32) -> np.ndarray:
    """Inverse of :func:`quantize_kv_int4_np`: unpack the nibbles
    (sign-extended), deq = q * s / 7, cut back to ``head_dim``."""
    p = np.asarray(packed, np.uint8)
    lo = (p & 0x0F).astype(np.int8)
    hi = ((p >> 4) & 0x0F).astype(np.int8)
    lo = np.where(lo > 7, lo - 16, lo)
    hi = np.where(hi > 7, hi - 16, hi)
    q = np.empty(p.shape[:-1] + (p.shape[-1] * 2,), np.int8)
    q[..., 0::2] = lo
    q[..., 1::2] = hi
    q = q[..., :head_dim]
    return (q.astype(np.float32) *
            (np.asarray(scale, np.float32) / KV_QMAX_INT4)[..., None]
            ).astype(dtype)
