"""int8 KV-cache quantization (port of ``paddle_tpu/quantization/quant.py``
``quantize_kv`` / ``dequantize_kv``, :325-354), the host-side KV
blob scale math of the prefix cache's spill codecs (:356-430), and
weight-only int8 linears (``quant_dequant``, ``WeightOnlyInt8Linear``,
``convert_to_weight_only_int8``, :46-61, :427-527).

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

from typing import Optional

import numpy as np
import torch
from torch import nn

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


def quant_dequant(x: torch.Tensor, bits: int = 8,
                  axis: Optional[int] = None):
    """Symmetric abs-max quantization (``quant.py:46-61``): ``(q int8,
    scale float32)`` on ``x``'s device with ``q = clip(round(x / s *
    qmax))``, ``qmax = 2**(bits-1) - 1``; one scale for the tensor, or
    one per index of ``axis``. Each step runs in ``x``'s dtype, as the
    JAX package's numpy does, so the bytes are equal."""
    raw = x.detach()
    qmax = float(2 ** (bits - 1) - 1)
    if axis is None:
        scale = raw.abs().amax()
        q = torch.clamp(torch.round(raw / torch.clamp_min(scale, 1e-8)
                                    * qmax), -qmax, qmax)
        return q.to(torch.int8), scale.to(torch.float32)
    mv = torch.movedim(raw, axis, 0)
    scale = mv.reshape(mv.shape[0], -1).abs().amax(dim=1)
    bshape = (-1,) + (1,) * (mv.dim() - 1)
    q = torch.clamp(torch.round(mv / torch.clamp_min(scale, 1e-8)
                                .reshape(bshape) * qmax), -qmax, qmax)
    return torch.movedim(q, 0, axis).to(torch.int8), scale.to(torch.float32)


class WeightOnlyInt8Linear(nn.Module):
    """Weight-only int8 linear (``quant.py:427-474``): the ``[in, out]``
    weight quantized per output channel into the buffers ``weight_int8``
    (int8) and ``weight_scale`` (float32), the bias kept as it was. The
    product runs in the activation's dtype and the scale applies to its
    output: ``(x @ weight_int8) * (weight_scale / 127) (+ bias)``. It has
    no ``weight``, so the fused epilogues and the fused lm head decline
    it (``models/gpt.py`` ``head_params``, ``_fused_epilogue_params``)."""

    def __init__(self, inner: nn.Module):
        super().__init__()
        q, s = quant_dequant(inner.weight, 8, axis=1)
        self.register_buffer("weight_int8", q)
        self.register_buffer("weight_scale", s)
        self.bias = getattr(inner, "bias", None)
        self.in_features = inner.weight.shape[0]
        self.out_features = inner.weight.shape[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.matmul(x, self.weight_int8.to(x.dtype))
        out = out * (self.weight_scale.to(x.dtype) / KV_QMAX_INT8)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out


def _linear_types(extra_types=()):
    from ..nn.layers import ColumnParallelLinear, Linear, RowParallelLinear
    return (Linear, ColumnParallelLinear, RowParallelLinear, *extra_types)


def convert_to_weight_only_int8(model: nn.Module, extra_types=()) -> int:
    """Swap every ``Linear``, ``ColumnParallelLinear`` and
    ``RowParallelLinear`` (exactly those types, plus ``extra_types``) for
    a :class:`WeightOnlyInt8Linear` in place, and return how many were
    swapped (``quant.py:477-527``). Embeddings and norms stay float, so a
    tied lm head stays the float ``wte``: GPT converts 4 layers a block.
    The converted model's weights are new tensors: a CUDA graph captured
    before reads the old ones, and the graph runners key on the
    addresses to recapture."""
    types = _linear_types(extra_types)
    count = 0
    with torch.no_grad():
        for parent in list(model.modules()):
            for name, sub in list(parent.named_children()):
                if type(sub) in types:
                    setattr(parent, name, WeightOnlyInt8Linear(sub))
                    count += 1
    return count
