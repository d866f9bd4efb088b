"""Softmax attention forward: one CUDA kernel behind the flash and the
folded entries.

Port of the forward halves of ``paddle_tpu/ops/pallas/flash_attention.py``
(streaming and single-block kernels) and
``paddle_tpu/ops/pallas/folded_attention.py``. On the TPU these were
three kernels for reasons of Mosaic's tiling (see
``csrc/attention_fwd.cu``); here :func:`attention_fwd` launches one
online-softmax kernel that reads ``[B, S, H, D]`` through strides, and

- :func:`flash_attention` returns ``(out, lse)`` with ``lse`` [B, S, H]
  f32 (the ``flash_attention_lse`` convention, ``flash_attention.py:
  572-586``);
- :func:`folded_attention` returns ``out`` only.

Both are forward only: the backward kernels (TPU #6-#8, #10) belong to
the training slice. The gates keep the JAX package's rules, so the same
shapes reach a kernel as on the TPU.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build

_NEG_INF = -1e30
DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 512
MAX_SINGLE_BLOCK = 1024  # folded_attention.py


def attention_reference(q, k, v, causal: bool = False,
                        scale: Optional[float] = None):
    """Plain version of the kernel: ``(out [B, Sq, H, D] in q.dtype,
    lse [B, Sq, H] f32)``; the causal mask is diagonal-aligned (key j
    visible to query i when j <= i) and masked scores are -1e30, as in
    the TPU kernels."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if causal:
        dev = q.device
        mask = (torch.arange(sk, device=dev)[None, :]
                <= torch.arange(sq, device=dev)[:, None])
        s = torch.where(mask, s, torch.tensor(_NEG_INF, device=dev))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p / den, v.to(torch.float32))
    lse = (m + torch.log(den))[..., 0].transpose(1, 2)
    return out.to(q.dtype), lse.contiguous()


def attention_fwd(q, k, v, causal: bool = False,
                  scale: Optional[float] = None, return_lse: bool = True):
    """The kernel's wrapper: q [B, Sq, H, D], k/v [B, Sk, H, D] (any
    strides with a unit head-dim stride, e.g. slices of the fused QKV
    projection). Returns ``(out, lse or None)``. CPU tensors take the
    plain version."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        out, lse = attention_reference(q, k, v, causal=causal, scale=scale)
        return out, (lse if return_lse else None)
    if d not in (64, 128, 256):
        raise ValueError(f"attention_fwd: head dim {d} not in (64, 128, "
                         f"256)")
    if k.shape != (b, sk, h, d) or v.shape != k.shape:
        raise ValueError(f"attention_fwd: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise TypeError("attention_fwd: q, k and v must share a dtype")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"attention_fwd: {name} is on {t.device}")
        if t.stride(3) != 1:
            raise ValueError(f"attention_fwd: {name} needs a unit "
                             f"head-dim stride")
    dev = q.device
    code = _build.dtype_code(q, "attention_fwd")
    out = torch.empty((b, sq, h, d), device=dev, dtype=q.dtype)
    lse = (torch.empty((b, sq, h), device=dev, dtype=torch.float32)
           if return_lse else None)
    err = _build.lib().pt_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _build.ptr(lse), b, sq, sk, h, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        int(bool(causal)), code, float(scale), int(return_lse),
        _build.stream(dev))
    _build.check(err, "attention_fwd")
    attention_fwd.launches += 1
    return out, lse


attention_fwd.launches = 0


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None):
    """``(out [B, Sq, H, D], lse [B, Sq, H] f32)``: the flash entry."""
    return attention_fwd(q, k, v, causal=causal, scale=scale,
                         return_lse=True)


def folded_attention(q, k, v, causal: bool = False,
                     scale: Optional[float] = None):
    """``out [B, S, H, D]``: the folded entry (no lse)."""
    return attention_fwd(q, k, v, causal=causal, scale=scale,
                         return_lse=False)[0]


def _resolve_blocks(sq, sk, block_q, block_k):
    """``flash_attention.py:589-601``: the largest 128-multiple block
    dividing the sequence, capped at the requested block."""
    def best(s, cap):
        pick = 0
        m = 128
        while m <= min(cap, s):
            if s % m == 0:
                pick = m
            m += 128
        return pick or cap
    return best(sq, block_q), best(sk, block_k)


def flash_attention_supported(q_shape, k_shape,
                              block_q: int = DEFAULT_BLOCK_Q,
                              block_k: int = DEFAULT_BLOCK_K) -> bool:
    """The JAX flash gate (``flash_attention.py:622-634``)."""
    b, sq, h, d = q_shape
    sk = k_shape[1]
    block_q, block_k = _resolve_blocks(sq, sk, block_q, block_k)
    return (sq % block_q == 0 and sk % block_k == 0 and
            block_q % 128 == 0 and block_k % 128 == 0 and
            d in (64, 128, 256))


def folded_attention_supported(q_shape, k_shape,
                               causal: bool = False) -> bool:
    """The JAX folded gate (``folded_attention.py:197-230``): same-length
    single-block self-attention; causal d=128 caps at S=256."""
    b, sq, h, d = q_shape
    sk = k_shape[1]
    if causal and sq > (MAX_SINGLE_BLOCK if d == 64 else 256):
        return False
    return (sq == sk and sq <= MAX_SINGLE_BLOCK and sq % 128 == 0 and
            d in (64, 128) and (h * d) % 128 == 0)
