"""Kernel selection and the functional ops of the serving and training
paths (port of the attention, sampling, dropout and cross-entropy
entries of ``paddle_tpu/ops/nn_functional.py``).

Each attention or sampling entry picks a CUDA kernel by the JAX
package's shape rules, gated on the tensors lying on a CUDA device where
the JAX package gated on a TPU backend; everywhere else it runs the
plain PyTorch math, as the JAX package runs XLA or its reference off the
TPU. Attention reaches its kernels only through the autograd Functions
of ``kernels/attention.py``, so training differentiates through them.

:func:`plain_kernels` switches the selection to the plain versions on
the card as well. It exists so that ``chip_smoke.py`` can hold the
kernel path against the plain path on the same inputs; serving and
training never enter it.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from ..core import rng
from .kernels.attention import (flash_attention, flash_attention_supported,
                                folded_attention,
                                folded_attention_supported)
from .kernels.fused_sample import (fused_argmax, fused_argmax_reference,
                                   fused_sample_supported,
                                   fused_topk_reference, _vocab_dim)
from .kernels.paged_attention import (decode_out_proj,
                                      fused_epilogue_supported, paged_decode,
                                      paged_attention_fused_reference,
                                      paged_attention_reference,
                                      paged_attention_supported)

# Flash-vs-plain crossovers of the JAX package (nn_functional.py:788-796):
# kept so that ``use_flash=None`` routes the same shapes as on the TPU
_FLASH_MIN_SEQ = 512
_FOLDED_MIN_SEQ = 256

_MODE = threading.local()


@contextlib.contextmanager
def plain_kernels(enabled: bool = True):
    """Run the plain PyTorch versions instead of the CUDA kernels in
    this thread for the duration (a comparison harness, not a
    fallback). ``enabled=False`` selects the kernels again."""
    prev = plain_mode()
    _MODE.plain = bool(enabled)
    try:
        yield
    finally:
        _MODE.plain = prev


def plain_mode() -> bool:
    """Whether :func:`plain_kernels` is in force in this thread."""
    return getattr(_MODE, "plain", False)


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda and not plain_mode()


def dropout(x, p: float = 0.5, training: bool = True,
            mode: str = "upscale_in_train", axis=None, generator=None):
    """``nn_functional.py:200-216``: keep each element (or each slice
    along ``axis``) with probability ``1 - p``; ``upscale_in_train``
    divides the kept ones by ``1 - p``. Draws from ``generator``, else
    from the :func:`core.rng.key_scope` generator, else the device's
    default one."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    gen = generator if generator is not None else rng.next_generator()
    if axis is not None:
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        shape = tuple(s if i in axes else 1 for i, s in enumerate(x.shape))
    else:
        shape = x.shape
    keep = torch.rand(shape, device=x.device, generator=gen) < (1.0 - p)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), zero).to(x.dtype)
    return torch.where(keep, x, zero).to(x.dtype)


def cross_entropy(input, label, ignore_index: int = -100,  # noqa: A002
                  reduction: str = "mean", axis: int = -1):
    """Hard-label softmax cross entropy (``nn_functional.py:986-1027``):
    positions whose label is ``ignore_index`` give 0, and ``"mean"``
    divides by the number of the others. Soft labels, class weights and
    label smoothing are not ported yet."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"cross_entropy: reduction {reduction!r}")
    label = label.long()
    if label.dim() == input.dim():
        label = label.squeeze(axis)
    logp = torch.log_softmax(input, dim=axis)
    valid = label != ignore_index
    picked = torch.gather(logp, axis, torch.where(valid, label, 0)
                          .unsqueeze(axis)).squeeze(axis)
    loss = torch.where(valid, -picked, torch.zeros((), dtype=logp.dtype,
                                                   device=logp.device))
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp_min(1)
    if reduction == "sum":
        return loss.sum()
    return loss


def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, training=True, scale=None,
                                 generator=None, use_flash=None):
    """q, k, v: [B, S, H, D]. ``use_flash``: None = the kernels from the
    JAX package's measured crossovers, True = a kernel whenever its gate
    admits, False = never (``nn_functional.py:799-866``). The kernels
    take no mask and no active dropout; they differentiate through their
    backward kernels. Dropout on the plain path draws from
    ``generator`` or the :func:`core.rng.key_scope` generator."""
    allowed = use_flash is True or (use_flash is None and
                                    k.shape[1] >= _FLASH_MIN_SEQ)
    folded_allowed = use_flash is True or (
        use_flash is None and k.shape[1] >= _FOLDED_MIN_SEQ)
    if (_on_card(q) and (allowed or folded_allowed) and attn_mask is None
            and (not is_causal or q.shape[1] == k.shape[1])
            and (dropout_p == 0.0 or not training)):
        if folded_allowed and folded_attention_supported(
                q.shape, k.shape, is_causal):
            return folded_attention(q, k, v, causal=is_causal, scale=scale)
        if allowed and flash_attention_supported(q.shape, k.shape):
            return flash_attention(q, k, v, causal=is_causal,
                                   scale=scale)[0]
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qT, kT, vT = (t.transpose(1, 2) for t in (q, k, v))
    logits = torch.einsum("bhqd,bhkd->bhqk", qT.to(torch.float32),
                          kT.to(torch.float32)) * scale
    if is_causal:
        causal = torch.ones((sq, sk), dtype=torch.bool,
                            device=q.device).tril(diagonal=sk - sq)
        logits = logits.masked_fill(~causal, float("-inf"))
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = logits.masked_fill(~attn_mask, float("-inf"))
        else:
            logits = logits + attn_mask
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_p > 0.0 and training:
        probs = dropout(probs, dropout_p, training=True, generator=generator)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vT)
    return out.transpose(1, 2)


def paged_attention(q, k_pages, v_pages, page_table, seq_lens,
                    k_scale=None, v_scale=None, scale=None, q_offsets=None):
    """Ragged paged attention (``nn_functional.py:869-883``): the
    page-walk kernel for single-token decode on the card, the
    dense-gather reference for everything else."""
    b, sq, h, d = q.shape
    if (_on_card(q) and q_offsets is None
            and paged_attention_supported(q.shape, k_pages.shape)):
        # q is a slice of the fused QKV projection: the kernel takes
        # a contiguous [B, H, D] row per sequence
        return paged_decode(q.reshape(b, h, d).contiguous(), k_pages,
                            v_pages, page_table, seq_lens, k_scale=k_scale,
                            v_scale=v_scale,
                            scale=scale).reshape(b, sq, h, d)
    return paged_attention_reference(
        q, k_pages, v_pages, page_table, seq_lens, k_scale=k_scale,
        v_scale=v_scale, scale=scale, q_offsets=q_offsets)


def paged_attention_fused(q, k_pages, v_pages, page_table, seq_lens, w,
                          bias=None, k_scale=None, v_scale=None, scale=None,
                          q_offsets=None):
    """Paged attention with the output projection: the attention block's
    output [B, Sq, E_out] (``nn_functional.py:908-925``). On the card:
    :func:`paged_decode` then :func:`decode_out_proj`, two launches in
    one call; elsewhere the fused reference (the exact unfused math)."""
    b, sq, h, d = q.shape
    if (_on_card(q) and q_offsets is None
            and fused_epilogue_supported(q.shape, k_pages.shape, w.shape)):
        ctx = paged_decode(q.reshape(b, h, d).contiguous(), k_pages,
                           v_pages, page_table, seq_lens, k_scale=k_scale,
                           v_scale=v_scale, scale=scale)
        out = decode_out_proj(ctx.reshape(b, h * d), w, bias)
        return out.reshape(b, sq, w.shape[1])
    return paged_attention_fused_reference(
        q, k_pages, v_pages, page_table, seq_lens, w, bias=bias,
        k_scale=k_scale, v_scale=v_scale, scale=scale, q_offsets=q_offsets)


def fused_sample(hidden, weight, bias=None, transpose_y=False, top_k=None,
                 tile=2048):
    """Streaming lm-head sampling (``nn_functional.py:928-940``):
    greedy tokens [B] int32 (``top_k=None``) or the top-k reservoir
    ``(values, indices)``, without the [B, vocab] logits."""
    vdim = _vocab_dim(transpose_y)
    if top_k is not None:
        return fused_topk_reference(hidden, weight, vdim, top_k, bias=bias,
                                    tile=tile)
    if _on_card(hidden) and fused_sample_supported(
            hidden.shape, weight.shape, transpose_y=transpose_y):
        return fused_argmax(hidden, weight, bias=bias,
                            transpose_y=transpose_y)
    return fused_argmax_reference(hidden, weight, vdim, bias=bias,
                                  tile=tile)
