"""Softmax attention, forward and backward: CUDA kernels behind the
flash and the folded entries, each entry a ``torch.autograd.Function``.

Port of ``paddle_tpu/ops/pallas/flash_attention.py`` and
``paddle_tpu/ops/pallas/folded_attention.py``. On the TPU the forward
was three kernels for reasons of Mosaic's tiling (see
``csrc/attention_fwd.cu``); here :func:`attention_fwd` launches one
online-softmax kernel on the tensor cores (3xTF32 for fp32, bf16 or
fp16 products for the 16-bit types) that reads ``[B, S, H, D]`` through
strides. The
backward kernels (``csrc/attention_bwd.cu``) keep the TPU's split:

- :func:`attention_bwd_fused` (TPU #6) when the whole Q axis is one
  block, :func:`attention_bwd_dq` and :func:`attention_bwd_dkv` (#7, #8)
  otherwise, all given ``lse`` and ``delta = rowsum(dO*O) - g_lse``;
- :func:`folded_attention_bwd` (#10), which recomputes the softmax from
  q and k (no saved lse).

Every backward kernel runs on the tensor cores like the forward (3xTF32
in fp32, bf16 or fp16 products for the 16-bit types): the dK/dV pass
(#8) is the single pass's key-major walk without its dQ share, the dQ
pass (#7) takes the forward's query-major structure.

:func:`flash_attention` returns ``(out, lse)`` with ``lse`` [B, S, H]
f32, both differentiable (the ``flash_attention_lse`` convention,
``flash_attention.py:539-586``); :func:`folded_attention` returns
``out`` only and saves q, k and v alone (``folded_attention.py:
132-194``). The gates keep the JAX package's rules, so the same shapes
reach a kernel as on the TPU.

Every wrapper takes its plain version (``attention_reference``,
``attention_bwd_reference``, ``folded_bwd_reference``) only for CPU
tensors; for CUDA tensors it launches its kernel or raises.

The forward is the registered op ``paddle_tpu_torch::attention_fwd``
(``_build.register_op``: a fake implementation for tracing, the plain
version on the CPU, the kernel on CUDA), so ``torch.export``
records it in a program and a loaded program launches it. The backward
kernels are ``ctypes`` calls and refuse to be traced
(``_build.refuse_trace``): an exported program is an inference program.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build

_NEG_INF = -1e30
# storage types of the forward and backward kernels: fp32 (3xTF32), bf16
# and fp16 (16-bit products, f32 accumulators)
ATTENTION_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
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


def _check_operands(name, q, k, v, head_dims, extra=()):
    """Shapes, dtype, device and unit head-dim strides of the operands
    a kernel reads through strides (``extra``: more [B, Sq, H, D]
    operands, e.g. dO)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if d not in head_dims:
        raise ValueError(f"{name}: head dim {d} not in {head_dims}")
    if k.shape != (b, sk, h, d) or v.shape != k.shape or any(
            t.shape != q.shape for t in extra):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    named = [("q", q), ("k", k), ("v", v)] + [("dO", t) for t in extra]
    for tname, t in named:
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: q, k, v and dO must share a dtype")
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name}: {tname} is on {t.device}")
        if t.stride(3) != 1:
            raise ValueError(f"{name}: {tname} needs a unit head-dim "
                             f"stride")
    return q.device


def _strides(t):
    return (t.stride(0), t.stride(1), t.stride(2))


def check_vector_aligned(name, *named):
    """Raise unless every ``(name, tensor)`` starts on a 16-byte
    boundary and its batch, row and head strides are whole 16-byte
    steps: the forward and backward kernels stage rows with 16-byte
    copies. Slices of a fused [B, S, 3, H, D] projection
    pass; a misaligned view is refused, never copied behind the
    caller's back."""
    for tname, t in named:
        size = t.element_size()
        if t.data_ptr() % 16 or any((st * size) % 16
                                    for st in _strides(t)):
            raise ValueError(
                f"{name}: {tname} needs a 16-byte aligned start and "
                f"16-byte multiples as batch/row/head strides (strides "
                f"{_strides(t)}, {size}-byte elements)")


def attention_fwd(q, k, v, causal: bool = False,
                  scale: Optional[float] = None, return_lse: bool = True):
    """The kernel's wrapper: q [B, Sq, H, D], k/v [B, Sk, H, D] (any
    strides with a unit head-dim stride, e.g. slices of the fused QKV
    projection). Returns ``(out, lse or None)``. CPU tensors take the
    plain version. It calls the registered op
    ``paddle_tpu_torch::attention_fwd``, so an exported program records
    the kernel and a loaded one launches it."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type != "cpu":
        _check_devices("attention_fwd", q, k, v)
    out, lse = torch.ops.paddle_tpu_torch.attention_fwd(
        q, k, v, bool(causal), float(scale), bool(return_lse))
    return out, (lse if return_lse else None)


def _check_devices(name, q, k, v):
    """The checks a traced tensor can answer: every operand on one CUDA
    device and the shapes of the kernel; the strides, the alignment and
    the dtype code are read where the kernel launches."""
    b, sq, h, d = q.shape
    if k.shape != (b, k.shape[1], h, d) or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    for tname, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name}: {tname} is on {t.device}")


# The registered op. ``return_lse=False`` gives an empty f32 lse (a
# registered op returns tensors only); the wrapper hands None back for it.
def _attention_fwd_cpu(q, k, v, causal, scale, return_lse):
    out, lse = attention_reference(q, k, v, causal=causal, scale=scale)
    return out.contiguous(), (lse if return_lse else lse.new_empty(0))


def _attention_fwd_fake(q, k, v, causal, scale, return_lse):
    b, sq, h, d = q.shape
    lse = q.new_empty((b, sq, h) if return_lse else (0,),
                      dtype=torch.float32)
    return q.new_empty((b, sq, h, d)), lse


def _attention_fwd_cuda(q, k, v, causal, scale, return_lse):
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dev = _check_operands("attention_fwd", q, k, v, (64, 128, 256))
    check_vector_aligned("attention_fwd", ("q", q), ("k", k), ("v", v))
    code = _build.dtype_code(q, "attention_fwd", ATTENTION_DTYPES)
    out = torch.empty((b, sq, h, d), device=dev, dtype=q.dtype)
    lse = torch.empty((b, sq, h) if return_lse else (0,), device=dev,
                      dtype=torch.float32)
    err = _build.lib().pt_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if return_lse else None, b, sq, sk, h, d,
        *_strides(q), *_strides(k), *_strides(v), int(bool(causal)), code,
        float(scale), int(return_lse), _build.stream(dev))
    _build.check(err, "attention_fwd")
    attention_fwd.launches += 1
    return out, lse


_build.register_op(
    "attention_fwd(Tensor q, Tensor k, Tensor v, bool causal, float scale, "
    "bool return_lse) -> (Tensor, Tensor)",
    _attention_fwd_cpu, _attention_fwd_cuda, _attention_fwd_fake)


attention_fwd.launches = 0


# -- backward -----------------------------------------------------------------

# rows of a K tile in csrc/attention_bwd.cu (kT): the single pass keeps
# one fp32 dQ share per K tile
KERNEL_TILE = 64
BWD_HEAD_DIMS = (64, 128)


def _scores(q, k, causal, scale):
    """fp32 scores [B, H, Sq, Sk] with the kernels' mask: -1e30 above
    the diagonal (key j visible to query i when j <= i)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        dev = q.device
        mask = (torch.arange(sk, device=dev)[None, :]
                <= torch.arange(sq, device=dev)[:, None])
        s = torch.where(mask, s, torch.tensor(_NEG_INF, device=dev))
    return s


def _grads_from_p(q, k, v, do, p, delta, scale):
    """dQ, dK, dV from the probabilities p [B, H, Sq, Sk] (f32) and
    delta [B, H, Sq, 1]: dS = p (dO V^T - delta) scale."""
    dof = do.to(torch.float32)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.to(torch.float32))
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.to(torch.float32))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(torch.float32))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_bwd_reference(q, k, v, do, lse, delta, causal: bool = False,
                            scale: Optional[float] = None):
    """Plain version of the flash backward kernels (#6-#8): the
    FlashAttention-2 formulas in fp32 (``flash_attention.py:146-294``),
    not autograd of the forward. ``lse`` and ``delta`` [B, Sq, H] f32,
    ``delta = rowsum(dO*O) - g_lse``. Returns ``(dq, dk, dv)``."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    s = _scores(q, k, causal, scale)
    p = torch.exp(s - lse.transpose(1, 2)[..., None])
    return _grads_from_p(q, k, v, do, p, delta.transpose(1, 2)[..., None],
                         scale)


def folded_bwd_reference(q, k, v, do, causal: bool = False,
                         scale: Optional[float] = None):
    """Plain version of the folded backward (#10, ``folded_attention.py:
    85-122``): the softmax recomputed from q and k, ``delta =
    rowsum(p_hat * dp)``. Returns ``(dq, dk, dv)``."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    s = _scores(q, k, causal, scale)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    phat = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.to(torch.float32),
                      v.to(torch.float32))
    delta = (phat * dp).sum(dim=-1, keepdim=True)
    return _grads_from_p(q, k, v, do, phat, delta, scale)


def _launch_bwd(name, mode, q, k, v, do, lse, delta, causal, scale):
    """One ``pt_attention_bwd`` call; returns ``(dq, dk, dv)`` with the
    ones the mode does not compute left None."""
    _build.refuse_trace(name, q, k, v, do, lse, delta)
    do = do if do.stride(3) == 1 else do.contiguous()
    dev = _check_operands(name, q, k, v, BWD_HEAD_DIMS, extra=(do,))
    check_vector_aligned(name, ("q", q), ("k", k), ("v", v), ("dO", do))
    b, sq, h, d = q.shape
    sk = k.shape[1]
    code = _build.dtype_code(q, name, ATTENTION_DTYPES)
    rows = (b, sq, h)
    for t in (lse, delta):
        if t.shape != rows or t.dtype != torch.float32 or \
                not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name}: lse and delta must be contiguous "
                             f"f32 {rows} on {dev}")
    dq = torch.empty(q.shape, device=dev, dtype=q.dtype) \
        if mode != 1 else None
    dk = torch.empty(k.shape, device=dev, dtype=k.dtype) \
        if mode != 0 else None
    dv = torch.empty(v.shape, device=dev, dtype=v.dtype) \
        if mode != 0 else None
    part = (torch.empty((-(-sk // KERNEL_TILE), b, sq, h, d), device=dev,
                        dtype=torch.float32) if mode >= 2 else None)
    err = _build.lib().pt_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _build.ptr(dq), _build.ptr(dk),
        _build.ptr(dv), _build.ptr(part), b, sq, sk, h, d,
        *_strides(q), *_strides(k), *_strides(v), *_strides(do),
        int(bool(causal)), code, float(scale), mode, _build.stream(dev))
    _build.check(err, name)
    return dq, dk, dv


def attention_bwd_dq(q, k, v, do, lse, delta, causal: bool = False,
                     scale: Optional[float] = None):
    """dQ pass (TPU #7) on the tensor cores: one block per Q tile walks
    the K tiles (one launch a call). CPU tensors take the plain
    version."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, do, lse, delta, causal,
                                       scale)[0]
    dq, _, _ = _launch_bwd("attention_bwd_dq", 0, q, k, v, do, lse, delta,
                           causal, scale)
    attention_bwd_dq.launches += 1
    return dq


def attention_bwd_dkv(q, k, v, do, lse, delta, causal: bool = False,
                      scale: Optional[float] = None):
    """dK/dV pass (TPU #8) on the tensor cores: one block per K tile
    walks the Q tiles that see it (one launch a call). Returns ``(dk,
    dv)``. CPU tensors take the plain version."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, do, lse, delta, causal,
                                       scale)[1:]
    _, dk, dv = _launch_bwd("attention_bwd_dkv", 1, q, k, v, do, lse,
                            delta, causal, scale)
    attention_bwd_dkv.launches += 1
    return dk, dv


def attention_bwd_fused(q, k, v, do, lse, delta, causal: bool = False,
                        scale: Optional[float] = None):
    """Single-pass backward (TPU #6, the whole Q axis one block) on the
    tensor cores: scores and their exp once per (q, k) pair, one block
    per K tile writing its dQ share, and the shares summed in K-tile
    order by a second launch (two launches a call). Returns ``(dq, dk,
    dv)``. CPU tensors take the plain version."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, do, lse, delta, causal,
                                       scale)
    out = _launch_bwd("attention_bwd_fused", 2, q, k, v, do, lse, delta,
                      causal, scale)
    attention_bwd_fused.launches += 1
    return out


def folded_attention_bwd(q, k, v, do, causal: bool = False,
                         scale: Optional[float] = None):
    """Folded backward (TPU #10): a first launch recomputes each row's
    lse and ``delta = rowsum(p_hat * dp)`` from q, k, v and dO on the
    tensor cores, then the single pass of :func:`attention_bwd_fused`
    runs on them (three launches a call). Returns ``(dq, dk, dv)``. CPU
    tensors take the plain version."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    if q.device.type == "cpu":
        return folded_bwd_reference(q, k, v, do, causal, scale)
    _build.refuse_trace("folded_attention_bwd", q, k, v, do)
    b, sq, h, _ = q.shape
    stats = torch.empty((2, b, sq, h), device=q.device, dtype=torch.float32)
    out = _launch_bwd("folded_attention_bwd", 3, q, k, v, do, stats[0],
                      stats[1], causal, scale)
    folded_attention_bwd.launches += 1
    return out


for _fn in (attention_bwd_dq, attention_bwd_dkv, attention_bwd_fused,
            folded_attention_bwd):
    _fn.launches = 0


# -- autograd entries ---------------------------------------------------------

class SavedAttention:
    """The forward outputs of the attention kernels in one rematerialised
    segment (``GPTConfig.remat_save_attention``, JAX ``gpt.py:88-97``):
    the segment's first run records them in order, its recompute in
    backward replays them instead of running the forward kernel again.
    Held outside autograd, so they live until the recompute takes
    them."""

    def __init__(self):
        self.items = []
        self.replay = False

    def forward(self, run):
        """``run()``'s outputs on the first run; the recorded ones, in
        order, on the recompute."""
        if self.replay:
            return self.items.pop(0)
        outs = run()
        self.items.append(tuple(t.detach() for t in outs))
        return outs


class FlashAttentionFunction(torch.autograd.Function):
    """``(out, lse)``, both differentiable, with the flash backward
    kernels (``flash_attention.py:539-569``): residuals q, k, v, out,
    lse; the lse cotangent folds into ``delta`` (``:449-453``); ``nq``
    Q blocks select #6 (``nq <= 1``) or #7 + #8. ``saved`` (a
    :class:`SavedAttention`) keeps out and lse for a recompute, as the
    JAX hook names both (``flash_attention.py:545-556``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, nq, saved=None):
        def run():
            return attention_fwd(q, k, v, causal=causal, scale=scale,
                                 return_lse=True)

        out, lse = run() if saved is None else saved.forward(run)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.nq = causal, scale, nq
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if g_out is None:  # only lse was used
            g_out = torch.zeros_like(out)
        delta = (g_out.to(torch.float32) * out.to(torch.float32)).sum(-1)
        if g_lse is not None:
            delta = delta - g_lse.to(torch.float32)
        args = (q, k, v, g_out, lse, delta.contiguous(), ctx.causal,
                ctx.scale)
        if ctx.nq <= 1:
            dq, dk, dv = attention_bwd_fused(*args)
        else:
            dq = attention_bwd_dq(*args)
            dk, dv = attention_bwd_dkv(*args)
        return dq, dk, dv, None, None, None, None


class FoldedAttentionFunction(torch.autograd.Function):
    """``out`` with the folded backward kernel (``folded_attention.py:
    132-194``): residuals q, k, v alone; the backward recomputes the
    softmax. ``saved`` keeps ``out`` for a recompute: the JAX hook names
    q, k and v (``:155-167``), which spares XLA the projection in its
    recompute; an eager recompute runs the projection regardless, so the
    port keeps the output, which spares the forward kernel as the flash
    path's out and lse do."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, saved=None):
        def run():
            return attention_fwd(q, k, v, causal=causal, scale=scale,
                                 return_lse=False)[:1]

        (out,) = run() if saved is None else saved.forward(run)
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g_out):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = folded_attention_bwd(q, k, v, g_out, ctx.causal,
                                          ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K,
                    saved: Optional[SavedAttention] = None):
    """``(out [B, Sq, H, D], lse [B, Sq, H] f32)``: the flash entry. The
    blocks only decide, as in the JAX package, whether the backward is
    the single pass (one Q block) or the two passes."""
    sq = q.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    block_q, _ = _resolve_blocks(sq, k.shape[1], block_q, block_k)
    return FlashAttentionFunction.apply(q, k, v, bool(causal), float(scale),
                                        sq // block_q, saved)


def folded_attention(q, k, v, causal: bool = False,
                     scale: Optional[float] = None,
                     saved: Optional[SavedAttention] = None):
    """``out [B, S, H, D]``: the folded entry (no lse)."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    return FoldedAttentionFunction.apply(q, k, v, bool(causal),
                                         float(scale), saved)


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
