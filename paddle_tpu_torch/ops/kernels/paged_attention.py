"""Ragged paged-attention decode over a block-paged KV pool.

Port of ``paddle_tpu/ops/pallas/paged_attention.py``. Two CUDA kernels
(``csrc/paged_decode.cu``, ``csrc/decode_out_proj.cu``) with their plain
PyTorch versions beside them:

- :func:`paged_decode` — single-token decode: each (sequence, head)
  walks the ``ceil(len/page)`` pages of its page-table row with an online
  softmax (the TPU's ``_decode_kernel``), on the card in splits of
  :func:`paged_decode_split` merged in split order.
- :func:`decode_out_proj` — ``ctx @ W + bias`` at decode batch sizes,
  the epilogue of the TPU's ``_decode_fused_kernel``; on Hopper it is a
  separate launch right after :func:`paged_decode` (see the source note).

Layouts as in the JAX package: pools ``[P + 1, page, H, D]`` (the last
page is the scratch page), int8 scales ``[P + 1, page, H]``, page table
``[B, max_pages]`` int32, lengths ``[B]`` int32 INCLUDING the appended
query token.

A wrapper takes the plain version only for CPU tensors; for CUDA
tensors it launches its kernel or raises.
"""

from __future__ import annotations

import math
import threading
from typing import Optional

import torch

from . import _build

_NEG_INF = -1e30
DEFAULT_PAGE_SIZE = 64


def paged_attention_reference(q, k_pages, v_pages, page_table, seq_lens,
                              k_scale=None, v_scale=None,
                              scale: Optional[float] = None,
                              q_offsets=None):
    """Dense-gather reference with the kernel's semantics
    (``paged_attention.py:309-356``). ``q``: [B, Sq, H, D]; the query
    tokens are the LAST Sq positions of each sequence unless
    ``q_offsets`` ([B], absolute position of the first query token)
    says otherwise. Positions past each query's own are masked; fully
    masked rows return zeros, not NaN."""
    from ...quantization.quant import dequantize_kv
    b, sq, h, d = q.shape
    page = k_pages.shape[1]
    mp = page_table.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    table = page_table.long()

    def gather(pages, scales):
        g = pages[table]  # [B, mp, page, H, D]
        if scales is not None:
            g = dequantize_kv(g, scales[table], torch.float32)
        else:
            g = g.to(torch.float32)
        return g.reshape(b, mp * page, h, d)

    k = gather(k_pages, k_scale)
    v = gather(v_pages, v_scale)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k) * scale
    if q_offsets is None:
        q_offsets = seq_lens - sq
    dev = q.device
    kpos = torch.arange(mp * page, device=dev, dtype=torch.int32)
    qpos = (q_offsets.to(device=dev, dtype=torch.int32)[:, None]
            + torch.arange(sq, device=dev, dtype=torch.int32)[None])
    mask = kpos[None, None, :] <= qpos[:, :, None]  # [B, Sq, T]
    logits = torch.where(mask[:, None], logits,
                         torch.tensor(_NEG_INF, device=dev))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)  # noqa: E741
    out = torch.einsum("bhqk,bkhd->bqhd", p / l.clamp_min(1e-30), v)
    any_valid = mask.any(-1)  # [B, Sq]
    out = torch.where(any_valid[..., None, None], out,
                      torch.zeros((), device=dev))
    return out.to(q.dtype)


def paged_attention_fused_reference(q, k_pages, v_pages, page_table,
                                    seq_lens, w, bias=None, k_scale=None,
                                    v_scale=None,
                                    scale: Optional[float] = None,
                                    q_offsets=None):
    """Reference for the fused epilogue: exactly the unfused model math
    (attention, head-concat reshape, ``x @ W``, bias add) in one op, so
    fused and unfused greedy decoding agree bit for bit on the CPU."""
    ctx = paged_attention_reference(
        q, k_pages, v_pages, page_table, seq_lens, k_scale=k_scale,
        v_scale=v_scale, scale=scale, q_offsets=q_offsets)
    b, sq, h, d = ctx.shape
    out = torch.matmul(ctx.reshape(b, sq, h * d), w)
    if bias is not None:
        out = out + bias
    return out


def paged_attention_supported(q_shape, kp_shape) -> bool:
    """The JAX package's shape gate for the page-walk kernel
    (``paged_attention.py:465-478``): single-token decode over head
    groups that tile 128 lanes. Other shapes (ragged prefill chunks, odd
    head widths) take the reference, as on the TPU."""
    b, sq, h, d = q_shape
    page = kp_shape[1]
    return (sq == 1 and d in (64, 128) and (h * d) % 128 == 0 and
            page % 8 == 0)


def fused_epilogue_supported(q_shape, kp_shape, w_shape) -> bool:
    """:func:`paged_attention_supported` plus a projection whose input
    width is the head concat. The TPU gate also capped ``W`` at 8 MB to
    keep it resident in VMEM (``paged_attention.py:540-557``); that
    limit is the TPU's alone, and the port's fused path applies at every
    ``W`` size."""
    if not paged_attention_supported(q_shape, kp_shape):
        return False
    e_in, e_out = w_shape
    _, _, h, d = q_shape
    return e_in == h * d and e_out % 128 == 0


# the split of csrc/paged_decode.cu: each (sequence, head) walks its
# pages in splits of this many positions, in whole pages (at least one);
# chosen by paged_split_sweep.py at the 8-slot decode step's lengths
PAGED_SPLIT_TOKENS = 128


def paged_decode_pages_per_split(page: int) -> int:
    """Pages in one split of the page walk at page size ``page``."""
    return max(1, PAGED_SPLIT_TOKENS // page)


def paged_decode_split(length: int, page: int,
                       max_pages: Optional[int] = None):
    """The page walk's partition of one sequence: ``[(first, end), ...]``,
    split ``s`` covering pages ``[first, end)`` of the sequence's
    page-table row, in order, together each of its ``ceil(length /
    page)`` pages (at most ``max_pages``) once; empty for length 0. It
    depends on the length and the page size alone, so a sequence walks
    the same splits alone or in any batch."""
    n = -(-max(int(length), 0) // page)
    if max_pages is not None:
        n = min(n, max_pages)
    step = paged_decode_pages_per_split(page)
    return [(p, min(n, p + step)) for p in range(0, n, step)]


def paged_decode_merge(m, l, acc, m2, l2, acc2):  # noqa: E741
    """The kernel's merge of two softmax partials, first then second:
    ``m`` [H] running max, ``l`` [H] sum of exp, ``acc`` [H, D]. An
    empty partial (m = -1e30, l = 0, acc = 0) weighs exp(-1e30 - m) = 0
    beside a real one, and two empty ones give an empty one, never
    NaN."""
    mn = torch.maximum(m, m2)
    c1, c2 = torch.exp(m - mn), torch.exp(m2 - mn)
    return (mn, l * c1 + l2 * c2,
            acc * c1[..., None] + acc2 * c2[..., None])


def paged_decode_split_emulation(q, k_pages, v_pages, page_table, seq_lens,
                                 k_scale=None, v_scale=None,
                                 scale: Optional[float] = None):
    """The kernel's arithmetic in plain PyTorch, for tests and the chip
    check: each split of :func:`paged_decode_split` takes its own softmax
    partial ``(m, l, acc)`` in f32 (int8 scales taken out of the dot
    product, as the kernel does), and the partials merge in split order;
    the context is rounded once to ``q.dtype``. ``q`` [B, H, D] -> [B, H,
    D]. (The kernel also splits a split across warps and lanes; that
    order of sums is not emulated.)"""
    b, h, d = q.shape
    page = k_pages.shape[1]
    mp = page_table.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.zeros((b, h, d), dtype=torch.float32, device=q.device)
    for i in range(b):
        length = min(max(int(seq_lens[i]), 0), mp * page)
        qi = q[i].to(torch.float32)
        m = torch.full((h,), _NEG_INF, device=q.device)
        l = torch.zeros((h,), device=q.device)  # noqa: E741
        acc = torch.zeros((h, d), device=q.device)
        for first, end in paged_decode_split(length, page, mp):
            pages = page_table[i, first:end].long()
            n = min(length, end * page) - first * page
            k = k_pages[pages].reshape(-1, h, d)[:n].to(torch.float32)
            v = v_pages[pages].reshape(-1, h, d)[:n].to(torch.float32)
            s = torch.einsum("hd,khd->hk", qi, k)
            if k_scale is not None:
                s = s * (k_scale[pages].reshape(-1, h)[:n].t() / 127.0)
            s = s * scale
            ms = s.amax(dim=-1)
            p = torch.exp(s - ms[:, None])
            ls = p.sum(dim=-1)
            if v_scale is not None:
                p = p * (v_scale[pages].reshape(-1, h)[:n].t() / 127.0)
            accs = torch.einsum("hk,khd->hd", p, v)
            m, l, acc = paged_decode_merge(  # noqa: E741
                m, l, acc, ms, ls, accs)
        out[i] = acc / l.clamp_min(1e-30)[:, None]
    return out.to(q.dtype)


# one 32-bit ticket per (sequence, head) for each stream the kernel
# runs on, zeroed once: the kernel's atomicInc wraps each ticket it
# draws back to 0 on the last draw of the launch
_TICKETS = {}
_TICKETS_LOCK = threading.Lock()


def _tickets(dev: torch.device, n: int) -> torch.Tensor:
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    with _TICKETS_LOCK:
        t = _TICKETS.get(key)
        if t is None or t.numel() < n:
            t = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
            _TICKETS[key] = t
        return t


def paged_decode(q, k_pages, v_pages, page_table, seq_lens, k_scale=None,
                 v_scale=None, scale: Optional[float] = None):
    """Single-token paged attention: ``q`` [B, H, D] -> context
    [B, H, D] in ``q.dtype``. CPU tensors take the plain version. On the
    card, one launch walks each sequence's pages in the splits of
    :func:`paged_decode_split`; the partials of a sequence of more than
    one split go through a workspace allocated here."""
    _build.refuse_grad("paged_decode", q, k_pages, v_pages, k_scale,
                       v_scale)
    b, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return paged_attention_reference(
            q.reshape(b, 1, h, d), k_pages, v_pages, page_table, seq_lens,
            k_scale=k_scale, v_scale=v_scale,
            scale=scale).reshape(b, h, d)
    quant = k_pages.dtype == torch.int8
    if quant != (k_scale is not None) or (k_scale is None) != (v_scale is
                                                                None):
        raise ValueError("paged_decode: int8 pools need k_scale and "
                         "v_scale, float pools take neither")
    dev = _build.require_cuda("paged_decode", q, k_pages, v_pages, k_scale,
                              v_scale, page_table, seq_lens)
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("paged_decode: page_table and seq_lens must be "
                        "int32")
    page = k_pages.shape[1]
    if d not in (64, 128) or page % 8 or k_pages.shape[2:] != (h, d) or \
            v_pages.shape != k_pages.shape:
        raise ValueError(f"paged_decode: pools {tuple(k_pages.shape)} do "
                         f"not match q {tuple(q.shape)} (D 64 or 128, "
                         f"page a multiple of 8)")
    if page_table.dim() != 2 or page_table.shape[0] != b or \
            seq_lens.shape != (b,):
        raise ValueError(f"paged_decode: page_table "
                         f"{tuple(page_table.shape)} and seq_lens "
                         f"{tuple(seq_lens.shape)} must be [B, max_pages] "
                         f"and [B] for B={b}")
    if quant and (k_scale.shape != k_pages.shape[:3]
                  or v_scale.shape != k_pages.shape[:3]
                  or k_scale.dtype != torch.float32
                  or v_scale.dtype != torch.float32):
        raise ValueError(f"paged_decode: int8 scales must be float32 "
                         f"{tuple(k_pages.shape[:3])}")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_decode: the pools are read in 16-byte "
                         "vectors and must be 16-byte aligned")
    qc = _build.dtype_code(q, "paged_decode q")
    kc = _build.dtype_code(k_pages, "paged_decode pages",
                           (torch.float32, torch.bfloat16, torch.int8))
    max_pages = page_table.shape[1]
    per_split = paged_decode_pages_per_split(page)
    splits = max(1, -(-max_pages // per_split))
    ws = None
    if splits > 1:
        ws = torch.empty(b * h * splits * (d + 2), dtype=torch.float32,
                         device=dev)
    out = torch.empty_like(q)
    err = _build.lib().pt_paged_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        _build.ptr(k_scale), _build.ptr(v_scale), page_table.data_ptr(),
        seq_lens.data_ptr(), out.data_ptr(), _build.ptr(ws),
        _tickets(dev, b * h).data_ptr(), b, h, d, page, max_pages,
        per_split, qc, kc, float(scale), _build.stream(dev))
    _build.check(err, "paged_decode")
    paged_decode.launches += 1
    return out


paged_decode.launches = 0


def decode_out_proj_reference(ctx, w, bias=None):
    """``ctx [B, E] @ w [E, E_out] + bias`` in ``ctx.dtype``."""
    out = torch.matmul(ctx, w.to(ctx.dtype))
    if bias is not None:
        out = out + bias.to(ctx.dtype)
    return out


# the tile of csrc/decode_out_proj.cu (its constants, checked again at
# its launch): row threads along K, the W rows each holds in one pass,
# column threads (16 bytes of W each), and the most splits, one
# portable thread-block cluster
OUT_PROJ_ROW_THREADS = 32
OUT_PROJ_MAX_ROWS = 16
OUT_PROJ_COL_THREADS = 8
OUT_PROJ_MAX_SPLITS = 8


def decode_out_proj_wave(w_itemsize: int, sms: int) -> int:
    """Blocks of the out-projection kernel resident at once on ``sms``
    SMs: two per SM with fp32 W, one with bf16 W (whose W rows take more
    registers)."""
    return sms * (2 if w_itemsize == 4 else 1)


def decode_out_proj_split(k: int, n: int, w_itemsize: int, sms: int):
    """The split-K partition of the out-projection kernel: ``(splits,
    rows)`` with split ``s`` covering W rows ``[s * rows, min(k, (s + 1)
    * rows))``. ``rows`` is a multiple of the kernel's 32 row threads;
    up to 512 rows (what they hold) it is one pass, above that the
    kernel takes several. As many splits as keep the grid in one wave
    (:func:`decode_out_proj_wave`), at least enough to make one pass
    each, at most ``OUT_PROJ_MAX_SPLITS``."""
    step = OUT_PROJ_ROW_THREADS
    if k <= 0:
        return 1, step
    col_blocks = -(-n // (OUT_PROJ_COL_THREADS * (16 // w_itemsize)))
    fit = max(1, decode_out_proj_wave(w_itemsize, sms) // max(col_blocks, 1))
    most = OUT_PROJ_ROW_THREADS * OUT_PROJ_MAX_ROWS
    splits = min(max(-(-k // most), fit), OUT_PROJ_MAX_SPLITS,
                 -(-k // step))
    rows = -(-k // splits)
    rows = -(-rows // step) * step
    return -(-k // rows), rows


def decode_out_proj(ctx, w, bias=None):
    """Skinny decode projection ``[B, E] x [E, E_out]`` (+ bias) with f32
    accumulation, W read once per launch (split over K and N, the splits
    of a column slice summed in order inside one thread-block cluster).
    CPU tensors take the plain version."""
    _build.refuse_grad("decode_out_proj", ctx, w, bias)
    if ctx.device.type == "cpu":
        return decode_out_proj_reference(ctx, w, bias)
    dev = _build.require_cuda("decode_out_proj", ctx, w, bias)
    b, k = ctx.shape
    k_w, n = w.shape
    if k_w != k or (bias is not None and bias.shape != (n,)):
        raise ValueError(f"decode_out_proj: ctx {tuple(ctx.shape)}, w "
                         f"{tuple(w.shape)}, bias "
                         f"{None if bias is None else tuple(bias.shape)}")
    if bias is not None and bias.dtype != w.dtype:
        raise TypeError("decode_out_proj: bias must have w's dtype")
    ac = _build.dtype_code(ctx, "decode_out_proj ctx")
    wc = _build.dtype_code(w, "decode_out_proj w")
    vec = 16 // w.element_size()
    if n % vec or w.data_ptr() % 16:
        raise ValueError(f"decode_out_proj: W is read in 16-byte vectors; "
                         f"E_out {n} must be a multiple of {vec} and W "
                         f"16-byte aligned")
    splits, rows = decode_out_proj_split(
        k, n, w.element_size(),
        torch.cuda.get_device_properties(dev).multi_processor_count)
    out = torch.empty((b, n), device=dev, dtype=ctx.dtype)
    err = _build.lib().pt_decode_out_proj(
        ctx.data_ptr(), w.data_ptr(), _build.ptr(bias), out.data_ptr(),
        b, k, n, ac, wc, int(bias is not None), splits, rows,
        _build.stream(dev))
    _build.check(err, "decode_out_proj")
    decode_out_proj.launches += 1
    return out


decode_out_proj.launches = 0
