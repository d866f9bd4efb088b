"""Fused lm-head sampling: greedy tokens without the [B, vocab] logits.

Port of ``paddle_tpu/ops/pallas/fused_sample.py``. The CUDA kernel
``csrc/fused_argmax.cu`` replaces the TPU's ``_argmax_kernel``; beside it
are the plain versions with the JAX reference's exact semantics:

- :func:`fused_argmax_reference` — streams clamped vocab tiles with a
  running ``(max, first argmax)`` carry; ties go to the first index and
  the first NaN wins, exactly like ``argmax`` of the full logits;
- :func:`fused_topk_reference` — the running top-k reservoir (top-k
  sampling stays on this plain scan, as it does on the TPU).

Weight layouts: ``[V, D]`` vocab-major (tied embedding,
``transpose_y=True``) or ``[D, V]``; both are tiled along their vocab
axis as they lie, never transposed.
"""

from __future__ import annotations

import torch

from . import _build

_NEG_INF = -1e30
DEFAULT_TILE = 2048


def _vocab_dim(transpose_y: bool) -> int:
    return 0 if transpose_y else 1


def _scan_tiles(hidden, weight, vdim, bias, tile, carry, step):
    """Tile scan shared by both references: clamped tile starts cover
    [0, vocab); rows of the final tile that repeat the previous tile's
    tail are masked to -1e30, so every id counts once."""
    vocab = weight.shape[vdim]
    tile = min(tile, vocab)
    n = max(1, -(-vocab // tile))
    dev = hidden.device
    for i in range(n):
        start = min(i * tile, max(0, vocab - tile))
        front = i * tile
        if vdim == 0:
            lg = torch.matmul(hidden, weight[start:start + tile].t())
        else:
            lg = torch.matmul(hidden, weight[:, start:start + tile])
        idx = start + torch.arange(tile, device=dev, dtype=torch.int32)
        if bias is not None:
            lg = lg + bias[start:start + tile]
        lg = torch.where(idx[None, :] >= front, lg.to(torch.float32),
                         torch.full((), _NEG_INF, device=dev))
        carry = step(carry, lg, idx)
    return carry


def fused_argmax_reference(hidden, weight, vdim: int, bias=None,
                           tile: int = DEFAULT_TILE):
    """Streaming greedy argmax (``fused_sample.py:115-139``): [B] int32."""
    b = hidden.shape[0]
    dev = hidden.device

    def step(carry, lg, idx):
        best_v, best_i = carry
        tmax = lg.amax(dim=1)                   # NaN propagates
        targ = idx[torch.argmax(lg, dim=1)]     # first NaN, else first max
        upd = (tmax > best_v) | (torch.isnan(tmax) & ~torch.isnan(best_v))
        return (torch.where(upd, tmax, best_v),
                torch.where(upd, targ, best_i))

    init = (torch.full((b,), _NEG_INF, device=dev, dtype=torch.float32),
            torch.zeros((b,), device=dev, dtype=torch.int32))
    _, best_i = _scan_tiles(hidden, weight, vdim, bias, tile, init, step)
    return best_i.to(torch.int32)


def fused_topk_reference(hidden, weight, vdim: int, k: int, bias=None,
                         tile: int = DEFAULT_TILE):
    """Streaming top-k reservoir (``fused_sample.py:142-168``):
    ``(values [B, k] f32, indices [B, k] int32)``."""
    b = hidden.shape[0]
    k = min(int(k), weight.shape[vdim])
    dev = hidden.device

    def step(carry, lg, idx):
        vals, idxs = carry
        cand_v = torch.cat([vals, lg], dim=1)
        cand_i = torch.cat([idxs, idx[None, :].expand(lg.shape)], dim=1)
        top_v, pos = torch.topk(cand_v, k, dim=1)
        return top_v, torch.gather(cand_i, 1, pos)

    init = (torch.full((b, k), _NEG_INF, device=dev, dtype=torch.float32),
            torch.zeros((b, k), device=dev, dtype=torch.int32))
    vals, idxs = _scan_tiles(hidden, weight, vdim, bias, tile, init, step)
    return vals, idxs.to(torch.int32)


def fused_sample_supported(hidden_shape, w_shape,
                           transpose_y: bool = True) -> bool:
    """The JAX package's gate (``fused_sample.py:272-285``): a hidden
    width that tiles 128 lanes and a weight of the matching width."""
    _, d = hidden_shape
    return d % 128 == 0 and w_shape[1 - _vocab_dim(transpose_y)] == d


def fused_argmax(hidden, weight, bias=None, transpose_y: bool = True):
    """Greedy tokens [B] int32 = argmax of ``hidden @ W.T`` (``[V, D]``,
    ``transpose_y=True``) or ``hidden @ W`` (``[D, V]``), plus ``bias``.
    CPU tensors take the plain version. On the card one call reads W
    once for up to 256 rows: the kernel writes a (max, first index, first
    NaN) record a vocab tile and row into ``[n_tiles, B]`` buffers, and
    its second launch merges them in tile order."""
    _build.refuse_grad("fused_argmax", hidden, weight, bias)
    vdim = _vocab_dim(transpose_y)
    if hidden.device.type == "cpu":
        return fused_argmax_reference(hidden, weight, vdim, bias=bias)
    _build.refuse_trace("fused_argmax", hidden, weight, bias)
    dev = _build.require_cuda("fused_argmax", hidden, weight, bias)
    b, d = hidden.shape
    vocab = weight.shape[vdim]
    if weight.shape[1 - vdim] != d or (bias is not None and
                                       bias.shape != (vocab,)):
        raise ValueError(f"fused_argmax: hidden {tuple(hidden.shape)}, "
                         f"weight {tuple(weight.shape)}")
    if not all(x.is_contiguous() for x in (hidden, weight, bias)
               if x is not None):
        raise ValueError("fused_argmax: operands must be contiguous")
    if bias is not None and bias.dtype != weight.dtype:
        raise TypeError("fused_argmax: bias must have the weight's dtype")
    hc = _build.dtype_code(hidden, "fused_argmax hidden")
    wc = _build.dtype_code(weight, "fused_argmax weight")
    lib = _build.lib()
    n_tiles = lib.pt_argmax_tile_count(vocab, b)
    # (max as f32 bits, first index, first NaN) a vocab tile and row
    records = torch.empty((3, n_tiles, b), device=dev, dtype=torch.int32)
    out = torch.empty((b,), device=dev, dtype=torch.int32)
    err = lib.pt_fused_argmax(
        hidden.data_ptr(), weight.data_ptr(), _build.ptr(bias),
        records[0].data_ptr(), records[1].data_ptr(),
        records[2].data_ptr(), out.data_ptr(), b, d, vocab, int(vdim == 0),
        hc, wc, int(bias is not None), n_tiles, _build.stream(dev))
    _build.check(err, "fused_argmax")
    # the tile pass and the ordered reduction are one kernel's launches
    fused_argmax.launches += 1
    return out


fused_argmax.launches = 0
