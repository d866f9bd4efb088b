"""Fused ResNet bottleneck block, eval mode (port of
``paddle_tpu/ops/pallas/fused_conv_block.py``).

One launch of ``csrc/fused_bottleneck.cu`` computes a stride-1 identity
bottleneck on BN-folded weights::

    out = relu(conv3(relu(conv2(relu(conv1(x) + b1)) + b2)) + b3 + x)

on NHWC ``x [N, H, W, C]`` with the packed layouts of the JAX package:
``w1 [C, M]``, ``w2 [9M, M]`` (the 3x3 taps ky-major), ``w3 [M, C]`` and
f32 biases ``[1, M]`` / ``[1, C]``. Sums run in f32; y1 and y2 are
rounded to ``x.dtype`` after their relu, and the output is in
``x.dtype``, where the TPU kernel rounds them.

- :func:`fused_bottleneck_reference` is the plain version.
- :func:`fused_bottleneck_eval` is the wrapper: the plain version for
  CPU tensors, the kernel for CUDA tensors (or it raises). It has no
  backward, as the TPU kernel has none. It calls the registered op
  ``paddle_tpu_torch::fused_bottleneck`` (``_build.register_op``: a
  fake implementation for tracing, the plain version on the CPU, the
  kernel on CUDA), which ``torch.export`` records in a program.
- :func:`fused_bottleneck_config` is the kernel's launch configuration:
  the tile of rows by columns one block owns, the tiles of an image and
  the shared bytes; :func:`fused_bottleneck_strip_emulation` runs the
  plain arithmetic tile by tile as the kernel cuts the image (for tests
  and the chip check).
- :func:`fold_bn` / :func:`pack_bottleneck` fold the three BNs.
- :func:`fused_bottleneck_supported` is the JAX gate, rule for rule.

The routing is opt-in, as in the JAX package: :func:`enable_fused_conv_eval`
or ``PT_FUSED_CONV_EVAL=1`` in the environment at import.
"""

from __future__ import annotations

import math
import os
from functools import lru_cache
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build

_FUSED_EVAL_ENABLED = bool(int(os.environ.get("PT_FUSED_CONV_EVAL", "0")))


def enable_fused_conv_eval(enabled: bool = True) -> None:
    """Opt in to routing eval bottleneck blocks through the fused kernel
    (``fused_conv_block.py:205-211``)."""
    global _FUSED_EVAL_ENABLED
    _FUSED_EVAL_ENABLED = bool(enabled)


def fold_bn(conv_w, gamma, beta, mean, var, eps):
    """BN -> conv scale/bias fold (``fused_conv_block.py:166-174``):
    ``(conv_w * scale per out-channel in f32, cast back to conv_w's
    dtype; bias [out] f32)``."""
    scale = (gamma / torch.sqrt(var + eps)).to(torch.float32)
    wf = (conv_w.to(torch.float32) *
          scale[:, None, None, None]).to(conv_w.dtype)
    bias = (beta - mean * scale).to(torch.float32)
    return wf, bias


@torch.no_grad()
def pack_bottleneck(block):
    """Fold a ``BottleneckBlock``'s three BNs and pack its conv weights
    into the kernel's layouts (``fused_conv_block.py:177-196``): returns
    ``(w1 [C, M], b1 [1, M], w2 [9M, M], b2 [1, M], w3 [M, C], b3 [1,
    C])``, contiguous and outside autograd (the kernel has no
    backward)."""
    def fold(conv, bn):
        return fold_bn(conv.weight, bn.weight, bn.bias, bn._mean,
                       bn._variance, bn._epsilon)

    w1, b1 = fold(block.conv1, block.bn1)
    w2, b2 = fold(block.conv2, block.bn2)
    w3, b3 = fold(block.conv3, block.bn3)
    m = w1.shape[0]
    w1m = w1[:, :, 0, 0].t()
    # [M_out, M_in, 3, 3] -> taps ky-major [9 * M_in, M_out]
    w2m = w2.permute(2, 3, 1, 0).reshape(9 * m, m)
    w3m = w3[:, :, 0, 0].t()
    return tuple(t.contiguous() for t in
                 (w1m, b1[None, :], w2m, b2[None, :], w3m, b3[None, :]))


def fused_bottleneck_reference(x, w1, b1, w2, b2, w3, b3):
    """The kernel's arithmetic in plain PyTorch (``fused_conv_block.py:
    70-114``). Every product takes f32 operands (exact for bf16), so the
    sums are f32 as with ``preferred_element_type=f32``; y1 and y2 are
    rounded to ``x.dtype`` after their relu."""
    f32 = torch.float32
    n, h, w, c = x.shape
    m = w1.shape[1]
    xf = x.to(f32).reshape(-1, c)
    y1 = torch.relu(xf @ w1.to(f32) + b1).to(x.dtype).to(f32)
    pad = F.pad(y1.reshape(n, h, w, m), (0, 0, 1, 1, 1, 1))
    cols = torch.cat([pad[:, dy:dy + h, dx:dx + w]
                      for dy in range(3) for dx in range(3)], dim=-1)
    y2 = torch.relu(cols.reshape(-1, 9 * m) @ w2.to(f32) + b2)
    y2 = y2.to(x.dtype).to(f32)
    y3 = y2 @ w3.to(f32) + b3 + xf
    return torch.relu(y3).to(x.dtype).reshape(n, h, w, c)


# the kernel's layout constants (csrc/fused_bottleneck.cu)
_FB_BC = 64             # channels of a pass
_FB_KC = 32             # contraction depth of a staged chunk
_FB_STAGES = 3          # staged chunks in the ring
_FB_XP = 128            # positions of a conv1 pass
_FB_OP = {4: 256, 2: 224}  # positions of a conv2 or conv3 pass, by item size
FB_MAX_SMEM = 232448    # shared bytes a block may use on an H100 (227 KB)
FB_SM_SMEM = 233472     # shared bytes of an SM (228 KB)
FB_BLOCK_RESERVED = 1024  # the runtime's own shared bytes per block
FB_MAX_ROWS = 8         # rows of a tile at most
FB_SMS = 132            # SMs of an H100 SXM
FB_THREADS = 256        # threads of a block
# blocks an SM holds by the registers a thread takes (the kernel's
# __launch_bounds__): fp32 one, bf16 two
FB_REG_BLOCKS = {4: 1, 2: 2}


def _align16(b: int) -> int:
    return (b + 15) // 16 * 16


def fused_bottleneck_smem(tr: int, tc: int, m: int, itemsize: int) -> int:
    """Shared bytes of the kernel's tile of ``tr`` rows by ``tc`` columns
    (``regions`` in ``csrc/fused_bottleneck.cu``): y1 over the tile and
    its halo, which conv3's output stage reuses; y2, which conv1's
    ring of staged x chunks reuses; the ring of staged weight chunks.
    Rows are padded by 16 bytes."""
    vec = 16 // itemsize
    ld = m + vec
    p1 = (tr + 2) * (tc + 2)
    p = tr * tc
    p8 = -(-p // 8) * 8
    xp = min(_FB_XP, -(-p1 // 32) * 32)
    r1 = _align16(max(p1 * ld, min(p8, _FB_OP[itemsize]) * (_FB_BC + vec))
                  * itemsize)
    r2 = _align16(max(p * ld * itemsize,
                      _FB_STAGES * xp * (_FB_KC + vec) * itemsize))
    r3 = _FB_STAGES * _FB_KC * (_FB_BC + 8) * itemsize
    return r1 + r2 + r3


class FusedBottleneckConfig(NamedTuple):
    """The kernel's launch configuration for one image size: tiles of at
    most ``tr`` rows by ``tc`` columns, ``strips`` x ``col_tiles`` of them
    an image (:func:`fused_bottleneck_tiles`), ``smem`` shared bytes a
    block, ``blocks_per_sm`` as many as an SM holds by its shared memory
    and the registers a thread takes (``FB_REG_BLOCKS``),
    and ``halo_share``: the products conv1 spends on the recomputed halo,
    as a share of the block's useful products."""
    tr: int
    tc: int
    strips: int
    col_tiles: int
    smem: int
    blocks_per_sm: int
    halo_share: float


def fused_bottleneck_tiles(n: int, parts: int):
    """The kernel's cut of ``n`` rows (or columns) into ``parts`` tiles:
    ``[(first, end), ...]``, each ``ceil(n / parts)`` or one fewer."""
    return [(i * n // parts, (i + 1) * n // parts) for i in range(parts)]


@lru_cache(maxsize=None)
def _widest_tiles(c: int, m: int, itemsize: int):
    """``(rows, widest columns, blocks)`` for each row count 1..
    ``FB_MAX_ROWS`` and each count of blocks an SM may hold (1 up to
    ``FB_REG_BLOCKS``): the widest tile whose shared bytes fit that many
    blocks an SM, where one fits at all."""
    out = []
    for blocks in range(1, FB_REG_BLOCKS[itemsize] + 1):
        budget = min(FB_MAX_SMEM, FB_SM_SMEM // blocks - FB_BLOCK_RESERVED)
        for tr in range(1, FB_MAX_ROWS + 1):
            lo, hi = 0, 1
            while fused_bottleneck_smem(tr, hi, m, itemsize) <= budget:
                lo, hi = hi, 2 * hi
            while hi - lo > 1:
                mid = (lo + hi) // 2
                if fused_bottleneck_smem(tr, mid, m, itemsize) <= budget:
                    lo = mid
                else:
                    hi = mid
            if lo:
                out.append((tr, lo, blocks))
    return tuple(out)


@lru_cache(maxsize=4096)
def _column_cuts(w: int, c: int, m: int, itemsize: int):
    """``_widest_tiles`` cut to an image ``w`` wide: ``(rows, column
    tiles, columns a tile, blocks)`` for each candidate."""
    out = []
    for tr, widest, blocks in _widest_tiles(c, m, itemsize):
        col_tiles = -(-w // min(w, widest))
        out.append((tr, col_tiles, -(-w // col_tiles), blocks))
    return tuple(out)


# the fixed cost of a staged chunk (its copies, its barrier), in steps of
# one 8-position tile over the chunk: the value whose picks matched the
# fastest tiles of sweeps on an H100 (PERF.md)
_FB_CHUNK_STEPS = 3


@lru_cache(maxsize=None)
def _tile_work(tr: int, tc: int, c: int, m: int, itemsize: int) -> int:
    """The time of one tile in steps of one 8-position tile over one
    32-deep chunk: each pass's chunks (64 channels each) take the
    slowest position warp's tiles plus ``_FB_CHUNK_STEPS``."""
    def phase(positions, per_warp, chunks):
        n8 = -(-positions // 8)
        passes = -(-n8 // (4 * per_warp))
        return passes * chunks * (-(-(-(-n8 // passes)) // 4)
                                  + _FB_CHUNK_STEPS)
    mb, cb, mk = -(-m // _FB_BC), -(-c // _FB_BC), -(-m // _FB_KC)
    return (phase((tr + 2) * (tc + 2), _FB_XP // 32, mb * -(-c // _FB_KC))
            + phase(tr * tc, _FB_OP[itemsize] // 32, (9 * mb + cb) * mk))


@lru_cache(maxsize=4096)
def fused_bottleneck_config(h: int, w: int, c: int, m: int, dtype, n: int = 1,
                            sms: int = FB_SMS) -> FusedBottleneckConfig:
    """The launch configuration of the kernel for ``n`` images of ``h`` x
    ``w`` with ``c`` channels and bottleneck width ``m`` (multiples of 8,
    as the wrapper pads them) in ``dtype``, on a card of ``sms`` SMs.

    Candidates: for each row count 1 .. ``FB_MAX_ROWS`` (at most ``h``),
    the widest tile that fits 227 KB and the widest that lets an SM hold
    two blocks (bf16; fp32 takes one block by its registers). Rows and
    columns are cut evenly (:func:`fused_bottleneck_tiles`). The time of
    a candidate is taken as its waves (``n`` x tiles over ``sms`` x
    blocks an SM) times a tile's time (:func:`_tile_work`: the halo, the
    padding of positions to 8, the share over 4 warps and a fixed cost a
    chunk counted) times the square root of the blocks an SM holds (a
    second block hides latency that one block leaves exposed;
    ``PERF.md``); the least wins, then fewer tiles."""
    itemsize = dtype.itemsize
    best = None
    for tr, col_tiles, tce, blocks in _column_cuts(w, c, m, itemsize):
        if tr > h:
            continue
        strips = -(-h // tr)
        tre = -(-h // strips)
        tiles = strips * col_tiles
        waves = -(-n * tiles // (sms * blocks))
        key = (waves * _tile_work(tre, tce, c, m, itemsize)
               * math.sqrt(blocks),
               tiles)
        if best is None or key < best[0]:
            best = (key, tre, tce, strips, col_tiles)
    if best is None:
        raise ValueError(f"fused_bottleneck: no tile fits M={m} in "
                         f"{FB_MAX_SMEM} shared bytes")
    _, tr, tc, strips, col_tiles = best
    smem = fused_bottleneck_smem(tr, tc, m, itemsize)
    bps = min(FB_SM_SMEM // (smem + FB_BLOCK_RESERVED),
              FB_REG_BLOCKS[itemsize])
    # sum over the tiles of (rows + 2)(cols + 2) - rows * cols
    halo = 2 * h * col_tiles + 2 * w * strips + 4 * strips * col_tiles
    return FusedBottleneckConfig(
        tr, tc, strips, col_tiles, smem, bps,
        halo * c * m / (h * w * (2 * c * m + 9 * m * m)))


def _pad_to_kernel(x, w1, b1, w2, b2, w3, b3):
    """The kernel takes M and C in multiples of 8: zero channels past M
    (and past C, with x) change no output channel, since they carry
    relu(0) = 0 through the chain. Returns the padded operands (the
    given ones where no pad is due)."""
    c, m = w1.shape
    m8, c8 = -(-m // 8) * 8, -(-c // 8) * 8
    if (m8, c8) == (m, c):
        return x, w1, b1, w2, b2, w3, b3
    dm, dc = m8 - m, c8 - c
    w2 = F.pad(w2.reshape(9, m, m), (0, dm, 0, dm)).reshape(9 * m8, m8)
    return (F.pad(x, (0, dc)).contiguous(),
            F.pad(w1, (0, dm, 0, dc)).contiguous(),
            F.pad(b1, (0, dm)).contiguous(), w2.contiguous(),
            F.pad(b2, (0, dm)).contiguous(),
            F.pad(w3, (0, dc, 0, dm)).contiguous(),
            F.pad(b3, (0, dc)).contiguous())


def fused_bottleneck_strip_emulation(x, w1, b1, w2, b2, w3, b3, config=None):
    """The kernel's decomposition in plain PyTorch, for tests and the chip
    check: the image is cut into :func:`fused_bottleneck_config`'s tiles
    (``config``, or the one for ``x``'s shape); each tile computes y1 over
    itself and a one-position halo into a zero-padded ``(rows + 2) x
    (cols + 2) x M`` tile (zero outside the image), conv2 reads the nine
    taps of that tile at constant offsets, and conv3 adds b3 and the
    residual. f32 sums, y1 and y2 rounded to ``x.dtype`` as in
    :func:`fused_bottleneck_reference`. (The kernel's order of sums inside
    a product is not emulated.)"""
    f32 = torch.float32
    n, h, w, c = x.shape
    m = w1.shape[1]
    if config is None:
        config = fused_bottleneck_config(h, w, -(-c // 8) * 8,
                                         -(-m // 8) * 8, x.dtype, n)
    w1f, w2f, w3f = w1.to(f32), w2.to(f32), w3.to(f32)
    out = torch.empty_like(x)
    for r0, r1 in fused_bottleneck_tiles(h, config.strips):
        for c0, c1 in fused_bottleneck_tiles(w, config.col_tiles):
            tr, tc = r1 - r0, c1 - c0
            # the halo tile, zero outside the image
            lo_r, hi_r = max(r0 - 1, 0), min(r1 + 1, h)
            lo_c, hi_c = max(c0 - 1, 0), min(c1 + 1, w)
            xin = x[:, lo_r:hi_r, lo_c:hi_c].to(f32)
            y1 = torch.relu(xin @ w1f + b1[0]).to(x.dtype).to(f32)
            tile = x.new_zeros((n, tr + 2, tc + 2, m), dtype=f32)
            tile[:, lo_r - r0 + 1:hi_r - r0 + 1,
                 lo_c - c0 + 1:hi_c - c0 + 1] = y1
            cols = torch.cat([tile[:, ky:ky + tr, kx:kx + tc]
                              for ky in range(3) for kx in range(3)], -1)
            y2 = torch.relu(cols @ w2f + b2[0]).to(x.dtype).to(f32)
            res = x[:, r0:r1, c0:c1].to(f32)
            out[:, r0:r1, c0:c1] = torch.relu(
                y2 @ w3f + b3[0] + res).to(x.dtype)
    return out


def fused_bottleneck_eval(x, w1, b1, w2, b2, w3, b3):
    """The block on NHWC ``x`` with packed weights (see the module
    docstring). CPU tensors take the plain version; CUDA tensors launch
    ``csrc/fused_bottleneck.cu`` or raise. It calls the registered op
    ``paddle_tpu_torch::fused_bottleneck``, so an exported program
    records the kernel and a loaded one launches it."""
    _build.refuse_grad("fused_bottleneck", x, w1, b1, w2, b2, w3, b3)
    if x.device.type != "cpu":
        _check_block(x, w1, b1, w2, b2, w3, b3)
    return torch.ops.paddle_tpu_torch.fused_bottleneck(x, w1, b1, w2, b2, w3,
                                                        b3)


def _check_block(x, w1, b1, w2, b2, w3, b3):
    """The checks a traced tensor can answer: devices, shapes and dtypes
    (the alignment, the padding and the card's SMs are read where the
    kernel launches)."""
    for t in (x, w1, b1, w2, b2, w3, b3):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"fused_bottleneck: all operands must be CUDA "
                             f"tensors on one device, got one on {t.device}")
    if x.dim() != 4:
        raise ValueError(f"fused_bottleneck: x must be [N, H, W, C], got "
                         f"{tuple(x.shape)}")
    n, h, w, c = x.shape
    m = w1.shape[1] if w1.dim() == 2 else -1
    want = {"w1": (c, m), "b1": (1, m), "w2": (9 * m, m), "b2": (1, m),
            "w3": (m, c), "b3": (1, c)}
    got = {"w1": w1, "b1": b1, "w2": w2, "b2": b2, "w3": w3, "b3": b3}
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"fused_bottleneck: {name} {tuple(t.shape)}, "
                             f"want {want[name]} for x {tuple(x.shape)}")
    for name in ("w1", "w2", "w3"):
        if got[name].dtype != x.dtype:
            raise TypeError(f"fused_bottleneck: {name} must have x's dtype "
                            f"{x.dtype}, got {got[name].dtype}")
    for name in ("b1", "b2", "b3"):
        if got[name].dtype != torch.float32:
            raise TypeError(f"fused_bottleneck: {name} must be float32")


def _fused_bottleneck_fake(x, w1, b1, w2, b2, w3, b3):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _fused_bottleneck_cuda(x, w1, b1, w2, b2, w3, b3):
    dev = _build.require_cuda("fused_bottleneck", x, w1, b1, w2, b2, w3, b3)
    n, h, w, c = x.shape
    m = w1.shape[1]
    code = _build.dtype_code(x, "fused_bottleneck x")
    if x.numel() == 0:
        return torch.empty_like(x)
    kx, *kparams = _pad_to_kernel(x, w1, b1, w2, b2, w3, b3)
    # 16-byte rows for the kernel's loads (a fresh allocation is aligned;
    # a view with an offset may not be)
    kx, *kparams = (t if t.data_ptr() % 16 == 0 else t.clone()
                    for t in (kx, *kparams))
    kc, km = kparams[0].shape
    cfg = fused_bottleneck_config(
        h, w, kc, km, x.dtype, n,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    out = torch.empty_like(kx)
    err = _build.lib().pt_fused_bottleneck(
        kx.data_ptr(), *(t.data_ptr() for t in kparams), out.data_ptr(),
        n, h, w, kc, km, cfg.tr, cfg.tc, cfg.strips, cfg.col_tiles,
        cfg.smem, code, _build.stream(dev))
    _build.check(err, f"fused_bottleneck (x {tuple(x.shape)}, M={m}, "
                 f"tile {cfg.tr}x{cfg.tc})")
    fused_bottleneck_eval.launches += 1
    return out if kc == c else out[..., :c].contiguous()


_build.register_op(
    "fused_bottleneck(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2, "
    "Tensor w3, Tensor b3) -> Tensor",
    fused_bottleneck_reference, _fused_bottleneck_cuda,
    _fused_bottleneck_fake)


def fused_bottleneck_occupancy(smem: int, dtype) -> int:
    """Blocks of the kernel one SM of the current card holds at once with
    ``smem`` shared bytes (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``:
    shared memory, registers and threads together)."""
    import ctypes
    blocks = ctypes.c_int(0)
    code = _build.DTYPE_CODES[dtype]
    _build.check(_build.lib().pt_fused_bottleneck_occupancy(
        smem, code, ctypes.addressof(blocks)), "fused_bottleneck occupancy")
    return int(blocks.value)


fused_bottleneck_eval.launches = 0


def _device_admits(device_type) -> bool:
    """The JAX gate's backend test (TPU, or flash forced for AOT) becomes:
    the input lies on a CUDA device and ``plain_kernels()`` is not in
    force."""
    from ..nn_functional import plain_mode
    return device_type == "cuda" and not plain_mode()


def fused_bottleneck_supported(block, x_shape, data_format,
                               device_type=None) -> bool:
    """The gate (``fused_conv_block.py:214-249``): opted in, a CUDA input,
    a stride-1 dilation-1 ungrouped identity bottleneck with plain
    ``BatchNorm2D`` norms, NHWC, a plane of at least 784 positions, the
    JAX package's VMEM estimate under 100 MiB, and ``C == 4M``.
    ``device_type`` None means the device of the block's weights."""
    from ...nn.norm import BatchNorm2D
    if not _FUSED_EVAL_ENABLED:
        return False
    if device_type is None:
        device_type = block.conv1.weight.device.type
    if not _device_admits(device_type):
        return False
    if data_format != "NHWC" or block.downsample is not None:
        return False
    if block.conv2._stride not in (1, (1, 1)):
        return False
    if block.conv2._dilation not in (1, (1, 1)):
        return False
    if getattr(block.conv2, "_groups", 1) != 1:
        return False
    if not all(type(bn) is BatchNorm2D
               for bn in (block.bn1, block.bn2, block.bn3)):
        return False
    n, h, w, c = x_shape
    if h * w < 784:
        return False
    m = block.conv1.weight.shape[0]
    vmem = (2 * h * w * c * 2 + h * w * m * (2 * 2 + 4) +
            (c * m * 2 + 9 * m * m) * 2) * 2
    return vmem < 100 * 2 ** 20 and c == 4 * m
