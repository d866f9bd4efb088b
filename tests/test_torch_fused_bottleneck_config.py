"""The fused bottleneck kernel's launch configuration
(``paddle_tpu_torch/ops/kernels/fused_conv_block.py``
``fused_bottleneck_config``) for every image the gate admits.

The gate (``fused_bottleneck_supported``, the JAX gate rule for rule)
admits an NHWC identity bottleneck with ``C == 4M``, a plane of at least
784 positions and the JAX package's VMEM estimate under 100 MiB. At each
ResNet-50 width (C=256/M=64 up to C=2048/M=512), in fp32 and bf16, every
(H, W) it admits must get tiles that fit one block's 227 KB of shared
memory and cut the image into strips and columns that cover every row
and column exactly once; otherwise the kernel would refuse a shape the
model routes to it (the first kernel did so from 896x896 up).
"""

import pytest
import torch

from paddle_tpu_torch.ops.kernels import fused_conv_block as fc

RESNET50_WIDTHS = [(256, 64), (512, 128), (1024, 256), (2048, 512)]


def _gate_admits(h, w, c, m):
    """The gate's shape rules (``fused_bottleneck_supported``)."""
    vmem = (2 * h * w * c * 2 + h * w * m * (2 * 2 + 4) +
            (c * m * 2 + 9 * m * m) * 2) * 2
    return h * w >= 784 and vmem < 100 * 2 ** 20 and c == 4 * m


def _covers(n, parts, size):
    """``fused_bottleneck_tiles(n, parts)`` covers 0..n-1 exactly once in
    tiles of at most ``size``: the cut points i * n // parts rise from 0
    to n, strictly while parts <= n, and the widest tile is
    ceil(n / parts)."""
    return 1 <= parts <= n and -(-n // parts) <= size


def test_tiles_cover_every_row_once():
    for n in range(1, 200):
        for parts in range(1, n + 1):
            tiles = fc.fused_bottleneck_tiles(n, parts)
            rows = [r for first, end in tiles for r in range(first, end)]
            assert rows == list(range(n))
            assert max(end - first for first, end in tiles) == -(-n // parts)
            assert _covers(n, parts, -(-n // parts))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c, m", RESNET50_WIDTHS)
def test_every_admitted_image_gets_a_fitting_configuration(c, m, dtype):
    td = getattr(torch, dtype)
    config = fc.fused_bottleneck_config.__wrapped__  # no cache: each shape
    smem_of = {}
    admitted = 0
    w = 1
    while _gate_admits(-(-784 // w), w, c, m):
        h = -(-784 // w)
        while _gate_admits(h, w, c, m):
            cfg = config(h, w, c, m, td)
            key = (cfg.tr, cfg.tc)
            if key not in smem_of:
                smem_of[key] = fc.fused_bottleneck_smem(cfg.tr, cfg.tc, m,
                                                        td.itemsize)
            assert cfg.smem == smem_of[key] <= fc.FB_MAX_SMEM, (h, w, cfg)
            assert _covers(h, cfg.strips, cfg.tr), (h, w, cfg)
            assert _covers(w, cfg.col_tiles, cfg.tc), (h, w, cfg)
            assert cfg.tr <= fc.FB_MAX_ROWS and cfg.blocks_per_sm >= 1
            admitted += 1
            h += 1
        w += 1
    # the gate admits images from 784 positions up to its VMEM estimate
    assert admitted > 1000
