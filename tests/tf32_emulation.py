"""The tensor cores' TF32 arithmetic emulated on the CPU, shared by the
tests of the port's tensor-core kernels (``paddle_tpu_torch/csrc/mma.cuh``).

An fp32 product on the tensor cores runs as 3xTF32: each operand x is
split into hi = TF32(x), rounded to nearest with ties away from zero
(``cvt.rna``), and lo = x - hi, which the tensor core reads truncated to
TF32; the product is lo*hi + hi*lo + hi*hi with f32 sums.
"""

import torch


def tf32(x):
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` does: add half of the dropped
    field to the magnitude's bits, then clear the field."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def truncate_tf32(x):
    """f32 truncated to TF32: the top 19 bits, as the tensor core reads
    a TF32 operand given in f32."""
    u = x.contiguous().view(torch.int32)
    return (u & -0x2000).view(torch.float32)


def split(x):
    """The kernels' split (``csrc/mma.cuh``): hi rounded to TF32, lo = x
    - hi passed as it is and read by the tensor core truncated."""
    hi = tf32(x)
    return hi, truncate_tf32(x - hi)


def tc_matmul(a, b, passes):
    """a @ b from TF32 parts with f32 sums: one pass (hi*hi) or three
    (lo*hi + hi*lo, then hi*hi)."""
    ah, al = split(a)
    bh, bl = split(b)
    if passes == 1:
        return ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh
