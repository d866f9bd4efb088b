"""The NHWC-inside, NCHW-outside boundary of the vision models (port of
``paddle_tpu/vision/models/_layout.py``): with ``data_format="NHWC"``
the network runs channel-last and the public input and output stay
NCHW, transposed once at each boundary."""

from __future__ import annotations


def boundary_in(x, data_format):
    # a real NHWC copy, so that every layer after it sees channels-last
    # memory (cuDNN then runs the convolutions in NHWC)
    if data_format == "NHWC":
        return x.permute(0, 2, 3, 1).contiguous()
    return x


def boundary_out(x, data_format):
    if data_format == "NHWC":
        return x.permute(0, 3, 1, 2)
    return x


def flatten_nchw_order(x, data_format, spatial_is_1x1):
    """Flatten to ``[N, C*H*W]`` in the NCHW order the classifier weights
    expect; a 1x1 spatial map flattens the same in both layouts."""
    if data_format == "NHWC" and not spatial_is_1x1:
        x = x.permute(0, 3, 1, 2)
    return x.flatten(1)
