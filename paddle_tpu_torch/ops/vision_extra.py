"""The vision extras of the vision path (port of the ``conv3d_transpose``
and ``max_unpool2d`` entries of ``paddle_tpu/ops/vision_extra.py``).

The rest of that module (``deformable_conv``, the ROI pools, ``yolov3_loss``
and the others) is not ported yet, see ROADMAP.md.
"""

from __future__ import annotations

import torch

from .nn_functional import _conv_transpose, _norm_tuple, \
    _out_padding_from_size


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     output_size=None, data_format="NCDHW"):
    """``vision_extra.py:408-443``: ``weight [Cin, Cout, kd, kh, kw]``,
    symmetric pads (an int or one a dim); ``groups > 1`` raises
    ``NotImplementedError`` as there."""
    if output_size is not None:
        sp = x.shape[1:4] if data_format == "NDHWC" else x.shape[2:5]
        output_padding = _out_padding_from_size(
            tuple(sp), output_size, stride, padding, dilation,
            tuple(weight.shape[2:5]), 3)
    if groups != 1:
        raise NotImplementedError("conv3d_transpose groups>1")
    if isinstance(padding, str):
        raise ValueError(f"conv3d_transpose: padding={padding!r}; give an "
                         f"int or one int a dim")
    p = _norm_tuple(padding, 3)
    return _conv_transpose(x, weight, bias, stride, [(q, q) for q in p],
                           output_padding, dilation, 1,
                           data_format == "NDHWC", 3)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None):
    """``vision_extra.py:206-229``: the pooled values of ``x [N, C, h, w]``
    written back at ``indices`` (flat positions in each ``[H * W]``
    plane, as ``max_pool2d(return_mask=True)`` gives them), zeros
    elsewhere. As JAX's scatter reads an index, a negative one counts
    from the plane's end and one outside the plane is dropped."""
    if stride is None:
        stride = kernel_size
    ks = _norm_tuple(kernel_size, 2)
    st = _norm_tuple(stride, 2)
    pd = _norm_tuple(padding, 2)
    n, c, h, w = x.shape
    if output_size is None:
        oh = (h - 1) * st[0] - 2 * pd[0] + ks[0]
        ow = (w - 1) * st[1] - 2 * pd[1] + ks[1]
    else:
        oh, ow = output_size
    idx = indices.reshape(n, c, -1).to(torch.int64)
    size = oh * ow
    idx = torch.where(idx < 0, idx + size, idx)
    # out-of-plane writes land in one spare slot past the plane
    idx = torch.where((idx < 0) | (idx >= size), size, idx)
    flat = torch.zeros((n, c, size + 1), dtype=x.dtype, device=x.device)
    flat = flat.scatter(2, idx, x.reshape(n, c, -1))
    return flat[..., :size].reshape(n, c, oh, ow)


unpool = max_unpool2d
