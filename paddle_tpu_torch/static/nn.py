"""``paddle.static.nn``: layer builders that create their weights on
call (port of ``paddle_tpu/static/nn.py``).

As in the JAX package there is no op graph under construction: a
builder runs the eager ops at once (or inside a trace). A parameter
named by its ``ParamAttr(name=...)`` lives in ``static.global_scope()``
and a second call with that name reuses it, the reference's var-name
semantics; an unnamed one is drawn anew each call. The builders call
the registry's ops through ``dispatch``, so they take and return
``Tensor``s and record on autograd's graph; parameters are made on the
expected place (``paddle.set_device``).

``load_jax_scope`` carries a JAX ``global_scope()``'s named arrays
(numpy) into this scope, so a program built with ``static.nn`` on both
sides computes the same thing from the same values. The module's
``__getattr__`` re-exports the control-flow, sequence and
``crf_decoding`` ops, as the JAX one does.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..core.dtype import convert_dtype
from ..core.enforce import InvalidArgumentError
from ..tensor import Parameter, Tensor
from .api import global_scope

__all__ = [
    "load_jax_scope", "fc", "batch_norm", "embedding", "bilinear_tensor_product", "case",
    "cond", "conv2d", "conv2d_transpose", "conv3d", "conv3d_transpose",
    "crf_decoding", "data_norm", "deform_conv2d", "group_norm",
    "instance_norm", "layer_norm", "multi_box_head", "nce", "prelu",
    "py_func", "row_conv", "spectral_norm", "switch_case", "while_loop",
    "sparse_embedding", "sequence_conv", "sequence_softmax",
    "sequence_pool", "sequence_concat", "sequence_first_step",
    "sequence_last_step", "sequence_slice", "sequence_expand",
    "sequence_expand_as", "sequence_pad", "sequence_unpad",
    "sequence_reshape", "sequence_scatter", "sequence_enumerate",
    "sequence_reverse",
]


def _param(shape, dtype, attr, is_bias=False, default_initializer=None):
    """Create-or-reuse a parameter; named params live in global_scope."""
    from .. import _api as pt
    name = getattr(attr, "name", None) if attr is not None else None
    if name:
        existing = global_scope().find_var(name)
        if isinstance(existing, Parameter):
            return existing
    p = pt.create_parameter(shape, dtype=dtype, name=name, attr=attr,
                            is_bias=is_bias,
                            default_initializer=default_initializer)
    if name:
        global_scope().set_var(name, p)
    return p


def _device(x):
    v = x.value if isinstance(x, Tensor) else x
    return v.device if isinstance(v, torch.Tensor) else None


def load_jax_scope(arrays: Dict[str, np.ndarray], scope=None,
                   device=None, buffers=()) -> None:
    """Put each named array of a JAX ``global_scope()`` (name -> numpy,
    as ``np.asarray(scope.find_var(name).numpy())`` gives it) into this
    package's scope on ``device`` (the expected place by default): a
    ``Parameter`` of that name, which a later builder call with the same
    ``ParamAttr`` name reuses, or for the names in ``buffers`` (a
    ``batch_norm``'s moving statistics, a ``data_norm``'s sums) a
    ``Tensor`` that takes no gradient, as the JAX builders make them. A
    name already in the scope has its value copied in."""
    from ..device import resolve_device
    from ..tensor import to_value
    scope = scope or global_scope()
    dev = resolve_device(device)
    for name, arr in arrays.items():
        value = to_value(np.asarray(arr), device=dev)
        old = scope.find_var(name)
        if old is not None:
            _assign(old, value)
        elif name in buffers:
            scope.set_var(name, Tensor(value, stop_gradient=True,
                                       name=name))
        else:
            scope.set_var(name, Parameter(value, name=name))


def _assign(var, value) -> None:
    """Write ``value`` into a scope variable in place."""
    if isinstance(var, torch.Tensor):
        with torch.no_grad():
            var.copy_(value.to(var.dtype))
    else:
        var.set_value(value)


def _apply(name, *args, **kwargs):
    from .. import dispatch
    return dispatch.apply(name, *args, **kwargs)


def _act(x, act: Optional[str]):
    if act is None:
        return x
    return _apply(act, x)


def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None):
    """reference: paddle.static.nn.fc (fluid/layers/nn.py fc)."""
    xs = x if isinstance(x, (list, tuple)) else [x]
    outs = []
    for xi in xs:
        shp = tuple(xi.shape)
        in_dim = int(np.prod(shp[num_flatten_dims:]))
        flat = _apply("reshape", xi, (*shp[:num_flatten_dims], in_dim))
        w = _param((in_dim, size), xi.dtype, weight_attr)
        outs.append(_apply("matmul", flat, w))
    out = outs[0]
    for o in outs[1:]:
        out = _apply("add", out, o)
    if bias_attr is not False:
        b = _param((size,), out.dtype, bias_attr, is_bias=True)
        out = _apply("add", out, b)
    return _act(out, activation)


def embedding(input, size, is_sparse=False, is_distributed=False,  # noqa: A002
              padding_idx=None, param_attr=None, dtype="float32"):
    """reference: paddle.static.nn.embedding."""
    w = _param(tuple(size), convert_dtype(dtype), param_attr)
    return _apply("embedding", input, w, padding_idx)


def sparse_embedding(input, size, padding_idx=None, is_test=False,  # noqa: A002
                     entry=None, table_class="MemorySparseTable",
                     param_attr=None, dtype="float32"):
    """reference: paddle.static.nn.sparse_embedding — a dense table here
    (the parameter server's sharded tables wait for ROADMAP.md's Queue 1
    item 5)."""
    return embedding(input, size, is_sparse=True, padding_idx=padding_idx,
                     param_attr=param_attr, dtype=dtype)


def conv2d(input, num_filters, filter_size, stride=1, padding=0,  # noqa: A002
           dilation=1, groups=1, param_attr=None, bias_attr=None,
           use_cudnn=True, act=None, name=None, data_format="NCHW"):
    """reference: paddle.static.nn.conv2d."""
    fs = (filter_size, filter_size) if isinstance(filter_size, int) \
        else tuple(filter_size)
    cin = input.shape[1] if data_format == "NCHW" else input.shape[-1]
    w = _param((num_filters, cin // groups, *fs), input.dtype, param_attr)
    b = None if bias_attr is False else _param(
        (num_filters,), input.dtype, bias_attr, is_bias=True)
    out = _apply("conv2d", input, w, b, stride, padding, dilation, groups,
                 data_format)
    return _act(out, act)


def conv2d_transpose(input, num_filters, output_size=None,  # noqa: A002
                     filter_size=None, padding=0, stride=1, dilation=1,
                     groups=1, param_attr=None, bias_attr=None,
                     use_cudnn=True, act=None, name=None,
                     data_format="NCHW"):
    """reference: paddle.static.nn.conv2d_transpose."""
    if filter_size is None:
        raise InvalidArgumentError("filter_size is required")
    fs = (filter_size, filter_size) if isinstance(filter_size, int) \
        else tuple(filter_size)
    cin = input.shape[1] if data_format == "NCHW" else input.shape[-1]
    w = _param((cin, num_filters // groups, *fs), input.dtype, param_attr)
    b = None if bias_attr is False else _param(
        (num_filters,), input.dtype, bias_attr, is_bias=True)
    out = _apply("conv2d_transpose", input, w, b, stride, padding,
                 dilation=dilation, groups=groups, data_format=data_format)
    return _act(out, act)


def conv3d(input, num_filters, filter_size, stride=1, padding=0,  # noqa: A002
           dilation=1, groups=1, param_attr=None, bias_attr=None,
           use_cudnn=True, act=None, name=None, data_format="NCDHW"):
    """reference: paddle.static.nn.conv3d."""
    fs = (filter_size,) * 3 if isinstance(filter_size, int) \
        else tuple(filter_size)
    cin = input.shape[1] if data_format == "NCDHW" else input.shape[-1]
    w = _param((num_filters, cin // groups, *fs), input.dtype, param_attr)
    b = None if bias_attr is False else _param(
        (num_filters,), input.dtype, bias_attr, is_bias=True)
    out = _apply("conv3d", input, w, b, stride, padding, dilation, groups,
                 data_format)
    return _act(out, act)


def conv3d_transpose(input, num_filters, output_size=None,  # noqa: A002
                     filter_size=None, padding=0, stride=1, dilation=1,
                     groups=1, param_attr=None, bias_attr=None,
                     use_cudnn=True, act=None, name=None,
                     data_format="NCDHW"):
    """reference: paddle.static.nn.conv3d_transpose."""
    fs = (filter_size,) * 3 if isinstance(filter_size, int) \
        else tuple(filter_size)
    cin = input.shape[1] if data_format == "NCDHW" else input.shape[-1]
    w = _param((cin, num_filters // groups, *fs), input.dtype, param_attr)
    b = None if bias_attr is False else _param(
        (num_filters,), input.dtype, bias_attr, is_bias=True)
    out = _apply("conv3d_transpose", input, w, b, stride, padding,
                 dilation=dilation, groups=groups, data_format=data_format)
    return _act(out, act)


def deform_conv2d(x, offset, mask, num_filters, filter_size, stride=1,
                  padding=0, dilation=1, groups=1, deformable_groups=1,
                  im2col_step=1, weight_attr=None, bias_attr=None,
                  name=None):
    """reference: paddle.static.nn.deform_conv2d."""
    fs = (filter_size, filter_size) if isinstance(filter_size, int) \
        else tuple(filter_size)
    cin = x.shape[1]
    w = _param((num_filters, cin // groups, *fs), x.dtype, weight_attr)
    b = None if bias_attr is False else _param(
        (num_filters,), x.dtype, bias_attr, is_bias=True)
    return _apply("deformable_conv", x, offset, w, mask, b, stride,
                  padding, dilation, deformable_groups, groups)


def batch_norm(input, act=None, is_test=False, momentum=0.9,  # noqa: A002
               epsilon=1e-5, param_attr=None, bias_attr=None,
               data_layout="NCHW", in_place=False, name=None,
               moving_mean_name=None, moving_variance_name=None,
               do_model_average_for_mean_and_var=True,
               use_global_stats=False):
    """reference: paddle.static.nn.batch_norm. Moving stats live in
    global_scope under their names (or auto-names) and update in-place on
    train-mode calls, matching the reference's persistable-var update."""
    from ..framework import unique_name
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    # "ones" is only the fallback — an attr.initializer still wins inside
    # resolve_initializer
    scale = _param((c,), input.dtype, param_attr,
                   default_initializer="ones")
    bias = _param((c,), input.dtype, bias_attr, is_bias=True)
    scope = global_scope()
    mname = moving_mean_name or unique_name.generate("bn_moving_mean")
    vname = moving_variance_name or unique_name.generate("bn_moving_var")
    mean = scope.find_var(mname)
    var = scope.find_var(vname)
    if mean is None:
        dev = _device(input)
        mean = Tensor(torch.zeros((c,), dtype=input.dtype, device=dev),
                      stop_gradient=True, name=mname)
        var = Tensor(torch.ones((c,), dtype=input.dtype, device=dev),
                     stop_gradient=True, name=vname)
        scope.set_var(mname, mean)
        scope.set_var(vname, var)
    training = not (is_test or use_global_stats)
    out, new_mean, new_var = _apply(
        "batch_norm", input, mean, var, scale, bias, training, momentum,
        epsilon, data_layout)
    if training:
        _assign(mean, new_mean)
        _assign(var, new_var)
    return _act(out, act)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,  # noqa: A002
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    """reference: paddle.static.nn.layer_norm."""
    shp = tuple(int(s) for s in input.shape[begin_norm_axis:])
    w = _param(shp, input.dtype, param_attr,
               default_initializer="ones") if scale else None
    b = _param(shp, input.dtype, bias_attr, is_bias=True) if shift else None
    out = _apply("layer_norm", input, shp, w, b, epsilon)
    return _act(out, act)


def group_norm(input, groups, epsilon=1e-5, param_attr=None,  # noqa: A002
               bias_attr=None, act=None, data_layout="NCHW", name=None):
    """reference: paddle.static.nn.group_norm."""
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    w = _param((c,), input.dtype, param_attr, default_initializer="ones")
    b = _param((c,), input.dtype, bias_attr, is_bias=True)
    out = _apply("group_norm", input, groups, w, b, epsilon, data_layout)
    return _act(out, act)


def instance_norm(input, epsilon=1e-5, param_attr=None,  # noqa: A002
                  bias_attr=None, name=None):
    """reference: paddle.static.nn.instance_norm."""
    c = input.shape[1]
    w = None if param_attr is False else _param(
        (c,), input.dtype, param_attr, default_initializer="ones")
    b = None if bias_attr is False else _param(
        (c,), input.dtype, bias_attr, is_bias=True)
    return _apply("instance_norm", input, w, b, epsilon)


def data_norm(input, act=None, epsilon=1e-4, param_attr=None,  # noqa: A002
              data_layout="NCHW", in_place=False, name=None,
              moving_mean_name=None, moving_variance_name=None,
              do_model_average_for_mean_and_var=True, slot_dim=-1,
              sync_stats=False, summary_decay_rate=0.9999999,
              enable_scale_and_shift=False):
    """reference: paddle.static.nn.data_norm (CTR stats normalization)."""
    c = input.shape[-1]
    scope = global_scope()
    from ..framework import unique_name
    base = name or unique_name.generate("data_norm")
    names = [f"{base}.batch_size", f"{base}.batch_sum",
             f"{base}.batch_square_sum"]
    vals = [scope.find_var(n) for n in names]
    if vals[0] is None:
        f = dict(dtype=input.dtype, device=_device(input))
        vals = [Tensor(torch.full((c,), 1e4, **f)),
                Tensor(torch.zeros((c,), **f)),
                Tensor(torch.full((c,), 1e4, **f))]
        for n, v in zip(names, vals):
            scope.set_var(n, v)
    out = _apply("data_norm", input, vals[0], vals[1], vals[2], epsilon)
    return _act(out, act)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """reference: paddle.static.nn.spectral_norm — returns the
    spectrally-normalized weight (operators/spectral_norm_op)."""
    w = weight.value if isinstance(weight, Tensor) else torch.as_tensor(
        weight)
    wm = torch.movedim(w, dim, 0).reshape(w.shape[dim], -1)
    key_u = torch.ones((wm.shape[0],), dtype=w.dtype, device=w.device)
    u = key_u / (torch.linalg.vector_norm(key_u) + eps)
    v = None
    for _ in range(max(1, power_iters)):
        v = wm.T @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = wm @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    sigma = u @ wm @ v
    return Tensor._wrap(w / sigma)


def prelu(x, mode, param_attr=None, data_format="NCHW", name=None):
    """reference: paddle.static.nn.prelu (modes: all/channel/element)."""
    if mode == "all":
        shape = (1,)
    elif mode == "channel":
        c = x.shape[1] if data_format == "NCHW" else x.shape[-1]
        shape = (c,)
    elif mode == "element":
        shape = tuple(x.shape[1:])
    else:
        raise InvalidArgumentError(f"unknown prelu mode {mode!r}")
    a = _param(shape, x.dtype, param_attr, default_initializer=0.25)
    if mode == "channel" and x.ndim > 2 and data_format == "NCHW":
        a = _apply("reshape", a, (1, -1) + (1,) * (x.ndim - 2))
    return _apply("prelu", x, a)


def row_conv(input, future_context_size, param_attr=None,  # noqa: A002
             act=None):
    """reference: paddle.static.nn.row_conv (lookahead conv)."""
    d = input.shape[-1]
    w = _param((future_context_size + 1, d), input.dtype, param_attr)
    out = _apply("row_conv", input, w)
    return _act(out, act)


def nce(input, label, num_total_classes, sample_weight=None,  # noqa: A002
        param_attr=None, bias_attr=None, num_neg_samples=None, name=None,
        sampler="uniform", custom_dist=None, seed=0, is_sparse=False):
    """reference: paddle.static.nn.nce (noise-contrastive estimation)."""
    d = input.shape[-1]
    w = _param((num_total_classes, d), input.dtype, param_attr)
    b = None if bias_attr is False else _param(
        (num_total_classes,), input.dtype, bias_attr, is_bias=True)
    return _apply("nce", input, label, w, b, num_neg_samples or 10)


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    """reference: paddle.static.nn.bilinear_tensor_product."""
    w = _param((size, x.shape[-1], y.shape[-1]), x.dtype, param_attr)
    b = None if bias_attr is False else _param(
        (size,), x.dtype, bias_attr, is_bias=True)
    out = _apply("bilinear_tensor_product", x, y, w, b)
    return _act(out, act)


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=(0.1, 0.1, 0.2, 0.2), flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None,
                   min_max_aspect_ratios_order=False):
    """reference: paddle.static.nn.multi_box_head (SSD detection head,
    fluid/layers/detection.py). Builds per-feature-map loc/conf conv heads
    + prior boxes; returns (mbox_locs, mbox_confs, boxes, variances).

    With ``name`` (which the JAX function ignores) the head's
    convolutions take the parameter names ``{name}.loc{i}.w`` / ``.b``
    and ``{name}.conf{i}.w`` / ``.b``, as the reference names a program's
    parameters, so a second call reuses them from the scope and the
    head can train; without it each call draws new ones, as in JAX."""

    def attr(kind, i, part):
        if name is None:
            return None
        from ..nn.initializer import ParamAttr
        return ParamAttr(name=f"{name}.{kind}{i}.{part}")

    if min_sizes is None:
        # reference formula: evenly spaced ratios of the base size
        num_layer = len(inputs)
        min_sizes, max_sizes = [], []
        step = int((max_ratio - min_ratio) / (num_layer - 2 + 1e-9)) \
            if num_layer > 2 else 0
        min_sizes.append(base_size * 0.10)
        max_sizes.append(base_size * 0.20)
        for ratio in range(min_ratio, max_ratio + 1, max(step, 1)):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
        min_sizes = min_sizes[:num_layer]
        max_sizes = max_sizes[:num_layer]

    locs, confs, boxes_all, vars_all = [], [], [], []
    ih, iw = int(image.shape[2]), int(image.shape[3])
    for i, feat in enumerate(inputs):
        ms = min_sizes[i]
        ms_list = ms if isinstance(ms, (list, tuple)) else [ms]
        mx = max_sizes[i] if max_sizes else None
        mx_list = (mx if isinstance(mx, (list, tuple)) else [mx]) \
            if mx is not None else None
        ar = aspect_ratios[i]
        ar_list = ar if isinstance(ar, (list, tuple)) else [ar]
        fh, fw = int(feat.shape[2]), int(feat.shape[3])
        step_i = float(steps[i]) if steps else 0.0
        boxes, variances = _apply(
            "prior_box", fh, fw, ih, iw, ms_list,
            max_sizes=mx_list or (), aspect_ratios=ar_list, flip=flip,
            clip=clip, step_w=step_i, step_h=step_i, offset=offset,
            variances=tuple(variance))
        num_priors = int(boxes.shape[2])  # [fh, fw, num_priors, 4]
        loc = conv2d(feat, num_priors * 4, kernel_size, stride=stride,
                     padding=pad, param_attr=attr("loc", i, "w"),
                     bias_attr=attr("loc", i, "b"))
        conf = conv2d(feat, num_priors * num_classes, kernel_size,
                      stride=stride, padding=pad,
                      param_attr=attr("conf", i, "w"),
                      bias_attr=attr("conf", i, "b"))
        n = feat.shape[0]
        loc = _apply("reshape", _apply("transpose", loc, (0, 2, 3, 1)),
                     (n, -1, 4))
        conf = _apply("reshape", _apply("transpose", conf, (0, 2, 3, 1)),
                      (n, -1, num_classes))
        locs.append(loc)
        confs.append(conf)
        boxes_all.append(_apply("reshape", boxes, (-1, 4)))
        vars_all.append(_apply("reshape", variances, (-1, 4)))
    mbox_locs = _apply("concat", locs, 1)
    mbox_confs = _apply("concat", confs, 1)
    boxes = _apply("concat", boxes_all, 0)
    variances = _apply("concat", vars_all, 0)
    return mbox_locs, mbox_confs, boxes, variances


def _wrapped(name):
    from .. import dispatch
    return dispatch.wrapped_ops[name]


def __getattr__(attr):
    # control-flow + sequence + crf_decoding re-exports share the one
    # registered kernel set (same-kernel-both-modes, like the reference's
    # AllOpKernels sharing).
    if attr in {"cond", "case", "switch_case", "while_loop"}:
        from ..ops import control_flow
        return getattr(control_flow, attr)
    _direct = {
        "crf_decoding",
        "sequence_conv", "sequence_softmax", "sequence_pool",
        "sequence_concat", "sequence_first_step", "sequence_last_step",
        "sequence_slice", "sequence_expand", "sequence_expand_as",
        "sequence_pad", "sequence_unpad", "sequence_reshape",
        "sequence_scatter", "sequence_enumerate", "sequence_reverse",
    }
    if attr in _direct:
        return _wrapped(attr)
    if attr == "py_func":
        from .api import py_func as _pf
        return _pf
    raise AttributeError(f"module 'paddle_tpu_torch.static.nn' has no "
                         f"attribute {attr!r}")
