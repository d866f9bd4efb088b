"""The port's convolutions against the JAX package's, on the CPU:
``conv1d``, ``conv2d``, ``conv3d``, ``conv2d_transpose``,
``conv1d_transpose`` (``ops/nn_functional.py``) and ``conv3d_transpose``
(``ops/vision_extra.py``), forward and gradient, NCHW and NHWC (and
their 1-D / 3-D forms), with grouped transposes, asymmetric pads,
dilation, ``output_padding`` and ``output_size``; and the layers
``Conv1D``, ``Conv3D`` and the three transposed layers on the JAX
layers' weights (``load_jax_state``).

Tolerances, stated: fp32 on both sides, sums in other orders, outputs of
O(1) (weights scaled by 1/sqrt(fan_in)): forward within 1e-5 absolute
and relative; each input's gradient (a vjp with a seeded cotangent)
within 1e-5 relative in L2.
"""

import _torch_threads  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu.ops import nn_functional as jnf
from paddle_tpu.ops import vision_extra as jve

from paddle_tpu_torch.nn import conv as tconv
from paddle_tpu_torch.nn.layer import load_jax_state
from paddle_tpu_torch.ops import nn_functional as tnf
from paddle_tpu_torch.ops import vision_extra as tve
from test_torch_transformer import jax_state

TOL = 1e-5
GRAD_REL = 1e-5


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def parity(jfn, tfn, arrays, seed=0, tol=TOL, grad_rel=GRAD_REL,
           grads=True):
    """``jfn`` and ``tfn`` over the same float32 ``arrays`` (None kept):
    outputs equal within ``tol``; with ``grads``, the vjp of a seeded
    cotangent for every array within ``grad_rel`` relative in L2."""
    live = [i for i, a in enumerate(arrays) if a is not None]

    def call(fn, vals):
        full = list(arrays)
        for i, v in zip(live, vals):
            full[i] = v
        return fn(*full)

    jvals = [jnp.asarray(arrays[i]) for i in live]
    want, vjp = jax.vjp(lambda *v: call(jfn, v), *jvals)
    tvals = [torch.tensor(arrays[i], requires_grad=grads) for i in live]
    got = call(tfn, tvals)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol,
                               atol=tol)
    if not grads:
        return
    ct = np.random.default_rng(seed + 100).standard_normal(
        want.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(ct))
    got.backward(torch.from_numpy(ct))
    for i, t, g in zip(live, tvals, jgrads):
        g = np.asarray(g)
        err = np.linalg.norm(_np(t.grad) - g) / max(np.linalg.norm(g),
                                                    1e-30)
        assert err <= grad_rel, (i, err)


def _conv_arrays(rng, x_shape, w_shape, fan_in, with_bias, n_out):
    x = rng.standard_normal(x_shape).astype(np.float32)
    w = (rng.standard_normal(w_shape) / np.sqrt(fan_in)).astype(np.float32)
    b = rng.standard_normal(n_out).astype(np.float32) if with_bias \
        else None
    return x, w, b


# (data_format, stride, padding, dilation, groups, with_bias)
CONV1D_CASES = {
    "ncl": ("NCL", 1, 1, 1, 1, True),
    "nlc_s2_same": ("NLC", 2, "SAME", 1, 1, False),
    "ncl_lo_hi_dilated_groups": ("NCL", 1, [1, 2], 2, 2, True),
}


@pytest.mark.parametrize("case", list(CONV1D_CASES))
def test_conv1d_matches_jax(case):
    fmt, stride, padding, dil, groups, with_bias = CONV1D_CASES[case]
    rng = np.random.default_rng(1)
    cin, cout, k = 4, 6, 3
    x, w, b = _conv_arrays(rng, (2, cin, 11) if fmt == "NCL"
                           else (2, 11, cin), (cout, cin // groups, k),
                           cin // groups * k, with_bias, cout)
    parity(lambda x, w, b: jnf.conv1d(x, w, b, stride, padding, dil,
                                      groups, fmt),
           lambda x, w, b: tnf.conv1d(x, w, b, stride, padding, dil,
                                      groups, fmt), [x, w, b])


CONV3D_CASES = {
    "ncdhw": ("NCDHW", 1, 1, 1, 1, True),
    "ndhwc_s2_valid": ("NDHWC", 2, "VALID", 1, 1, False),
    "ncdhw_per_dim_groups": ("NCDHW", (1, 2, 1), [1, 0, 1], 1, 2, True),
}


@pytest.mark.parametrize("case", list(CONV3D_CASES))
def test_conv3d_matches_jax(case):
    fmt, stride, padding, dil, groups, with_bias = CONV3D_CASES[case]
    rng = np.random.default_rng(2)
    cin, cout, k = 4, 6, 3
    sp = (5, 6, 4)
    x, w, b = _conv_arrays(rng, (2, cin) + sp if fmt == "NCDHW"
                           else (2,) + sp + (cin,),
                           (cout, cin // groups, k, k, k),
                           cin // groups * k ** 3, with_bias, cout)
    parity(lambda x, w, b: jnf.conv3d(x, w, b, stride, padding, dil,
                                      groups, fmt),
           lambda x, w, b: tnf.conv3d(x, w, b, stride, padding, dil,
                                      groups, fmt), [x, w, b])


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_conv2d_gradient_matches_jax(fmt):
    rng = np.random.default_rng(3)
    x, w, b = _conv_arrays(rng, (2, 4, 9, 8) if fmt == "NCHW"
                           else (2, 9, 8, 4), (6, 2, 3, 3), 18, True, 6)
    parity(lambda x, w, b: jnf.conv2d(x, w, b, 2, [0, 1, 1, 2], 1, 2, fmt),
           lambda x, w, b: tnf.conv2d(x, w, b, 2, [0, 1, 1, 2], 1, 2, fmt),
           [x, w, b])


# (data_format, stride, padding, output_padding, dilation, groups,
#  output_size, with_bias); the weight is [in, out/groups, k, k]
CONV2DT_CASES = {
    "nchw_s2_pad1_outpad1": ("NCHW", 2, 1, 1, 1, 1, None, True),
    "nhwc_grouped_lo_hi": ("NHWC", 2, [0, 1, 1, 2], 0, 1, 2, None, True),
    "nchw_groups4_dilated": ("NCHW", 3, 2, 2, 2, 4, None, False),
    "nhwc_valid": ("NHWC", 1, "VALID", 0, 1, 1, None, True),
    "nchw_output_size": ("NCHW", 2, 1, 0, 1, 2, (14, 12), True),
    "nhwc_output_size_per_dim": ("NHWC", (2, 3), (1, 0), 0, 1, 1,
                                 (14, 19), False),
}


@pytest.mark.parametrize("case", list(CONV2DT_CASES))
def test_conv2d_transpose_matches_jax(case):
    fmt, stride, padding, opad, dil, groups, osize, with_bias = \
        CONV2DT_CASES[case]
    rng = np.random.default_rng(4)
    cin, cout, k = 8, 12, 3
    x, w, b = _conv_arrays(rng, (2, cin, 7, 6) if fmt == "NCHW"
                           else (2, 7, 6, cin), (cin, cout // groups, k, k),
                           cin // groups * k * k, with_bias, cout)
    kw = dict(stride=stride, padding=padding, output_padding=opad,
              dilation=dil, groups=groups, output_size=osize,
              data_format=fmt)
    parity(lambda x, w, b: jnf.conv2d_transpose(x, w, b, **kw),
           lambda x, w, b: tnf.conv2d_transpose(x, w, b, **kw), [x, w, b])


def test_conv2d_transpose_output_size_range_and_same_raise():
    x = torch.zeros(1, 2, 5, 5)
    w = torch.zeros(2, 3, 3, 3)
    with pytest.raises(ValueError, match="unreachable"):
        tnf.conv2d_transpose(x, w, stride=2, padding=1, output_size=(11, 11))
    with pytest.raises(ValueError, match="unreachable"):
        jnf.conv2d_transpose(jnp.zeros((1, 2, 5, 5)), jnp.zeros((2, 3, 3, 3)),
                             stride=2, padding=1, output_size=(11, 11))
    # the JAX function has no pads for 'SAME' and fails on them; the port
    # says why
    with pytest.raises(TypeError):
        jnf.conv2d_transpose(jnp.zeros((1, 2, 5, 5)), jnp.zeros((2, 3, 3, 3)),
                             stride=2, padding="SAME")
    with pytest.raises(ValueError, match="SAME"):
        tnf.conv2d_transpose(x, w, stride=2, padding="SAME")


CONV1DT_CASES = {
    "ncl_s2": ("NCL", 2, 1, 1, 1, None),
    "nlc_output_size": ("NLC", 3, 2, 0, 1, 22),
    "ncl_dilated_groups": ("NCL", 2, 0, 0, 2, None),
}


@pytest.mark.parametrize("case", list(CONV1DT_CASES))
def test_conv1d_transpose_matches_jax(case):
    fmt, stride, padding, opad, groups, osize = CONV1DT_CASES[case]
    rng = np.random.default_rng(5)
    cin, cout, k = 4, 6, 3
    x, w, b = _conv_arrays(rng, (2, cin, 8) if fmt == "NCL" else
                           (2, 8, cin), (cin, cout // groups, k),
                           cin // groups * k, True, cout)
    kw = dict(stride=stride, padding=padding, output_padding=opad,
              dilation=groups, groups=groups, output_size=osize,
              data_format=fmt)
    parity(lambda x, w, b: jnf.conv1d_transpose(x, w, b, **kw),
           lambda x, w, b: tnf.conv1d_transpose(x, w, b, **kw), [x, w, b])


@pytest.mark.parametrize("fmt,stride,padding,opad,osize", [
    ("NCDHW", 2, 1, 1, None),
    ("NDHWC", (1, 2, 2), (0, 1, 1), 0, None),
    ("NCDHW", 2, 0, 0, (11, 9, 10)),
])
def test_conv3d_transpose_matches_jax(fmt, stride, padding, opad, osize):
    rng = np.random.default_rng(6)
    cin, cout, k = 4, 5, 3
    sp = (5, 4, 4)
    x, w, b = _conv_arrays(rng, (2, cin) + sp if fmt == "NCDHW"
                           else (2,) + sp + (cin,), (cin, cout, k, k, k),
                           cin * k ** 3, True, cout)
    kw = dict(stride=stride, padding=padding, output_padding=opad,
              output_size=osize, data_format=fmt)
    parity(lambda x, w, b: jve.conv3d_transpose(x, w, b, **kw),
           lambda x, w, b: tve.conv3d_transpose(x, w, b, **kw), [x, w, b])
    with pytest.raises(NotImplementedError):
        tve.conv3d_transpose(torch.zeros(1, 4, 3, 3, 3),
                             torch.zeros(4, 1, 3, 3, 3), groups=4)


# -- the layers ---------------------------------------------------------------

LAYER_CASES = {
    "Conv1D": (dict(in_channels=4, out_channels=6, kernel_size=3,
                    padding=1), (2, 4, 9), jnf.conv1d, False),
    "Conv3D": (dict(in_channels=4, out_channels=6, kernel_size=3, stride=2,
                    groups=2, data_format="NDHWC"), (2, 5, 6, 5, 4),
               jnf.conv3d, False),
    "Conv1DTranspose": (dict(in_channels=4, out_channels=6, kernel_size=3,
                             stride=2, padding=1, output_padding=1),
                        (2, 4, 7), jnf.conv1d_transpose, True),
    "Conv2DTranspose": (dict(in_channels=4, out_channels=6, kernel_size=3,
                             stride=2, groups=2, data_format="NHWC"),
                        (2, 5, 6, 4), jnf.conv2d_transpose, True),
    "Conv3DTranspose": (dict(in_channels=4, out_channels=6, kernel_size=3,
                             stride=2, padding=1), (2, 4, 3, 4, 3),
                        jve.conv3d_transpose, True),
}


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_conv_layers_on_jax_weights(name):
    """The port's layer carries the JAX layer's state (names and shapes,
    ``[out, in/g, *k]`` or transposed ``[in, out/g, *k]``) and computes
    the JAX functional on it. The JAX transposed layers pass
    ``data_format`` by position into ``output_size`` and raise, so the
    transposed ones are held against the functional called with it by
    keyword."""
    kw, shape, jfn, transposed = LAYER_CASES[name]
    pt.seed(0)
    j = getattr(jnn, name)(**kw)
    t = getattr(tconv, name)(device="cpu", **kw)
    assert {k: tuple(v.shape) for k, v in t.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in j.state_dict().items()}
    load_jax_state(t, jax_state(j))
    x = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    fmt = kw.get("data_format", {1: "NCL", 2: "NCHW", 3: "NCDHW"}[
        len(shape) - 2])
    w, b = jnp.asarray(j.weight.value), jnp.asarray(j.bias.value)
    args = dict(stride=kw.get("stride", 1), padding=kw.get("padding", 0),
                groups=kw.get("groups", 1), data_format=fmt)
    if transposed:
        args["output_padding"] = kw.get("output_padding", 0)
        if name == "Conv3DTranspose":
            del args["groups"]
        with pytest.raises(ValueError):  # the JAX layer's own call
            j(pt.to_tensor(x))
        want = jfn(jnp.asarray(x), w, b, **args)
    else:
        want = j(pt.to_tensor(x)).value
    got = t(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_layers_draw_kaiming_uniform_and_fan_in_bias():
    """Default draws: weight within ``sqrt(2) * sqrt(3 / fan_in)``, bias
    within ``1 / sqrt(fan_in)``, both with ``in/groups * prod(k)``; the
    transposed layers' weight is ``[in, out/groups, *k]``."""
    gen = torch.Generator().manual_seed(0)
    m = tconv.Conv2DTranspose(8, 12, 3, groups=4, device="cpu",
                              generator=gen)
    assert tuple(m.weight.shape) == (8, 3, 3, 3)
    fan_in = 2 * 9
    w, b = m.weight.detach().numpy(), m.bias.detach().numpy()
    assert np.abs(w).max() <= np.sqrt(2) * np.sqrt(3 / fan_in)
    assert np.abs(w).max() > 0.8 * np.sqrt(2) * np.sqrt(3 / fan_in)
    assert np.abs(b).max() <= 1 / np.sqrt(fan_in)
    assert tconv.Conv3D(2, 4, 3, bias_attr=False, device="cpu").bias is None


def test_deform_conv2d_is_not_yet_ported():
    """``DeformConv2D`` is ported now (the test keeps its name; its
    parity with JAX is in ``test_torch_vision_extra.py``): like every
    entry point it asks for CUDA unless given a device, and it builds
    the JAX layer's parameters on the CPU."""
    with pytest.raises(RuntimeError, match="CUDA"):
        tconv.DeformConv2D(4, 6, 3)
    layer = tconv.DeformConv2D(4, 6, 3, deformable_groups=2, device="cpu")
    assert tuple(layer.weight.shape) == (6, 4, 3, 3)
    assert tuple(layer.bias.shape) == (6,)
    assert layer._deformable_groups == 2
