"""The port's pools and norms against the JAX package's, on the CPU.

Pools (``ops/nn_functional.py``): max and average in 1-D, 2-D and 3-D,
``max_pool2d(return_mask=True)`` with JAX's indices (ties, padding,
NHWC), the adaptive pools in 1-D / 2-D / 3-D with their masks and the
general windows, ``lp_pool2d``, ``ops/vision_extra.py`` ``max_unpool2d``
closing the round trip, and the 13 layers of ``nn/pooling.py``. Norms:
``rms_norm``, ``layer_norm``, ``instance_norm``, ``group_norm``,
``normalize``, ``local_response_norm``, ``data_norm`` and
``batch_norm``'s dtype mixes (a bf16 input with f32 or bf16 statistics
and f32 or bf16 scale and bias), and the layers of ``nn/norm.py``
(``BatchNorm`` with ``act``, ``SyncBatchNorm.convert_sync_batchnorm``
and the fused gate's refusal of it, ``GroupNorm``, ``InstanceNorm*``,
``LocalResponseNorm``, ``DataNorm``'s accumulators, ``SpectralNorm``'s
``weight_u`` / ``weight_v``, ``LayerNorm``, ``RMSNorm``).

Tolerances, stated: fp32 forward within 1e-5 absolute and relative,
gradients within 1e-5 relative in L2 (``test_torch_conv.parity``);
masks and max values exact; bf16 outputs within 2u of the largest
magnitude (u = 2^-8: two roundings of values that agree far below an
ulp can land one ulp apart), running statistics within 1e-5 relative
(f32 sums in other orders) and bf16 ones within 2u.
"""

import _torch_threads  # noqa: F401

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu.ops import nn_functional as jnf
from paddle_tpu.ops import vision_extra as jve
from paddle_tpu.tensor import Tensor

from paddle_tpu_torch.nn import norm as tnorm
from paddle_tpu_torch.nn import pooling as tpool
from paddle_tpu_torch.nn.layer import load_jax_state
from paddle_tpu_torch.ops import nn_functional as tnf
from paddle_tpu_torch.ops import vision_extra as tve
from paddle_tpu_torch.ops.kernels import fused_conv_block as FC
from paddle_tpu_torch.vision import models as tmodels
from test_torch_conv import TOL, parity
from test_torch_transformer import jax_state

U = 2.0 ** -8


@pytest.fixture(scope="module", autouse=True)
def _single_device_jax():
    """The JAX layers of this file on one device, whatever ran before in
    the worker (``tests/test_torch_hot_swap.py``'s guard)."""
    from paddle_tpu.distributed.topology import (
        get_hybrid_communicate_group, set_hybrid_communicate_group)
    prev = get_hybrid_communicate_group()
    set_hybrid_communicate_group(None)
    try:
        yield
    finally:
        set_hybrid_communicate_group(prev)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _ties(shape, seed=0):
    """ReLU outputs: half the entries 0, so most windows tie."""
    return np.maximum(_x(shape, seed), 0.0)


def _same(got, want, exact=False, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = want.detach().numpy() if isinstance(want, torch.Tensor) else \
        want
    want = np.asarray(want)
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# -- pools ----------------------------------------------------------------------

POOL2D_CASES = {
    "nchw_k3_s2_p1": ("NCHW", 3, 2, 1),
    "nhwc_k2": ("NHWC", 2, None, 0),
    "nchw_same": ("NCHW", 3, 2, "SAME"),
    "nhwc_lo_hi": ("NHWC", 3, (2, 1), [0, 2, 1, 1]),
    "nchw_valid_rect": ("NCHW", (3, 2), (1, 2), "VALID"),
}


@pytest.mark.parametrize("case", list(POOL2D_CASES))
def test_pool2d_matches_jax(case):
    fmt, k, s, p = POOL2D_CASES[case]
    shape = (2, 3, 9, 8) if fmt == "NCHW" else (2, 9, 8, 3)
    x = _x(shape, 1)
    parity(lambda x: jnf.max_pool2d(x, k, s, p, data_format=fmt),
           lambda x: tnf.max_pool2d(x, k, s, p, data_format=fmt), [x])
    for exclusive in (True, False):
        parity(lambda x: jnf.avg_pool2d(x, k, s, p, exclusive=exclusive,
                                        data_format=fmt),
               lambda x: tnf.avg_pool2d(x, k, s, p, exclusive=exclusive,
                                        data_format=fmt), [x])
    parity(lambda x: jnf.avg_pool2d(x, k, s, p, divisor_override=5,
                                    data_format=fmt),
           lambda x: tnf.avg_pool2d(x, k, s, p, divisor_override=5,
                                    data_format=fmt), [x])


MASK_CASES = {
    "nchw_k2": ("NCHW", 2, 2, 0),
    "nhwc_k3_s2_p1": ("NHWC", 3, 2, 1),
    "nchw_k3_s1_lo_hi": ("NCHW", 3, 1, [0, 1, 1, 0]),
    "nhwc_same_taken_as_none": ("NHWC", 2, 2, "SAME"),
    "nchw_rect": ("NCHW", (3, 2), (2, 1), (1, 0)),
}


@pytest.mark.parametrize("case", list(MASK_CASES))
def test_max_pool2d_mask_matches_jax_with_ties(case):
    """Indices equal JAX's exactly: the first maximum of the window's
    row-major scan wins a tie, padded positions index -1, int32."""
    fmt, k, s, p = MASK_CASES[case]
    shape = (2, 3, 8, 7) if fmt == "NCHW" else (2, 8, 7, 3)
    x = _ties(shape, 2)
    wo, wm = jnf.max_pool2d(jnp.asarray(x), k, s, p, return_mask=True,
                            data_format=fmt)
    go, gm = tnf.max_pool2d(torch.from_numpy(x), k, s, p, return_mask=True,
                            data_format=fmt)
    _same(go, wo, exact=True)
    assert gm.dtype == torch.int32
    _same(gm, wm, exact=True)
    assert int((gm.numpy() < 0).sum()) == int((np.asarray(wm) < 0).sum())


def test_max_pool2d_mask_tie_order_is_the_row_major_scan():
    x = np.zeros((1, 1, 2, 2), np.float32)
    _, m = tnf.max_pool2d(torch.from_numpy(x), 2, return_mask=True)
    _, jm = jnf.max_pool2d(jnp.asarray(x), 2, return_mask=True)
    assert int(m.reshape(())) == int(np.asarray(jm).reshape(())) == 0
    x[0, 0, 1, 0] = x[0, 0, 0, 1] = 1.0
    _, m = tnf.max_pool2d(torch.from_numpy(x), 2, return_mask=True)
    assert int(m.reshape(())) == 1  # (0, 1) comes before (1, 0)
    # on ReLU outputs the tie order decides: windows of zeros make the
    # last maximum of the scan (what a ">=" walk keeps) differ from
    # JAX's first, which the port's indices equal
    t = _ties((2, 3, 8, 6), 2)
    _, jm = jnf.max_pool2d(jnp.asarray(t), 2, 2, 0, return_mask=True)
    _, m = tnf.max_pool2d(torch.from_numpy(t), 2, 2, 0, return_mask=True)
    win = t.reshape(2, 3, 4, 2, 3, 2).transpose(0, 1, 2, 4, 3, 5).reshape(
        2, 3, 4, 3, 4)  # each window's (dy, dx) scan, row-major
    last = 3 - np.argmax(win[..., ::-1], -1)
    last_idx = (2 * np.arange(4)[:, None] + last // 2) * 6 + \
        2 * np.arange(3)[None, :] + last % 2
    assert (last_idx != np.asarray(jm)).any()
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))


def test_max_unpool2d_closes_the_mask_round_trip():
    x = _ties((2, 3, 8, 6), 3)
    wo, wm = jnf.max_pool2d(jnp.asarray(x), 2, 2, 0, return_mask=True)
    go, gm = tnf.max_pool2d(torch.from_numpy(x), 2, 2, 0, return_mask=True)
    want = jve.max_unpool2d(wo, wm, 2)
    got = tve.max_unpool2d(go, gm, 2)
    _same(got, want, exact=True)
    # every pooled maximum lands back where it came from
    back = got.numpy()
    assert np.all((back == 0) | (back == x))
    _same(tve.max_unpool2d(go, gm, 2, output_size=(9, 7)),
          jve.max_unpool2d(wo, wm, 2, output_size=(9, 7)), exact=True)


@pytest.mark.parametrize("k,s,p", [(3, 2, 1), (2, None, 0), (4, 1, 2)])
def test_pool1d_matches_jax(k, s, p):
    x = _x((2, 3, 11), 4)
    parity(lambda x: jnf.max_pool1d(x, k, s, p),
           lambda x: tnf.max_pool1d(x, k, s, p), [x])
    parity(lambda x: jnf.avg_pool1d(x, k, s, p),
           lambda x: tnf.avg_pool1d(x, k, s, p), [x])
    t = _ties((2, 3, 11), 4)
    wo, wm = jnf.max_pool1d(jnp.asarray(t), k, s, p, return_mask=True)
    go, gm = tnf.max_pool1d(torch.from_numpy(t), k, s, p, return_mask=True)
    _same(go, wo, exact=True)
    _same(gm, wm, exact=True)


@pytest.mark.parametrize("fmt,k,s,p", [("NCDHW", 3, 2, 1),
                                       ("NDHWC", 2, None, 0),
                                       ("NCDHW", (2, 3, 2), 1, "SAME")])
def test_pool3d_matches_jax(fmt, k, s, p):
    x = _x((2, 3, 6, 7, 5) if fmt == "NCDHW" else (2, 6, 7, 5, 3), 5)
    parity(lambda x: jnf.max_pool3d(x, k, s, p, data_format=fmt),
           lambda x: tnf.max_pool3d(x, k, s, p, data_format=fmt), [x])
    parity(lambda x: jnf.avg_pool3d(x, k, s, p, data_format=fmt),
           lambda x: tnf.avg_pool3d(x, k, s, p, data_format=fmt), [x])


@pytest.mark.parametrize("fmt,out", [("NCHW", 3), ("NHWC", (4, 2)),
                                     ("NCHW", (5, 3)), ("NHWC", 1)])
def test_adaptive_pool2d_matches_jax(fmt, out):
    """Divisible sizes go through the plain pools, the others through the
    general windows; the max pool's mask where the sizes divide."""
    shape = (2, 3, 12, 8) if fmt == "NCHW" else (2, 12, 8, 3)
    x = _x(shape, 6)
    parity(lambda x: jnf.adaptive_avg_pool2d(x, out, fmt),
           lambda x: tnf.adaptive_avg_pool2d(x, out, fmt), [x])
    parity(lambda x: jnf.adaptive_max_pool2d(x, out, data_format=fmt),
           lambda x: tnf.adaptive_max_pool2d(x, out, data_format=fmt), [x])
    t = _ties(shape, 6)
    want = jnf.adaptive_max_pool2d(jnp.asarray(t), out, True, fmt)
    got = tnf.adaptive_max_pool2d(torch.from_numpy(t), out, True, fmt)
    if isinstance(want, tuple):
        _same(got[0], want[0], exact=True)
        _same(got[1], want[1], exact=True)
    else:  # the general windows return no mask, as in JAX
        _same(got, want, exact=True)


@pytest.mark.parametrize("out", [4, 5])
def test_adaptive_pool1d_matches_jax(out):
    x = _x((2, 3, 12), 7)
    parity(lambda x: jnf.adaptive_avg_pool1d(x, out),
           lambda x: tnf.adaptive_avg_pool1d(x, out), [x])
    parity(lambda x: jnf.adaptive_max_pool1d(x, out),
           lambda x: tnf.adaptive_max_pool1d(x, out), [x])
    t = _ties((2, 3, 12), 7)
    if 12 % out:
        with pytest.raises(NotImplementedError):
            tnf.adaptive_max_pool1d(torch.from_numpy(t), out, True)
        return
    wo, wm = jnf.adaptive_max_pool1d(jnp.asarray(t), out, True)
    go, gm = tnf.adaptive_max_pool1d(torch.from_numpy(t), out, True)
    _same(go, wo, exact=True)
    _same(gm, wm, exact=True)


@pytest.mark.parametrize("fmt,out", [("NCDHW", (3, 2, 5)),
                                     ("NDHWC", (2, 3, 2))])
def test_adaptive_pool3d_matches_jax(fmt, out):
    x = _x((2, 3, 6, 7, 5) if fmt == "NCDHW" else (2, 6, 7, 5, 3), 8)
    parity(lambda x: jnf.adaptive_avg_pool3d(x, out, fmt),
           lambda x: tnf.adaptive_avg_pool3d(x, out, fmt), [x])
    parity(lambda x: jnf.adaptive_max_pool3d(x, out, data_format=fmt),
           lambda x: tnf.adaptive_max_pool3d(x, out, data_format=fmt), [x])


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_lp_pool2d_matches_jax(fmt):
    x = _x((2, 3, 9, 8) if fmt == "NCHW" else (2, 9, 8, 3), 9)
    for p in (1, 2, 3):
        parity(lambda x: jnf.lp_pool2d(x, p, 3, 2, 1, data_format=fmt),
               lambda x: tnf.lp_pool2d(x, p, 3, 2, 1, data_format=fmt), [x])


POOL_LAYERS = {
    "MaxPool1D": (dict(kernel_size=3, stride=2, padding=1), (2, 3, 11)),
    "AvgPool1D": (dict(kernel_size=3, stride=2, padding=1), (2, 3, 11)),
    "MaxPool2D": (dict(kernel_size=3, stride=2, padding=1,
                       return_mask=True, data_format="NHWC"), (2, 9, 8, 3)),
    "AvgPool2D": (dict(kernel_size=2, exclusive=False), (2, 3, 9, 8)),
    "MaxPool3D": (dict(kernel_size=2, data_format="NDHWC"),
                  (2, 6, 4, 6, 3)),
    "AvgPool3D": (dict(kernel_size=3, stride=2, padding=1),
                  (2, 3, 6, 7, 5)),
    "AdaptiveAvgPool1D": (dict(output_size=5), (2, 3, 12)),
    "AdaptiveMaxPool1D": (dict(output_size=4, return_mask=True),
                          (2, 3, 12)),
    "AdaptiveAvgPool2D": (dict(output_size=(3, 5), data_format="NHWC"),
                          (2, 9, 10, 3)),
    "AdaptiveMaxPool2D": (dict(output_size=3, return_mask=True),
                          (2, 3, 9, 6)),
    "AdaptiveAvgPool3D": (dict(output_size=2), (2, 3, 6, 7, 5)),
    "AdaptiveMaxPool3D": (dict(output_size=(3, 2, 5)), (2, 3, 6, 7, 5)),
    "LPPool2D": (dict(norm_type=2, kernel_size=3, stride=2),
                 (2, 3, 9, 8)),
}


@pytest.mark.parametrize("name", list(POOL_LAYERS))
def test_pooling_layers_match_jax(name):
    kw, shape = POOL_LAYERS[name]
    x = _ties(shape, 10)
    want = getattr(jnn, name)(**kw)(Tensor(jnp.asarray(x)))
    got = getattr(tpool, name)(**kw)(torch.from_numpy(x))
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w.value, exact=True)
    else:
        _same(got, want.value)


# -- norms ----------------------------------------------------------------------

def test_norm_functionals_match_jax():
    x4 = _x((2, 6, 5, 4), 11)
    g, b = _x((6,), 12) + 1.0, _x((6,), 13)
    parity(jnf.instance_norm, tnf.instance_norm, [x4, g, b])
    for fmt in ("NCHW", "NHWC"):
        xx = x4 if fmt == "NCHW" else np.ascontiguousarray(
            x4.transpose(0, 2, 3, 1))
        parity(lambda x, w, b: jnf.group_norm(x, 3, w, b, 1e-5, fmt),
               lambda x, w, b: tnf.group_norm(x, 3, w, b, 1e-5, fmt),
               [xx, g, b])
        parity(lambda x: jnf.local_response_norm(x, 5, 1e-2, 0.75, 1.5,
                                                 fmt),
               lambda x: tnf.local_response_norm(x, 5, 1e-2, 0.75, 1.5,
                                                 fmt), [xx])
    x3 = _x((2, 7, 8), 14)
    w8 = _x((8,), 15) + 1.0
    parity(lambda x, w: jnf.rms_norm(x, w), lambda x, w: tnf.rms_norm(x, w),
           [x3, w8])
    parity(lambda x: jnf.rms_norm(x, None, 1e-6, 1),
           lambda x: tnf.rms_norm(x, None, 1e-6, 1), [x3])
    parity(lambda x, w, b: jnf.layer_norm(x, (7, 8), w, b),
           lambda x, w, b: tnf.layer_norm(x, (7, 8), w, b),
           [x3, _x((7, 8), 16), _x((7, 8), 17)])
    for p, axis in ((2, 1), (1, -1), (3, 2)):
        parity(lambda x: jnf.normalize(x, p, axis),
               lambda x: tnf.normalize(x, p, axis), [x3])
    size = np.full((8,), 1e4, np.float32) + _x((8,), 18) ** 2
    parity(jnf.data_norm, tnf.data_norm,
           [x3, size, _x((8,), 19), np.abs(_x((8,), 20)) * 1e4])


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("stats", ["float32", "bfloat16"])
@pytest.mark.parametrize("affine", ["float32", "bfloat16"])
def test_batch_norm_dtype_mixes_match_jax(affine, stats, training):
    """A bf16 input with f32 or bf16 running statistics and f32 or bf16
    scale and bias (the bf16 recipe gives bf16 statistics everywhere and
    a bf16 scale and bias to ``downsample.1``): the output dtype and the
    new statistics' dtype are JAX's, the values within the limits
    above."""
    rng = np.random.default_rng(21)
    x = (rng.standard_normal((4, 6, 5, 4)) * 2 + 0.5).astype(np.float32)
    arrs = [x, rng.normal(0, 0.3, 6), rng.uniform(0.5, 2.0, 6),
            rng.uniform(0.5, 1.5, 6), rng.normal(0, 0.2, 6)]
    dts = ["bfloat16", stats, stats, affine, affine]
    jargs = [jnp.asarray(a, jnp.float32).astype(d) for a, d in
             zip(arrs, dts)]
    targs = [torch.tensor(np.asarray(a, np.float32)).to(getattr(torch, d))
             for a, d in zip(arrs, dts)]
    want = jnf.batch_norm(*jargs, training=training)
    got = tnf.batch_norm(*targs, training=training)
    for g, w, limit in zip(got, want, (2 * U, 1e-5, 1e-5)):
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
        wf = np.asarray(w.astype(jnp.float32))
        if g.dtype == torch.bfloat16:
            limit = 2 * U
        assert np.abs(g.float().numpy() - wf).max() <= limit * np.abs(
            wf).max()


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_batch_norm_fluid_layer_with_act_matches_jax(fmt):
    x = _x((4, 6, 5, 3) if fmt == "NCHW" else (4, 5, 3, 6), 22)
    pt.seed(0)
    j = jnn.BatchNorm(6, act="relu", data_layout=fmt)
    t = tnorm.BatchNorm(6, act="relu", data_layout=fmt, device="cpu")
    load_jax_state(t, jax_state(j))
    for _ in range(2):
        _same(t(torch.from_numpy(x)), j(Tensor(jnp.asarray(x))).value)
    for k, v in jax_state(j).items():
        _same(t.state_dict()[k], v)
    assert (t(torch.from_numpy(x)).detach().numpy() >= 0).all()
    t2 = tnorm.BatchNorm(6, is_test=True, device="cpu")
    assert not t2.training


def test_sync_batch_norm_shares_state_and_the_fused_gate_refuses_it(
        monkeypatch):
    """``convert_sync_batchnorm`` swaps every batch norm for a
    ``SyncBatchNorm`` over the same parameters and buffers (one process:
    the same numbers); the fused gate admits only ``BatchNorm2D`` and so
    declines the converted bottleneck, as the JAX gate does."""
    m = tmodels.resnet50(data_format="NHWC", num_classes=10, device="cpu")
    m.eval()
    block = m.layer1[1]
    FC.enable_fused_conv_eval(True)
    monkeypatch.setattr(FC, "_device_admits", lambda device_type: True)
    try:
        assert FC.fused_bottleneck_supported(block, (1, 56, 56, 256),
                                             "NHWC")
        bn1_weight = block.bn1.weight
        conv = tnorm.SyncBatchNorm.convert_sync_batchnorm(m)
        assert conv is m
        assert type(block.bn1) is tnorm.SyncBatchNorm
        assert block.bn1.weight is bn1_weight
        assert not any(type(s) is tnorm.BatchNorm2D for s in m.modules())
        assert not FC.fused_bottleneck_supported(block, (1, 56, 56, 256),
                                                 "NHWC")
    finally:
        FC.enable_fused_conv_eval(False)
    jm = jnn.Sequential(jnn.Conv2D(3, 4, 3), jnn.BatchNorm2D(4))
    jconv = jnn.SyncBatchNorm.convert_sync_batchnorm(jm)
    assert type(jconv[1]).__name__ == "SyncBatchNorm"
    x = _x((2, 4, 6, 6), 23)
    s = tnorm.SyncBatchNorm(4, device="cpu")
    b = tnorm.BatchNorm2D(4, device="cpu")
    _same(s(torch.from_numpy(x)), b(torch.from_numpy(x)), exact=True)
    _same(s._mean, b._mean, exact=True)


NORM_LAYERS = {
    "GroupNorm": ((3, 6), dict(data_format="NHWC"), (2, 5, 4, 6)),
    "InstanceNorm1D": ((6,), {}, (2, 6, 9)),
    "InstanceNorm2D": ((6,), {}, (2, 6, 5, 4)),
    "InstanceNorm3D": ((6,), {}, (2, 6, 3, 4, 3)),
    "LocalResponseNorm": ((3,), dict(alpha=1e-2), (2, 6, 5, 4)),
    "LayerNorm": (((5, 4),), {}, (2, 6, 5, 4)),
    "RMSNorm": ((4,), {}, (2, 6, 5, 4)),
}


@pytest.mark.parametrize("name", list(NORM_LAYERS))
def test_norm_layers_match_jax(name):
    args, kw, shape = NORM_LAYERS[name]
    pt.seed(0)
    j = getattr(jnn, name)(*args, **kw)
    extra = {} if name == "LocalResponseNorm" else {"device": "cpu"}
    t = getattr(tnorm, name)(*args, **kw, **extra)
    assert set(t.state_dict()) == set(j.state_dict())
    state = jax_state(j)
    rng = np.random.default_rng(24)
    state = {k: v + rng.normal(0, 0.1, v.shape).astype(v.dtype)
             for k, v in state.items()}
    load_jax_state(t, state)
    j.set_state_dict(state)
    x = _x(shape, 25)
    _same(t(torch.from_numpy(x)), j(Tensor(jnp.asarray(x))).value)


def test_instance_norm_weight_attr_false_drops_both():
    t = tnorm.InstanceNorm2D(4, weight_attr=False, device="cpu")
    assert t.weight is None and t.bias is None
    t = tnorm.InstanceNorm2D(4, bias_attr=False, device="cpu")
    assert t.bias is not None  # as in the JAX layer


def test_data_norm_accumulates_as_jax():
    x = _x((5, 4), 26) * 3 + 1
    j = jnn.DataNorm(4)
    t = tnorm.DataNorm(4, device="cpu")
    for _ in range(3):
        _same(t(torch.from_numpy(x)), j(Tensor(jnp.asarray(x))).value)
    for k, v in jax_state(j).items():
        np.testing.assert_allclose(t.state_dict()[k].numpy(), v, rtol=1e-6)
    t.eval()
    before = t.batch_size.clone()
    t(torch.from_numpy(x))
    assert torch.equal(t.batch_size, before)


def test_spectral_norm_carries_u_v_and_matches_jax():
    """``weight_u`` / ``weight_v`` cross with the state dict; from the
    same vectors both packages return ``W / sigma`` and update the
    vectors alike, with sigma a constant to the gradient."""
    pt.seed(0)
    j = jnn.SpectralNorm((6, 4, 3), dim=1, power_iters=2)
    t = tnorm.SpectralNorm((6, 4, 3), dim=1, power_iters=2, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in t.state_dict().items()} == \
        {"weight_u": (4,), "weight_v": (18,)}
    load_jax_state(t, jax_state(j))
    w = _x((6, 4, 3), 27)
    for _ in range(2):
        _same(t(torch.from_numpy(w)), j(Tensor(jnp.asarray(w))).value)
        for k, v in jax_state(j).items():
            _same(t.state_dict()[k], v)
    wt = torch.tensor(w, requires_grad=True)
    out = t(wt)
    out.sum().backward()
    sigma = float((wt / out).detach().reshape(-1)[0])
    np.testing.assert_allclose(wt.grad.numpy(), np.full(w.shape, 1 / sigma),
                               rtol=1e-6)


@pytest.mark.parametrize("case", ["list_shape", "int_shape",
                                  "weight_attr_false", "bf16_input"])
def test_nn_layer_norm_is_the_jax_layer(case):
    """``paddle_tpu_torch.nn.LayerNorm`` is JAX's layer: a list
    ``normalized_shape`` normalises the trailing dims, an int the last,
    ``weight_attr=False`` / ``bias_attr=False`` drop the parameters, and
    ``name`` is taken; a bf16 input with fp32 parameters is normalised in
    fp32 and returned in bf16, within 2u of the JAX layer. The models
    build the same class (one ``LayerNorm`` in the port)."""
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.models import gpt as tgpt
    shape, kw, xs = {
        "list_shape": ([4, 8], {}, (2, 3, 4, 8)),
        "int_shape": (8, dict(name="ln"), (2, 3, 4, 8)),
        "weight_attr_false": ([4, 8], dict(weight_attr=False,
                                           bias_attr=False), (2, 3, 4, 8)),
        "bf16_input": (8, {}, (3, 5, 8)),
    }[case]
    pt.seed(0)
    j = jnn.LayerNorm(shape, **kw)
    t = tnn.LayerNorm(shape, **kw, device="cpu")
    assert set(t.state_dict()) == set(j.state_dict())
    if case == "weight_attr_false":
        assert t.weight is None and t.bias is None
    else:
        rng = np.random.default_rng(30)
        state = {k: v + rng.normal(0, 0.1, v.shape).astype(v.dtype)
                 for k, v in jax_state(j).items()}
        load_jax_state(t, state)
        j.set_state_dict(state)
    x = _x(xs, 31)
    if case == "bf16_input":
        xb = torch.from_numpy(x).bfloat16()
        with torch.no_grad():
            got = t(xb)
        assert got.dtype == torch.bfloat16 and t.weight.dtype == \
            torch.float32
        want = j(Tensor(jnp.asarray(xb.float().numpy(), jnp.bfloat16)))
        _same(got.float(), np.asarray(want.value, np.float32), tol=2 * U)
    else:
        with torch.no_grad():
            _same(t(torch.from_numpy(x)), j(Tensor(jnp.asarray(x))).value)
    m = tgpt.GPTForCausalLM(tgpt.gpt_tiny(), device="cpu")
    assert type(m.gpt.ln_f) is tnn.LayerNorm is tnorm.LayerNorm
