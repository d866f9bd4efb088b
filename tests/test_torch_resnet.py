"""The port's vision path (``paddle_tpu_torch/ops/nn_functional.py``
convolution, pooling and batch norm; ``nn/``; ``vision/models/
resnet.py``; ``inference/fusion.py``) against the JAX package's.

The same numpy inputs go through the JAX function and its port; whole
models run on weights carried from the JAX model with
``load_jax_state``. Tolerances: functional ops 1e-5 (fp32 on the CPU,
sums in other orders); whole-model logits 1e-4 relative in L2 (fifty
layers of such sums).
"""

import _torch_threads  # noqa: F401

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.inference.fusion import (
    find_foldable_pairs as jfind_foldable_pairs)
from paddle_tpu.ops import nn_functional as jnf
from paddle_tpu.vision import models as jmodels

from paddle_tpu_torch.inference.fusion import (find_foldable_pairs,
                                               fold_preserves_outputs,
                                               fuse_conv_bn)
from paddle_tpu_torch.nn.layer import checkpoint_state, load_jax_state
from paddle_tpu_torch.nn.norm import BatchNorm2D
from paddle_tpu_torch.ops import nn_functional as tnf
from paddle_tpu_torch.vision import models as tmodels

TOL = 1e-5
MODEL_REL_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _rel(got, want):
    got = got.detach().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# -- functional ops -----------------------------------------------------------

# (data_format, stride, padding, dilation, groups, kernel, bias)
CONV_CASES = {
    "nchw_pad1": ("NCHW", 1, 1, 1, 1, 3, False),
    "nhwc_stem_7x7_s2": ("NHWC", 2, 3, 1, 1, 7, False),
    "nchw_same_dilated": ("NCHW", 1, "SAME", 2, 1, 3, True),
    "nhwc_same_s2_uneven": ("NHWC", 2, "same", 1, 1, 4, True),
    "nchw_valid_groups": ("NCHW", 1, "VALID", 1, 2, 3, False),
    "nhwc_per_dim": ("NHWC", (1, 2), [1, 2], 1, 1, 3, True),
    "nchw_lo_hi_pairs": ("NCHW", 2, [0, 1, 1, 2], 1, 1, 3, False),
    "nhwc_groups_dilated": ("NHWC", 1, 2, 2, 4, 3, True),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv2d_matches_jax(case):
    fmt, stride, padding, dilation, groups, k, with_bias = CONV_CASES[case]
    rng = np.random.default_rng(0)
    cin, cout = 8, 12
    shape = (2, cin, 11, 10) if fmt == "NCHW" else (2, 11, 10, cin)
    x = rng.standard_normal(shape).astype(np.float32)
    # Kaiming-scaled weights, as the layers draw them: outputs of order 1
    fan_in = cin // groups * k * k
    w = (rng.standard_normal((cout, cin // groups, k, k))
         / np.sqrt(fan_in)).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32) if with_bias else None
    want = jnf.conv2d(jnp.asarray(x), jnp.asarray(w),
                      None if b is None else jnp.asarray(b), stride, padding,
                      dilation, groups, fmt)
    got = tnf.conv2d(_t(x), _t(w), None if b is None else _t(b), stride,
                     padding, dilation, groups, fmt)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_batch_norm_matches_jax(fmt, training):
    rng = np.random.default_rng(1)
    shape = (3, 6, 5, 4) if fmt == "NCHW" else (3, 5, 4, 6)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    rm = rng.normal(0, 0.3, 6).astype(np.float32)
    rv = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    g = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    b = rng.normal(0, 0.2, 6).astype(np.float32)
    want = jnf.batch_norm(*map(jnp.asarray, (x, rm, rv, g, b)),
                          training=training, momentum=0.9, epsilon=1e-5,
                          data_format=fmt)
    got = tnf.batch_norm(*map(_t, (x, rm, rv, g, b)), training=training,
                         momentum=0.9, epsilon=1e-5, data_format=fmt)
    for gg, ww in zip(got, want):
        _close(gg, ww)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_batch_norm_layer_updates_running_stats_as_jax(fmt):
    from paddle_tpu import nn as jnn
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 7, 6, 5) if fmt == "NCHW"
                            else (4, 6, 5, 7)).astype(np.float32)
    jbn = jnn.BatchNorm2D(7, data_format=fmt)
    bn = BatchNorm2D(7, data_format=fmt, device="cpu")
    assert set(bn.state_dict()) == {"weight", "bias", "_mean", "_variance"}
    for _ in range(2):  # two train steps: the update compounds
        want = jbn(pt.Tensor(jnp.asarray(x)))
        got = bn(_t(x))
        _close(got, want.value)
    _close(bn._mean, jbn._mean.value)
    _close(bn._variance, jbn._variance.value)
    jbn.eval()
    bn.eval()
    _close(bn(_t(x)), jbn(pt.Tensor(jnp.asarray(x))).value)


# (kernel, stride, padding)
POOL_CASES = {"resnet_3_s2_p1": (3, 2, 1), "2x2": (2, None, 0),
              "same_3_s2": (3, 2, "SAME"), "uneven_pairs": (3, 1, [0, 1, 2, 1])}


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", list(POOL_CASES))
def test_pools_match_jax(case, fmt):
    k, s, p = POOL_CASES[case]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 9, 8) if fmt == "NCHW"
                            else (2, 9, 8, 3)).astype(np.float32)
    want = jnf.max_pool2d(jnp.asarray(x), k, s, p, data_format=fmt)
    got = tnf.max_pool2d(_t(x), k, s, p, data_format=fmt)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)
    for exclusive in (True, False):
        want = jnf.avg_pool2d(jnp.asarray(x), k, s, p, exclusive=exclusive,
                              data_format=fmt)
        got = tnf.avg_pool2d(_t(x), k, s, p, exclusive=exclusive,
                             data_format=fmt)
        _close(got, want)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("out", [1, 3, (2, 3)])
def test_adaptive_avg_pool2d_matches_jax(out, fmt):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 7, 7) if fmt == "NCHW"
                            else (2, 7, 7, 5)).astype(np.float32)
    want = jnf.adaptive_avg_pool2d(jnp.asarray(x), out, data_format=fmt)
    got = tnf.adaptive_avg_pool2d(_t(x), out, data_format=fmt)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


# -- whole models -------------------------------------------------------------

def _jax_model(ctor, **kw):
    pt.seed(0)
    m = ctor(**kw)
    m.eval()
    # running statistics away from (0, 1), so BN and the fold matter
    rng = np.random.default_rng(1)
    from paddle_tpu import nn as jnn
    for layer in m.sublayers():
        if isinstance(layer, jnn.BatchNorm2D):
            n = layer._num_features
            layer._mean.value = jnp.asarray(rng.normal(0, 0.3, n),
                                            jnp.float32)
            layer._variance.value = jnp.asarray(rng.uniform(0.5, 2.0, n),
                                                jnp.float32)
    return m


def _jax_state(layer):
    return {k: np.asarray(v.value) for k, v in layer.state_dict().items()}


def _port_model(name, jm, **kw):
    m = getattr(tmodels, name)(device="cpu", **kw)
    load_jax_state(m, _jax_state(jm))
    return m.eval()


def _jax_logits(jm, x):
    with pt.no_grad():
        return np.asarray(jm(pt.Tensor(jnp.asarray(x))).value)


@pytest.fixture(scope="module")
def jax_resnet50():
    """One JAX ResNet-50 (NCHW) for the tests that only read it."""
    return _jax_model(jmodels.resnet50)


def test_resnet50_state_dict_loads_from_jax_without_renaming(jax_resnet50):
    jm = jax_resnet50
    state = _jax_state(jm)
    m = _port_model("resnet50", jm)
    own = m.state_dict()
    assert set(own) == set(state)
    assert not any("num_batches_tracked" in k for k in own)
    assert tuple(own["fc.weight"].shape) == (2048, 1000)
    assert "layer1.0.bn1._mean" in own
    back = checkpoint_state(m)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k], v)


def test_resnet18_nchw_logits_match_jax():
    jm = _jax_model(jmodels.resnet18)
    m = _port_model("resnet18", jm)
    x = np.random.default_rng(5).standard_normal((2, 3, 64, 64)).astype(
        np.float32)
    want = _jax_logits(jm, x)
    with torch.inference_mode():
        got = m(_t(x))
    assert tuple(got.shape) == (2, 1000)
    assert _rel(got, want) < MODEL_REL_TOL


def test_fuse_conv_bn_matches_jax(jax_resnet50):
    """The same 53 fold sites as the JAX pass finds, and logits that stay
    those of the JAX model (the JAX fold's own equality is the JAX
    package's test)."""
    jm = jax_resnet50
    m = _port_model("resnet50", jm)
    x = np.random.default_rng(7).standard_normal((1, 3, 64, 64)).astype(
        np.float32)
    with torch.inference_mode():
        before = m(_t(x))
    assert len(list(find_foldable_pairs(m))) == 53
    folded = copy.deepcopy(m)
    assert fuse_conv_bn(folded) == 53 == len(list(jfind_foldable_pairs(jm)))
    assert not any(isinstance(mod, BatchNorm2D) for mod in folded.modules())
    want = _jax_logits(jm, x)
    with torch.inference_mode():
        got = folded(_t(x))
    assert _rel(got, want) < MODEL_REL_TOL
    assert _rel(got, before.numpy()) < MODEL_REL_TOL
    assert fold_preserves_outputs(m, folded, [_t(x)])
    assert folded.conv1.bias is not None
    assert not folded.conv1.bias.requires_grad
    assert fuse_conv_bn(folded) == 0


def test_fuse_conv_bn_refuses_train_mode():
    m = tmodels.resnet18(device="cpu")
    with pytest.raises(RuntimeError, match="eval"):
        fuse_conv_bn(m)


def test_fold_preserves_outputs_rejects_a_wrong_fold():
    m = tmodels.resnet18(device="cpu").eval()
    bad = copy.deepcopy(m)
    with torch.no_grad():
        bad.fc.weight.mul_(1.5)
    x = torch.randn(1, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    assert fold_preserves_outputs(m, m, [x])
    assert not fold_preserves_outputs(m, bad, [x])


@pytest.mark.parametrize("name", ["resnet18", "resnet34", "resnet50",
                                  "resnet101", "resnet152",
                                  "wide_resnet50_2"])
def test_constructors_build_the_jax_shapes(name):
    m = getattr(tmodels, name)(device="cpu", num_classes=10)
    shapes = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    pt.seed(0)
    jm = getattr(jmodels, name)(num_classes=10)
    jshapes = {k: tuple(v.shape) for k, v in jm.state_dict().items()}
    assert shapes == jshapes
