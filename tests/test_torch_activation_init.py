"""The port's activations, dropouts and initializers against the JAX
package's, on the CPU.

- Every activation functional of ``ops/nn_functional.py`` (``relu6`` to
  ``thresholded_relu``), forward and gradient, on inputs that span each
  branch; the 27 layers of ``nn/activation.py`` on the same inputs
  (``PReLU`` on the JAX layer's weight); ``rrelu`` in eval exactly,
  in training by its properties; ``gumbel_softmax`` by its properties
  (torch's and JAX's streams differ; both draw from the explicit
  generator or the ``core.rng.key_scope`` one).
- ``Flatten``, ``Dropout2D``, ``Dropout3D``, ``AlphaDropout`` and their
  functionals: whole channels dropped, the kept ones scaled, alpha
  dropout's affine map, eval the identity.
- ``nn/initializer.py``: ``Constant``, ``Assign``, ``Dirac`` and
  ``Bilinear`` equal JAX's; the random ones by their ranges and moments
  over 10^5+ draws (``Normal``, ``TruncatedNormal``, ``Uniform``, the
  Xavier and Kaiming pairs) and ``Orthogonal`` by ``Q^T Q = gain^2 I``;
  ``get_initializer``; ``ParamAttr``'s precedence (``attr.initializer``,
  then the layer's own, then the global one, then the default) against
  the JAX layers; ``trainable=False`` skipped by the optimizer as in
  JAX; ``set_global_initializer``; ``name`` kept.

Tolerances, stated: fp32 activations within 1e-5 absolute and relative
and their gradients within 1e-5 relative in L2 (``test_torch_conv.
parity``); deterministic initializers exactly; the moments of n draws
within 5 standard errors (sigma / sqrt(n) for the mean, sigma *
sqrt(2 / n) for the standard deviation); orthogonality within 1e-5.
"""

import _torch_threads  # noqa: F401

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.nn import initializer as jinit
from paddle_tpu.ops import nn_functional as jnf
from paddle_tpu.tensor import Tensor

from paddle_tpu_torch.core import rng
from paddle_tpu_torch.nn import activation as tact
from paddle_tpu_torch.nn import common as tcommon
from paddle_tpu_torch.nn import conv as tconv
from paddle_tpu_torch.nn import initializer as tinit
from paddle_tpu_torch.nn import norm as tnorm
from paddle_tpu_torch.nn.layer import load_jax_state
from paddle_tpu_torch.ops import nn_functional as tnf
from paddle_tpu_torch.optimizer import Momentum
from test_torch_conv import TOL, parity
from test_torch_transformer import jax_state


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


@pytest.fixture
def _global_init_reset():
    yield
    tinit.set_global_initializer(None)
    jinit.set_global_initializer(None)


def _x(shape=(4, 6, 5), seed=0, scale=3.0):
    """Values over each activation's branches, none on a threshold."""
    x = np.random.default_rng(seed).uniform(-scale, scale, shape)
    return x.astype(np.float32)


# name -> (extra positional args, input scale)
ACTIVATIONS = {
    "relu6": ((), 8.0), "leaky_relu": ((0.05,), 3.0), "elu": ((0.7,), 3.0),
    "selu": ((), 3.0), "celu": ((1.3,), 3.0), "gelu": ((True,), 3.0),
    "silu": ((), 3.0), "swish": ((), 3.0), "mish": ((), 3.0),
    "sigmoid": ((), 3.0), "log_sigmoid": ((), 3.0),
    "hardsigmoid": ((0.2, 0.4), 4.0), "hardswish": ((), 5.0),
    "hardtanh": ((-0.5, 0.8), 2.0), "hardshrink": ((0.4,), 2.0),
    "softshrink": ((0.3,), 2.0), "tanhshrink": ((), 3.0),
    "softplus": ((2.0, 5.0), 4.0), "softsign": ((), 3.0),
    "tanh": ((), 3.0), "softmax": ((1,), 3.0), "log_softmax": ((-1,), 3.0),
    "glu": ((1,), 3.0), "thresholded_relu": ((0.7,), 2.0),
}


@pytest.mark.parametrize("name", list(ACTIVATIONS))
def test_activation_functionals_match_jax(name):
    args, scale = ACTIVATIONS[name]
    x = _x(seed=len(name), scale=scale)
    parity(lambda x: getattr(jnf, name)(x, *args),
           lambda x: getattr(tnf, name)(x, *args), [x])


def test_prelu_maxout_and_softmax_dtype_match_jax():
    x = _x((2, 4, 3, 3), 1)
    parity(jnf.prelu, tnf.prelu, [x, np.array([0.25], np.float32)])
    parity(jnf.prelu, tnf.prelu, [x, _x((4,), 2, 1.0)])
    for axis in (1, 3):
        parity(lambda x: jnf.maxout(x, 2, axis),
               lambda x: tnf.maxout(x, 2, axis), [_x((2, 4, 3, 4), 3)])
    got = tnf.softmax(torch.from_numpy(x).bfloat16(), 1, "float32")
    want = jnf.softmax(jnp.asarray(x, jnp.bfloat16), 1, "float32")
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_rrelu_eval_is_the_mean_slope_and_training_draws_slopes():
    x = _x(seed=4)
    parity(lambda x: jnf.rrelu(x, 0.1, 0.3, training=False),
           lambda x: tnf.rrelu(x, 0.1, 0.3, training=False), [x])
    xt = torch.from_numpy(x)
    out = tnf.rrelu(xt, 0.1, 0.3, generator=torch.Generator().manual_seed(0))
    neg = x < 0
    slope = out.numpy()[neg] / x[neg]
    assert slope.min() >= 0.1 and slope.max() < 0.3 and slope.std() > 0.03
    np.testing.assert_array_equal(out.numpy()[~neg], x[~neg])
    again = tnf.rrelu(xt, 0.1, 0.3,
                      generator=torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    with rng.key_scope(torch.Generator().manual_seed(0)):
        assert torch.equal(tnf.rrelu(xt, 0.1, 0.3), out)


def test_gumbel_softmax_properties():
    x = torch.from_numpy(_x((64, 10), 5))
    gen = torch.Generator().manual_seed(1)
    y = tnf.gumbel_softmax(x, 0.5, generator=gen)
    np.testing.assert_allclose(y.sum(-1).numpy(), 1.0, atol=1e-6)
    assert (y > 0).all()
    xr = x.clone().requires_grad_(True)
    yh = tnf.gumbel_softmax(xr, 0.5, hard=True,
                            generator=torch.Generator().manual_seed(1))
    assert torch.equal(yh.detach().argmax(-1), y.argmax(-1))
    assert set(np.unique(yh.detach().numpy())) == {0.0, 1.0}
    # straight-through: the hard sample's gradient is the soft one's
    (yh * torch.arange(10.0)).sum().backward()
    xs = x.clone().requires_grad_(True)
    (tnf.gumbel_softmax(xs, 0.5, generator=torch.Generator().manual_seed(1))
     * torch.arange(10.0)).sum().backward()
    np.testing.assert_allclose(xr.grad.numpy(), xs.grad.numpy(), atol=1e-6)
    # a lower temperature sharpens the same noise
    y2 = tnf.gumbel_softmax(x, 0.1,
                            generator=torch.Generator().manual_seed(1))
    assert float(y2.max(-1).values.mean()) > float(y.max(-1).values.mean())


# layer name -> constructor args (the JAX layer's)
ACT_LAYERS = {
    "ReLU": (), "ReLU6": (), "LeakyReLU": (0.1,), "ELU": (0.5,),
    "CELU": (2.0,), "SELU": (), "GELU": (False,), "Silu": (), "Swish": (),
    "Mish": (), "Sigmoid": (), "LogSigmoid": (), "Hardsigmoid": (),
    "Hardswish": (), "Hardtanh": (-2.0, 2.0), "Hardshrink": (0.6,),
    "Softshrink": (0.2,), "Tanhshrink": (), "Softplus": (1.5, 3.0),
    "Softsign": (), "Tanh": (), "Softmax": (1,), "LogSoftmax": (2,),
    "Maxout": (2,), "GLU": (1,), "ThresholdedReLU": (0.5,), "PReLU": (4,),
}


@pytest.mark.parametrize("name", list(ACT_LAYERS))
def test_activation_layers_match_jax(name):
    args = ACT_LAYERS[name]
    pt.seed(0)
    j = getattr(jnn, name)(*args)
    kw = {"device": "cpu"} if name == "PReLU" else {}
    t = getattr(tact, name)(*args, **kw)
    if name == "PReLU":
        load_jax_state(t, {"weight": np.array([0.1, 0.2, 0.3, 0.4],
                                              np.float32)})
        j.weight.value = jnp.asarray([0.1, 0.2, 0.3, 0.4])
    x = _x((2, 4, 3, 6), 6)
    got = t(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(j(Tensor(jnp.asarray(x))).value),
                               rtol=TOL, atol=TOL)
    assert len(ACT_LAYERS) == 27


def test_prelu_default_and_param_attr():
    pt.seed(0)
    j = jnn.PReLU(3, init=0.1)
    t = tact.PReLU(3, init=0.1, device="cpu")
    np.testing.assert_array_equal(t.weight.detach().numpy(),
                                  jax_state(j)["weight"])
    t = tact.PReLU(3, weight_attr=tinit.ParamAttr(
        initializer=tinit.Constant(0.7)), device="cpu")
    assert (t.weight.detach().numpy() == np.float32(0.7)).all()


# -- flatten and the dropouts ---------------------------------------------------

def test_flatten_matches_jax():
    x = _x((2, 3, 4, 5), 7)
    for start, stop in ((1, -1), (0, 2), (2, 3)):
        got = tcommon.Flatten(start, stop)(torch.from_numpy(x))
        want = jnn.Flatten(start, stop)(Tensor(jnp.asarray(x))).value
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fn,fmt,shape,axes", [
    ("dropout2d", "NCHW", (8, 16, 3, 3), (0, 1)),
    ("dropout2d", "NHWC", (8, 3, 3, 16), (0, 3)),
    ("dropout3d", "NCDHW", (8, 16, 2, 3, 2), (0, 1)),
    ("dropout3d", "NDHWC", (8, 2, 3, 2, 16), (0, 4)),
])
def test_channel_dropouts_drop_whole_channels(fn, fmt, shape, axes):
    x = torch.from_numpy(np.abs(_x(shape, 8)) + 0.5)
    out = getattr(tnf, fn)(x, 0.5, True, fmt,
                           generator=torch.Generator().manual_seed(2))
    kept = out != 0
    other = tuple(d for d in range(len(shape)) if d not in axes)
    per_channel = kept.all(dim=other) | (~kept).all(dim=other)
    assert per_channel.all()
    frac = float(kept.float().mean())
    assert 0.3 < frac < 0.7
    np.testing.assert_allclose(out[kept].numpy(), (x * 2)[kept].numpy(),
                               rtol=1e-6)
    assert torch.equal(getattr(tnf, fn)(x, 0.5, False, fmt), x)
    layer = (tcommon.Dropout2D if fn == "dropout2d" else
             tcommon.Dropout3D)(0.5, fmt)
    layer.eval()
    assert torch.equal(layer(x), x)
    layer.train()
    with rng.key_scope(torch.Generator().manual_seed(2)):
        assert torch.equal(layer(x), out)


def test_alpha_dropout_keeps_the_moments_of_selu_activations():
    x = torch.randn(200000, generator=torch.Generator().manual_seed(3))
    out = tnf.alpha_dropout(x, 0.2, generator=torch.Generator().manual_seed(4))
    assert abs(float(out.mean())) < 0.02
    assert abs(float(out.std()) - 1.0) < 0.02
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    a = 1.0 / math.sqrt(0.8 * (1.0 + 0.2 * alpha_p ** 2))
    dropped = np.isclose(out.numpy(), a * alpha_p - a * alpha_p * 0.2)
    assert 0.18 < dropped.mean() < 0.22
    layer = tcommon.AlphaDropout(0.2)
    layer.eval()
    assert torch.equal(layer(x), x)
    # the JAX layer in eval is the identity too
    jl = jnn.AlphaDropout(0.2)
    jl.eval()
    np.testing.assert_array_equal(
        np.asarray(jl(Tensor(jnp.asarray(x.numpy()))).value), x.numpy())


# -- initializers -----------------------------------------------------------------

def _t(init, shape, seed=0):
    return tinit.draw(init, shape, torch.float32, "cpu",
                      torch.Generator().manual_seed(seed)).numpy()


def _j(init, shape):
    pt.seed(0)
    return np.asarray(init(tuple(shape), jnp.float32))


@pytest.mark.parametrize("name,args,shape", [
    ("Constant", (0.3,), (4, 5)),
    ("Assign", (np.arange(12.0).reshape(3, 4),), (3, 4)),
    ("Dirac", (2,), (6, 3, 3, 3)),
    ("Bilinear", (), (2, 3, 4, 4)),
    ("Bilinear", (), (1, 1, 5, 3)),
])
def test_deterministic_initializers_equal_jax(name, args, shape):
    np.testing.assert_array_equal(_t(getattr(tinit, name)(*args), shape),
                                  _j(getattr(jinit, name)(*args), shape))


def test_bilinear_needs_a_4d_weight():
    with pytest.raises(ValueError, match="4-D"):
        _t(tinit.Bilinear(), (3, 4))


def _moments_ok(w, mean, std):
    n = w.size
    assert abs(w.mean() - mean) <= 5 * std / math.sqrt(n)
    assert abs(w.std() - std) <= 5 * std * math.sqrt(2.0 / n)


@pytest.mark.parametrize("shape", [(300, 400), (64, 32, 3, 3)])
def test_random_initializers_ranges_and_moments(shape):
    fi, fo = tinit._fans(shape)
    assert (fi, fo) == jinit._fans(shape)
    w = _t(tinit.Normal(0.5, 2.0), shape)
    _moments_ok(w, 0.5, 2.0)
    w = _t(tinit.Uniform(-0.2, 0.6), shape)
    assert w.min() >= -0.2 and w.max() < 0.6
    _moments_ok(w, 0.2, 0.8 / math.sqrt(12))
    w = _t(tinit.TruncatedNormal(1.0, 0.5), shape)
    assert w.min() >= 0.0 and w.max() <= 2.0
    # a standard normal cut at +-2 has variance 1 - 4 phi(2) / (2 Phi(2)
    # - 1) = 0.7737
    tstd = 0.5 * math.sqrt(1 - 4 * math.exp(-2) / math.sqrt(2 * math.pi)
                           / math.erf(2 / math.sqrt(2)))
    _moments_ok(w, 1.0, tstd)
    jw = _j(jinit.TruncatedNormal(1.0, 0.5), shape)
    assert abs(jw.std() - tstd) <= 5 * tstd * math.sqrt(2.0 / jw.size)
    limit = math.sqrt(6.0 / (fi + fo))
    w = _t(tinit.XavierUniform(), shape)
    assert np.abs(w).max() <= limit
    _moments_ok(w, 0.0, limit / math.sqrt(3))
    _moments_ok(_t(tinit.XavierNormal(gain=2.0), shape), 0.0,
                2.0 * math.sqrt(2.0 / (fi + fo)))
    gain = math.sqrt(2.0 / (1 + 0.1 ** 2))
    w = _t(tinit.KaimingUniform(negative_slope=0.1,
                                nonlinearity="leaky_relu"), shape)
    assert np.abs(w).max() <= gain * math.sqrt(3.0 / fi)
    _moments_ok(w, 0.0, gain / math.sqrt(fi))
    _moments_ok(_t(tinit.KaimingNormal(fan_in=50), shape), 0.0,
                math.sqrt(2.0) / math.sqrt(50))


@pytest.mark.parametrize("shape", [(6, 10), (10, 6), (4, 3, 5)])
def test_orthogonal(shape):
    q = _t(tinit.Orthogonal(1.5), shape).reshape(-1, shape[-1])
    gram = q.T @ q if q.shape[0] >= q.shape[1] else q @ q.T
    np.testing.assert_allclose(gram, 2.25 * np.eye(min(q.shape)),
                               atol=1e-5)
    j = _j(jinit.Orthogonal(1.5), shape)
    assert j.shape == tuple(shape)
    assert _t(tinit.Orthogonal(), (5,)).shape == (5, 5)
    assert _j(jinit.Orthogonal(), (5,)).shape == (5, 5)


def test_get_initializer_specs():
    assert isinstance(tinit.get_initializer("zeros"), tinit.Constant)
    assert tinit.get_initializer("ones").value == 1.0
    assert tinit.get_initializer(2).value == 2.0
    assert isinstance(tinit.get_initializer("bilinear"), tinit.Bilinear)
    for name in jinit._REGISTRY:
        assert type(tinit.get_initializer(name)).__name__ == \
            type(jinit.get_initializer(name)).__name__
    with pytest.raises(ValueError):
        tinit.get_initializer("nope")
    fn = tinit.get_initializer(lambda s, d: np.full(s, 3.0))
    np.testing.assert_array_equal(_t(fn, (2, 2)), np.full((2, 2), 3.0))


def _linear_pair(w_attr=None, b_attr=None):
    pt.seed(0)
    j = jnn.Linear(6, 4, *(_jattr(a) for a in (w_attr, b_attr)))
    t = tcommon.Linear(6, 4, *(_tattr(a) for a in (w_attr, b_attr)),
                       device="cpu")
    return j, t


def _jattr(spec):
    if spec is None:
        return None
    return jnn.ParamAttr(initializer=getattr(jinit, spec[0])(*spec[1:]))


def _tattr(spec):
    if spec is None:
        return None
    return tinit.ParamAttr(initializer=getattr(tinit, spec[0])(*spec[1:]))


def test_param_attr_precedence_matches_jax(_global_init_reset):
    """``attr.initializer`` beats the layer's own initializer, which beats
    the global one, which beats the default; an attribute object with no
    initializer takes whatever comes next, in both packages."""
    # the attribute's initializer over Conv2D's own KaimingUniform
    pt.seed(0)
    j = jnn.Conv2D(2, 3, 3, weight_attr=_jattr(("Constant", 0.5)))
    t = tconv.Conv2D(2, 3, 3, weight_attr=_tattr(("Constant", 0.5)),
                     device="cpu")
    np.testing.assert_array_equal(t.weight.detach().numpy(),
                                  jax_state(j)["weight"])
    # the global initializer: taken by Linear (no initializer of its
    # own) and by the batch norms' bias, not by Conv2D's weight
    tinit.set_global_initializer(tinit.Constant(0.25), tinit.Constant(-1))
    jinit.set_global_initializer(jinit.Constant(0.25), jinit.Constant(-1))
    j, t = _linear_pair()
    for k, v in jax_state(j).items():
        np.testing.assert_array_equal(t.state_dict()[k].numpy(), v)
    assert float(t.bias.detach()[0]) == -1.0
    pt.seed(0)
    jb, tb = jnn.BatchNorm2D(3), tnorm.BatchNorm2D(3, device="cpu")
    for k, v in jax_state(jb).items():
        np.testing.assert_array_equal(tb.state_dict()[k].numpy(), v)
    conv = tconv.Conv2D(2, 3, 3, device="cpu")
    assert float(conv.weight.detach().abs().max()) != 0.25
    # an attribute over the global one; an attribute object without an
    # initializer falls through to the global one
    j, t = _linear_pair(("Constant", 0.75), None)
    np.testing.assert_array_equal(t.weight.detach().numpy(),
                                  jax_state(j)["weight"])
    t = tcommon.Linear(6, 4, weight_attr=object(), device="cpu")
    assert (t.weight.detach().numpy() == 0.25).all()
    tinit.set_global_initializer(None)
    jinit.set_global_initializer(None)
    # no global one: the default (xavier_uniform, zero bias)
    t = tcommon.Linear(6, 4, weight_attr=tinit.ParamAttr(name="w"),
                       bias_attr=object(), device="cpu")
    assert np.abs(t.weight.detach().numpy()).max() <= math.sqrt(6 / 10)
    assert not t.bias.detach().numpy().any()
    assert t.weight.param_name == "w"
    # Embedding: its normal(0, 1) default only without an attribute, as
    # in the JAX layer
    e = tcommon.Embedding(300, 400, device="cpu")
    assert float(e.weight.detach().std()) > 0.9
    e = tcommon.Embedding(300, 400, weight_attr=tinit.ParamAttr(),
                          device="cpu")
    assert float(e.weight.detach().abs().max()) <= math.sqrt(6 / 700)


def test_trainable_false_is_skipped_by_the_optimizer_as_in_jax():
    x = _x((5, 6), 9)
    pt.seed(0)
    j = jnn.Linear(6, 4, weight_attr=jnn.ParamAttr(trainable=False))
    t = tcommon.Linear(6, 4, weight_attr=tinit.ParamAttr(trainable=False),
                       device="cpu")
    load_jax_state(t, jax_state(j))
    assert not t.weight.requires_grad and t.bias.requires_grad
    jo = jopt.Momentum(0.1, parameters=j.parameters())
    loss = (j(Tensor(jnp.asarray(x))) ** 2).sum()
    loss.backward()
    jo.step()
    to = Momentum(0.1, parameters=t.named_parameters())
    (t(torch.from_numpy(x)) ** 2).sum().backward()
    to.step()
    want = jax_state(j)
    for k, v in t.state_dict().items():
        np.testing.assert_allclose(v.detach().numpy(), want[k], atol=1e-6)
    pt.seed(0)
    np.testing.assert_array_equal(want["weight"],
                                  jax_state(jnn.Linear(6, 4))["weight"])
    assert "weight" not in to._state and "bias" in to._state
