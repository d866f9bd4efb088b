"""Eager autograd of the port against the JAX package: the scenarios of
``tests/test_autograd.py`` (the tape: chains, accumulation,
``stop_gradient``, ``no_grad``, ``detach``, ``retain_graph``, ``grad``,
hooks, ``retain_grads``, multi-output ops, getitem, branching, seeds, a
deep chain), ``tests/test_double_grad.py`` (``create_graph``: second
and third order, matmul, conv2d, batch norm, WGAN-GP, ``no_grad_vars``,
``PyLayer`` double grad, the second-order op sweep) and
``tests/test_ops_math.py`` (forward against numpy, gradients against
``jax.grad`` of the JAX kernel), each run against both packages as a
``[jax]`` / ``[port]`` case of one test.

Tolerances are the JAX tests' own: 1e-5 for second order (1e-4 for
matmul, 1e-3 for conv2d and batch norm), rtol 2e-4 / atol 2e-5 for the
op sweep, 1e-4 / 1e-5 for ``check_grad``.
"""

import _torch_threads  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from paddle_tpu.ops.registry import get_op as jax_op
from paddle_tpu_torch.core import place


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    place.set_device("cpu")
    yield
    place.reset_device()


@pytest.fixture(params=["jax", "port"])
def P(request):
    return pt if request.param == "jax" else paddle


def _np(t):
    return np.asarray(t.numpy())


def _allclose(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


# -- tests/test_autograd.py ---------------------------------------------------

def test_backward_chain(P):
    x = P.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
    w = ((x * 2.0 + 1.0) * (x * 2.0 + 1.0)).sum()
    w.backward()
    np.testing.assert_allclose(_np(x.grad), 4 * (2 * np.array(
        [1.0, 2.0, 3.0]) + 1))


def test_grad_accumulation(P):
    x = P.to_tensor([1.0, 2.0], stop_gradient=False)
    (x * 2).sum().backward()
    (x * 3).sum().backward()
    np.testing.assert_allclose(_np(x.grad), [5.0, 5.0])
    x.clear_grad()
    assert x.grad is None


def test_stop_gradient_prunes(P):
    x = P.to_tensor([1.0], stop_gradient=False)
    y = P.to_tensor([2.0], stop_gradient=True)
    (x * y).sum().backward()
    assert x.grad is not None
    assert y.grad is None


def test_no_grad_context_and_decorator(P):
    x = P.to_tensor([1.0], stop_gradient=False)
    with P.no_grad():
        y = x * 2
    assert y.grad_node is None
    assert y.stop_gradient

    @P.no_grad()
    def f(v):
        return v * 3

    @P.no_grad
    def gen(v):
        yield v * 4

    assert f(x).stop_gradient
    assert next(gen(x)).stop_gradient
    assert (x * 5).stop_gradient is False


def test_detach(P):
    x = P.to_tensor([3.0], stop_gradient=False)
    d = (x * 2).detach()
    assert d.stop_gradient
    (d * x).sum().backward()
    np.testing.assert_allclose(_np(x.grad), [6.0])


def test_retain_graph(P):
    x = P.to_tensor([1.0, 2.0], stop_gradient=False)
    y = (x * x).sum()
    y.backward(retain_graph=True)
    y.backward()
    np.testing.assert_allclose(_np(x.grad), [4.0, 8.0])


def test_double_backward_raises(P):
    x = P.to_tensor([1.0], stop_gradient=False)
    y = (x * x).sum()
    y.backward()
    with pytest.raises(RuntimeError):
        y.backward()


def test_grad_api(P):
    x = P.to_tensor([1.0, 2.0], stop_gradient=False)
    (gx,) = P.grad((x ** 3).sum(), [x])
    np.testing.assert_allclose(_np(gx), 3 * np.array([1.0, 2.0]) ** 2,
                               rtol=1e-6)
    assert x.grad is None


def test_grad_api_unused(P):
    x = P.to_tensor([1.0], stop_gradient=False)
    u = P.to_tensor([1.0], stop_gradient=False)
    with pytest.raises(RuntimeError):
        P.grad((x * 2).sum(), [u])
    (g,) = P.grad((x * 2).sum(), [u], allow_unused=True)
    assert g is None


def test_hooks(P):
    x = P.to_tensor([1.0, 1.0], stop_gradient=False)
    seen = {}

    def hook(g):
        seen["g"] = np.asarray(g)
        return g * 10

    x.register_hook(hook)
    (x * 2).sum().backward()
    np.testing.assert_allclose(seen["g"], [2.0, 2.0])
    np.testing.assert_allclose(_np(x.grad), [20.0, 20.0])


def test_retain_grads_intermediate(P):
    x = P.to_tensor([2.0], stop_gradient=False)
    y = x * 3
    y.retain_grads()
    (y * y).sum().backward()
    np.testing.assert_allclose(_np(y.grad), [12.0])


def test_multi_output_op_grad(P):
    x = P.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3),
                    stop_gradient=False)
    vals, idx = P.topk(x, 2)
    vals.sum().backward()
    expect = np.zeros((2, 3), np.float32)
    expect[:, 1:] = 1
    np.testing.assert_allclose(_np(x.grad), expect)


def test_backward_through_getitem(P):
    x = P.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
    x[1:].sum().backward()
    np.testing.assert_allclose(_np(x.grad), [0.0, 1.0, 1.0])


def test_branching_graph(P):
    x = P.to_tensor([1.0], stop_gradient=False)
    (x * 2 + x * 3).sum().backward()
    np.testing.assert_allclose(_np(x.grad), [5.0])


def test_nonscalar_backward_seed(P):
    x = P.to_tensor([1.0, 2.0], stop_gradient=False)
    (x * 2).backward(P.to_tensor([1.0, 0.5]))
    np.testing.assert_allclose(_np(x.grad), [2.0, 1.0])


def test_deep_chain_no_recursion(P):
    x = P.to_tensor([1.0], stop_gradient=False)
    y = x
    for _ in range(300):
        y = y + 0.001
    y.sum().backward()
    np.testing.assert_allclose(_np(x.grad), [1.0])


# -- tests/test_double_grad.py ------------------------------------------------

def test_second_order_elementwise(P):
    xv = np.array([0.5, -1.2, 2.0], np.float32)
    x = P.to_tensor(xv, stop_gradient=False)
    (g,) = P.grad((x ** 3).sum(), [x], create_graph=True)
    assert not g.stop_gradient
    (gg,) = P.grad((g * g).sum(), [x])
    f = lambda v: jnp.sum(v ** 3)  # noqa: E731
    ref = jax.grad(lambda v: jnp.sum(jax.grad(f)(v) ** 2))(xv)
    _allclose(_np(g), 3 * xv ** 2)
    _allclose(_np(gg), ref)


def test_second_order_matmul(P):
    rng = np.random.default_rng(0)
    av = rng.standard_normal((3, 4)).astype(np.float32)
    bv = rng.standard_normal((4, 2)).astype(np.float32)
    a = P.to_tensor(av, stop_gradient=False)
    b = P.to_tensor(bv, stop_gradient=False)
    ga, gb = P.grad(P.tanh(P.matmul(a, b)).sum(), [a, b], create_graph=True)
    gga, ggb = P.grad((ga * ga).sum() + (gb * gb).sum(), [a, b])
    f = lambda A, B: jnp.sum(jnp.tanh(A @ B))  # noqa: E731

    def second(A, B):
        gA, gB = jax.grad(f, argnums=(0, 1))(A, B)
        return jnp.sum(gA ** 2) + jnp.sum(gB ** 2)
    ref_a, ref_b = jax.grad(second, argnums=(0, 1))(av, bv)
    _allclose(_np(gga), ref_a, 1e-4)
    _allclose(_np(ggb), ref_b, 1e-4)


def test_second_order_conv2d(P):
    rng = np.random.default_rng(1)
    xv = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    wv = (rng.standard_normal((4, 3, 3, 3)) * 0.1).astype(np.float32)
    x = P.to_tensor(xv, stop_gradient=False)
    w = P.to_tensor(wv, stop_gradient=False)
    y = (P.nn.functional.conv2d(x, w, padding=1) ** 2).sum()
    (gx,) = P.grad(y, [x], create_graph=True)
    (ggw,) = P.grad((gx * gx).sum(), [w])
    import paddle_tpu.ops.nn_functional as F
    conv = lambda X, W: jnp.sum(F.conv2d(X, W, padding=1) ** 2)  # noqa

    def second(X, W):
        return jnp.sum(jax.grad(conv, argnums=0)(X, W) ** 2)
    _allclose(_np(ggw), jax.grad(second, argnums=1)(xv, wv), 1e-3)


def test_second_order_batch_norm(P):
    rng = np.random.default_rng(2)
    xv = rng.standard_normal((4, 3, 5, 5)).astype(np.float32)
    x = P.to_tensor(xv, stop_gradient=False)
    bn = P.nn.BatchNorm2D(3)
    bn.train()
    (gx,) = P.grad((bn(x) ** 3).sum(), [x], create_graph=True)
    (ggx,) = P.grad((gx * gx).sum(), [x])

    def bn_ref(X):
        mean = X.mean(axis=(0, 2, 3), keepdims=True)
        var = X.var(axis=(0, 2, 3), keepdims=True)
        return jnp.sum(((X - mean) / jnp.sqrt(var + 1e-5)) ** 3)

    def second(X):
        return jnp.sum(jax.grad(bn_ref)(X) ** 2)
    _allclose(_np(ggx), jax.grad(second)(xv), 1e-3)


def _wgan_inputs(shape_in, width, batch, seed):
    rng = np.random.default_rng(seed)
    w1 = (rng.standard_normal((shape_in, width)) * 0.3 /
          np.sqrt(shape_in / 6)).astype(np.float32)
    w2 = (rng.standard_normal((width, 1)) * 0.3 /
          np.sqrt(width / 16)).astype(np.float32)
    real = rng.standard_normal((batch, shape_in)).astype(np.float32)
    fake = rng.standard_normal((batch, shape_in)).astype(np.float32)
    eps = rng.uniform(size=(batch, 1)).astype(np.float32)
    return w1, w2, real, fake, eps


def wgan_gp_grads(P, w1v, w2v, realv, fakev, epsv):
    """The WGAN-GP gradient penalty's gradients with respect to the two
    weights of a tanh MLP discriminator, through ``create_graph``."""
    w1 = P.to_tensor(w1v, stop_gradient=False)
    w2 = P.to_tensor(w2v, stop_gradient=False)
    x_interp = P.to_tensor(epsv) * P.to_tensor(realv) + \
        (1.0 - P.to_tensor(epsv)) * P.to_tensor(fakev)
    x_interp.stop_gradient = False
    d_out = P.matmul(P.tanh(P.matmul(x_interp, w1)), w2)
    (gx,) = P.grad(d_out.sum(), [x_interp], create_graph=True)
    grad_norm = P.sqrt((gx * gx).sum(axis=1) + 1e-12)
    gp = ((grad_norm - 1.0) ** 2).mean()
    return P.grad(gp, [w1, w2])


def wgan_gp_reference(w1v, w2v, realv, fakev, epsv):
    def jref(a, b):
        xi = epsv * realv + (1 - epsv) * fakev
        gX = jax.grad(lambda X: jnp.sum(jnp.tanh(X @ a) @ b))(xi)
        gn = jnp.sqrt(jnp.sum(gX ** 2, axis=1) + 1e-12)
        return jnp.mean((gn - 1.0) ** 2)
    return jax.grad(jref, argnums=(0, 1))(w1v, w2v)


def test_wgan_gp_gradient_penalty(P):
    args = _wgan_inputs(6, 16, 4, 3)
    gw1, gw2 = wgan_gp_grads(P, *args)
    ref1, ref2 = wgan_gp_reference(*args)
    _allclose(_np(gw1), ref1, 1e-5)
    _allclose(_np(gw2), ref2, 1e-5)


def test_third_order(P):
    xv = np.array([0.7, 1.3], np.float32)
    x = P.to_tensor(xv, stop_gradient=False)
    (g1,) = P.grad((x ** 4).sum(), [x], create_graph=True)
    (g2,) = P.grad(g1.sum(), [x], create_graph=True)
    (g3,) = P.grad(g2.sum(), [x])
    _allclose(_np(g3), 24 * xv)


def test_branching_accumulation_taped(P):
    xv = np.array([0.4, -0.9], np.float32)
    x = P.to_tensor(xv, stop_gradient=False)
    a = x * x
    y = (a * x).sum() + (a * 2.0).sum()
    (g,) = P.grad(y, [x], create_graph=True)
    (gg,) = P.grad(g.sum(), [x])
    _allclose(_np(g), 3 * xv ** 2 + 4 * xv)
    _allclose(_np(gg), 6 * xv + 4)


def test_create_graph_false_not_taped(P):
    x = P.to_tensor([1.0, 2.0], stop_gradient=False)
    (g,) = P.grad((x * x).sum(), [x])
    assert g.stop_gradient
    with pytest.raises(RuntimeError):
        P.grad(g.sum(), [x])


def test_grad_outputs_tensor_seed_taped(P):
    xv = np.array([1.5, -0.5], np.float32)
    sv = np.array([2.0, 3.0], np.float32)
    x = P.to_tensor(xv, stop_gradient=False)
    (g,) = P.grad(x ** 2, [x], grad_outputs=[P.to_tensor(sv)],
                  create_graph=True)
    (gg,) = P.grad(g.sum(), [x])
    _allclose(_np(g), 2 * xv * sv)
    _allclose(_np(gg), 2 * sv)


def test_no_grad_vars_overlap_restores_flag(P):
    xv = np.array([1.0, 2.0], np.float32)
    x = P.to_tensor(xv, stop_gradient=False)
    w = P.to_tensor(xv.copy(), stop_gradient=True)
    P.grad((x * w).sum(), [x, w], no_grad_vars=[w], allow_unused=True)
    assert w.stop_gradient
    assert not x.stop_gradient


def test_create_graph_inside_no_grad(P):
    xv = np.array([0.5, 1.5], np.float32)
    x = P.to_tensor(xv, stop_gradient=False)
    y = (x ** 3).sum()
    with P.no_grad():
        (g,) = P.grad(y, [x], create_graph=True)
    assert not g.stop_gradient
    (gg,) = P.grad(g.sum(), [x])
    _allclose(_np(gg), 6 * xv)


def test_no_grad_vars(P):
    xv = np.array([1.0, 2.0], np.float32)
    x = P.to_tensor(xv, stop_gradient=False)
    y = P.to_tensor(xv.copy(), stop_gradient=False)
    (g,) = P.grad((x * y).sum(), [x], no_grad_vars=[y], allow_unused=True)
    _allclose(_np(g), xv)
    assert not y.stop_gradient


def _cube(P):
    class Cube(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x * x

        @staticmethod
        def backward(ctx, gy):
            (x,) = ctx.saved_tensor()
            return gy * 3.0 * x * x
    return Cube


def test_pylayer_double_grad(P):
    xv = np.array([0.8, -1.1], np.float32)
    x = P.to_tensor(xv, stop_gradient=False)
    (g,) = P.grad(_cube(P).apply(x).sum(), [x], create_graph=True)
    (gg,) = P.grad(g.sum(), [x])
    _allclose(_np(g), 3 * xv ** 2)
    _allclose(_np(gg), 6 * xv)


def test_pylayer_matches_the_builtin_op_gradient(P):
    """A user PyLayer (tanh with a hand-written backward, a constant
    second input and a tuple output) against the built-in op."""
    class Tanh2(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, scale):
            y = P.tanh(x) * scale
            ctx.save_for_backward(y)
            return y, y * 2.0

        @staticmethod
        def backward(ctx, gy, gz):
            (y,) = ctx.saved_tensor()
            return (gy + 2.0 * gz) * (1.0 - y * y)

    xv = np.random.default_rng(5).standard_normal(6).astype(np.float32)
    x1 = P.to_tensor(xv, stop_gradient=False)
    a, b = Tanh2.apply(x1, 1.0)
    (a.sum() + b.sum()).backward()
    x2 = P.to_tensor(xv, stop_gradient=False)
    (P.tanh(x2) * 3.0).sum().backward()
    _allclose(_np(x1.grad), _np(x2.grad), 1e-6)
    with P.no_grad():
        c, _ = Tanh2.apply(x1, 1.0)
    assert c.stop_gradient


@pytest.mark.parametrize("name", [
    "multiply", "tanh", "sigmoid", "exp", "log", "sqrt", "square",
    "sin", "cos", "softmax", "gelu", "silu", "log_softmax", "rsqrt",
    "softplus",
])
def test_second_order_op_sweep(P, name):
    import zlib
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    xv = rng.uniform(0.2, 1.5, (3, 4)).astype(np.float32)
    wv = rng.standard_normal((3, 4)).astype(np.float32)
    op = getattr(P, name, None) or getattr(P.nn.functional, name)
    x = P.to_tensor(xv, stop_gradient=False)
    w = P.to_tensor(wv)
    y = ((op(x, x) if name == "multiply" else op(x)) * w).sum()
    (g,) = P.grad(y, [x], create_graph=True)
    (gg,) = P.grad((g * g).sum(), [x])
    raw = jax_op(name).fn

    def f(v):
        out = raw(v, v) if name == "multiply" else raw(v)
        return jnp.sum(out * wv)
    ref = jax.grad(lambda v: jnp.sum(jax.grad(f)(v) ** 2))(xv)
    np.testing.assert_allclose(_np(gg), ref, rtol=2e-4, atol=2e-5,
                               err_msg=name)


# -- tests/test_ops_math.py ---------------------------------------------------

RNG = np.random.default_rng(42)


def _f32(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


def check_forward(P, name, ref, *args, rtol=1e-5, atol=1e-6, **kwargs):
    fn = getattr(P, name, None) or getattr(P.nn.functional, name)
    targs = [P.to_tensor(a) if isinstance(a, np.ndarray) else a
             for a in args]
    out = fn(*targs, **kwargs)
    np.testing.assert_allclose(_np(out), np.asarray(ref(*args, **kwargs)),
                               rtol=rtol, atol=atol, err_msg=name)


def check_grad(P, name, *args, arg_idx=(0,), rtol=1e-4, atol=1e-5,
               **kwargs):
    """The package's gradient of ``sum(out)`` against ``jax.grad`` of
    the JAX kernel."""
    fn = getattr(P, name, None) or getattr(P.nn.functional, name)
    targs = [P.to_tensor(a, stop_gradient=i not in arg_idx)
             if isinstance(a, np.ndarray) else a for i, a in enumerate(args)]
    out = fn(*targs, **kwargs)
    (out.sum() if out.shape else out).backward()
    raw = jax_op(name).fn

    def f(*dv):
        full = list(args)
        for i, v in zip(arg_idx, dv):
            full[i] = v
        return jnp.sum(raw(*full, **kwargs))
    want = jax.grad(f, argnums=tuple(range(len(arg_idx))))(
        *[jnp.asarray(args[i]) for i in arg_idx])
    for i, w in zip(arg_idx, want):
        np.testing.assert_allclose(_np(targs[i].grad), np.asarray(w),
                                   rtol=rtol, atol=atol, err_msg=name)


BINARY = [("add", np.add), ("subtract", np.subtract),
          ("multiply", np.multiply), ("maximum", np.maximum),
          ("minimum", np.minimum), ("atan2", np.arctan2),
          ("logaddexp", np.logaddexp), ("fmax", np.fmax),
          ("fmin", np.fmin)]


@pytest.mark.parametrize("name,ref", BINARY, ids=[c[0] for c in BINARY])
def test_binary_elementwise(P, name, ref):
    x, y = _f32(3, 4), _f32(3, 4)
    check_forward(P, name, ref, x, y)
    check_grad(P, name, x, y, arg_idx=(0, 1))


def test_divide_and_broadcasting(P):
    x, y = _f32(3, 4), np.abs(_f32(3, 4)) + 0.5
    check_forward(P, "divide", np.divide, x, y)
    check_grad(P, "divide", x, y, arg_idx=(0, 1))
    a, b = _f32(3, 1, 4), _f32(2, 1)
    check_forward(P, "add", np.add, a, b)
    check_grad(P, "multiply", a, b, arg_idx=(0, 1))


UNARY = ["exp", "log", "sqrt", "abs", "neg", "sin", "cos", "tanh", "floor",
         "ceil", "square", "sigmoid", "expm1", "log1p", "sinh", "cosh",
         "asinh", "atan", "erf", "trunc", "sign", "rsqrt", "reciprocal"]


@pytest.mark.parametrize("name", UNARY)
def test_unary(P, name):
    from scipy.special import erf as sp_erf
    refs = {"log": np.log, "sqrt": np.sqrt, "log1p": np.log1p,
            "rsqrt": lambda v: 1.0 / np.sqrt(v),
            "reciprocal": lambda v: 1.0 / v,
            "sigmoid": lambda v: 1.0 / (1.0 + np.exp(-v)), "erf": sp_erf,
            "neg": np.negative, "asinh": np.arcsinh, "atan": np.arctan}
    x = np.abs(_f32(3, 4)) + 0.1 if name in (
        "log", "sqrt", "log1p", "rsqrt", "reciprocal") else _f32(3, 4)
    ref = refs.get(name) or getattr(np, name)
    check_forward(P, name, ref, x, rtol=1e-4, atol=1e-5)
    if name not in ("floor", "ceil", "trunc", "sign", "abs"):
        check_grad(P, name, x)


@pytest.mark.parametrize("name", ["sum", "mean", "max", "min", "prod"])
@pytest.mark.parametrize("axis,keepdim", [(None, False), (0, False),
                                          (1, True), ((0, 2), False)])
def test_reduce(P, name, axis, keepdim):
    x = _f32(2, 3, 4)
    ref = getattr(np, name)
    check_forward(P, name, lambda v, axis=None, keepdim=False:
                  ref(v, axis=axis, keepdims=keepdim), x, axis=axis,
                  keepdim=keepdim, rtol=1e-4)
    check_grad(P, name, x, axis=axis, keepdim=keepdim)


def test_std_var_median_logsumexp_cumulative(P):
    from scipy.special import logsumexp as sp_lse
    x = _f32(4, 5)
    check_forward(P, "std", lambda v: np.std(v, ddof=1), x, rtol=1e-4)
    check_forward(P, "var", lambda v: np.var(v, ddof=1), x, rtol=1e-4)
    check_forward(P, "median", np.median, x)
    check_forward(P, "logsumexp", lambda v, axis=None: sp_lse(v, axis=axis),
                  x, axis=1)
    check_grad(P, "logsumexp", x, axis=1)
    check_forward(P, "cumsum", lambda v, axis=None: np.cumsum(v, axis=axis),
                  x, axis=1)
    check_grad(P, "cumsum", x, axis=1)
    check_forward(P, "cumprod", lambda v, dim=None: np.cumprod(v, axis=dim),
                  x, dim=1, rtol=1e-4)


def test_matmul_comparisons_logical(P):
    x, y = _f32(3, 4), _f32(4, 5)
    check_forward(P, "matmul", lambda a, b: a @ b, x, y, rtol=1e-4)
    check_grad(P, "matmul", x, y, arg_idx=(0, 1))
    a, b = _f32(2, 3, 4), _f32(2, 5, 4)
    check_forward(P, "matmul", lambda u, v, transpose_y=False:
                  u @ v.swapaxes(-1, -2), a, b, transpose_y=True, rtol=1e-4)
    u, v = _f32(3, 4), _f32(3, 4)
    check_forward(P, "equal", np.equal, u, u)
    check_forward(P, "greater_than", np.greater, u, v)
    check_forward(P, "less_equal", np.less_equal, u, v)
    p = u > 0
    q = v > 0
    check_forward(P, "logical_and", np.logical_and, p, q)
    check_forward(P, "logical_not", np.logical_not, p)


def test_clip_scale_pow_trace_isnan(P):
    x = _f32(3, 4)
    check_forward(P, "clip", lambda v, min=None, max=None:
                  np.clip(v, min, max), x, min=-0.5, max=0.5)
    check_grad(P, "clip", x, min=-0.5, max=0.5)
    check_forward(P, "scale", lambda v, scale=1.0, bias=0.0:
                  v * scale + bias, x, scale=2.0, bias=1.0)
    p = np.abs(_f32(3, 4)) + 0.5
    check_forward(P, "pow", np.power, p, 2.0)
    check_grad(P, "pow", p, 2.0)
    m = _f32(4, 4)
    for name, ref in (("trace", np.trace), ("diag", np.diag),
                      ("tril", np.tril), ("triu", np.triu)):
        check_forward(P, name, ref, m)
    z = np.array([1.0, np.nan, np.inf, -np.inf], dtype=np.float32)
    for name in ("isnan", "isinf", "isfinite"):
        check_forward(P, name, getattr(np, name), z)
    check_forward(P, "nan_to_num", lambda v: np.nan_to_num(v), z, rtol=0,
                  atol=0)
