"""``ops/control_flow.py`` of the port against the JAX package:
``cond``, ``while_loop``, ``fori_loop``, ``scan``, ``case``,
``switch_case``, ``TensorArray`` with the array functions, and
``Assert``.

Eager calls keep Python semantics, and their results equal the JAX
package's eager results on the same inputs (exact: the tests' arithmetic
is exact in float32). Under ``torch.export`` a tensor predicate or a
tensor loop bound lowers through ``jit/convert_ops.py`` (``torch.cond``,
``while_loop``): the exported program holds the higher-order op, and its
results on inputs other than the tracing ones equal JAX's ``jax.jit`` of
the JAX functions. A capacity ``TensorArray`` is a stacked buffer in both
packages, also inside an exported program.
"""

import _torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from _torch_eager_parity import on_cpu
from paddle_tpu.ops import control_flow as JC
from paddle_tpu_torch.ops import control_flow as TC

_cpu = pytest.fixture(autouse=True, scope="module")(on_cpu)


def _n(t):
    return np.asarray(t.numpy())


def test_cond_and_while_loop_eager_match_jax():
    for flag in (True, False):
        j = JC.cond(pt.to_tensor(flag), lambda v: v * 2, lambda v: v * 10,
                    pt.to_tensor([3.0]))
        t = TC.cond(paddle.to_tensor(flag), lambda v: v * 2,
                    lambda v: v * 10, paddle.to_tensor([3.0]))
        np.testing.assert_array_equal(_n(t), _n(j))
    j = JC.while_loop(lambda i, a: i < 5, lambda i, a: (i + 1, a + 2.0),
                      (pt.to_tensor(0), pt.to_tensor(0.0)))
    t = TC.while_loop(lambda i, a: i < 5, lambda i, a: (i + 1, a + 2.0),
                      (paddle.to_tensor(0), paddle.to_tensor(0.0)))
    assert isinstance(t, type(j)) and isinstance(t[0], paddle.Tensor)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(_n(a), _n(b))


def test_fori_scan_case_switch_case_eager_match_jax():
    j = JC.fori_loop(1, 5, lambda i, v: v * 2.0 + i, pt.to_tensor(1.0))
    t = TC.fori_loop(1, 5, lambda i, v: v * 2.0 + i, paddle.to_tensor(1.0))
    np.testing.assert_array_equal(_n(t), _n(j))
    xs = np.arange(5, dtype=np.float32)
    for rev in (False, True):
        jc, jy = JC.scan(lambda c, x: (c + x, c * x), pt.to_tensor(1.0),
                         pt.to_tensor(xs), reverse=rev)
        tc, ty = TC.scan(lambda c, x: (c + x, c * x), paddle.to_tensor(1.0),
                         paddle.to_tensor(xs), reverse=rev)
        np.testing.assert_array_equal(_n(tc), _n(jc))
        np.testing.assert_array_equal(_n(ty), _n(jy))
    for x in (-1.0, 0.5, 3.0):
        def pairs(pkg):
            v = pkg.to_tensor(x)
            return [(v < 0, lambda: pkg.to_tensor(-1.0)),
                    (v < 1, lambda: pkg.to_tensor(0.0))]
        j = JC.case(pairs(pt), default=lambda: pt.to_tensor(9.0))
        t = TC.case(pairs(paddle), default=lambda: paddle.to_tensor(9.0))
        np.testing.assert_array_equal(_n(t), _n(j))
        j = JC.case(pairs(pt))
        t = TC.case(pairs(paddle))
        np.testing.assert_array_equal(_n(t), _n(j))
    for k in (0, 2, 5, 7):
        fns = {0: lambda: 10.0, 5: lambda: 50.0, 2: lambda: 20.0}
        j = JC.switch_case(pt.to_tensor(k), {a: (lambda f=f: pt.to_tensor(
            f())) for a, f in fns.items()})
        t = TC.switch_case(paddle.to_tensor(k), {a: (
            lambda f=f: paddle.to_tensor(f())) for a, f in fns.items()},
            default=None)
        np.testing.assert_array_equal(_n(t), _n(j))
        lst = [lambda: 1.0, lambda: 2.0]
        j = JC.switch_case(pt.to_tensor(k), [lambda f=f: pt.to_tensor(f())
                                             for f in lst],
                           default=lambda: pt.to_tensor(-1.0))
        t = TC.switch_case(paddle.to_tensor(k),
                           [lambda f=f: paddle.to_tensor(f()) for f in lst],
                           default=lambda: paddle.to_tensor(-1.0))
        np.testing.assert_array_equal(_n(t), _n(j))


def test_tensor_array_eager_matches_jax():
    def build(pkg, cf):
        arr = cf.create_array("float32")
        for i, v in enumerate((1.0, 2.0, 3.0)):
            cf.array_write(pkg.to_tensor([v, v * 2]), i, arr)
        cf.array_write(pkg.to_tensor([7.0, 8.0]), 1, arr)
        out, sizes = cf.tensor_array_to_tensor(arr, axis=0)
        st, _ = cf.tensor_array_to_tensor(arr, axis=1, use_stack=True)
        return [cf.array_read(arr, 1), cf.array_length(arr), out, sizes, st]
    for a, b in zip(build(paddle, TC), build(pt, JC)):
        np.testing.assert_array_equal(_n(a), _n(b))
    assert paddle.TensorArray is TC.TensorArray
    arr = TC.create_array()
    TC.array_write(paddle.to_tensor([1.0]), 2, arr)
    with pytest.raises(ValueError, match="uninitialized"):
        TC.tensor_array_to_tensor(arr)
    rag = TC.array_to_lod_tensor(TC.lod_tensor_to_array(
        paddle.to_tensor(np.arange(6, dtype=np.float32).reshape(3, 2))))
    np.testing.assert_array_equal(rag.row_splits, [0, 2, 4, 6])


def test_traced_tensor_array_matches_jax():
    ex = np.zeros(2, np.float32)
    jt = JC.TensorArray(capacity=4, example=pt.to_tensor(ex))
    tt = TC.TensorArray(capacity=4, example=torch.zeros(2))
    for i in (0, 2):
        jt = JC.array_write(pt.to_tensor([i + 1.0, 5.0]), pt.to_tensor(i),
                            jt)
        tt = TC.array_write(torch.tensor([i + 1.0, 5.0]), torch.tensor(i),
                            tt)
    assert len(tt) == len(jt) == 3
    for a, b in zip(TC.tensor_array_to_tensor(tt),
                    JC.tensor_array_to_tensor(jt)):
        np.testing.assert_array_equal(_n(a), _n(b))
    np.testing.assert_array_equal(_n(TC.array_read(tt, 2)),
                                  _n(JC.array_read(jt, 2)))


def test_assert_raises_eagerly():
    TC.Assert(paddle.to_tensor([True, True]))
    with pytest.raises(AssertionError, match="data"):
        TC.Assert(paddle.to_tensor(False), [paddle.to_tensor([1.0, 2.0])])


# -- under torch.export ----------------------------------------------------------

class _Branchy(torch.nn.Module):
    def forward(self, x, n):
        y = TC.cond(x.sum() > 0, lambda v: v * 2.0, lambda v: v - 1.0, x)
        i, s = TC.while_loop(lambda i, s: i < n,
                             lambda i, s: (i + 1, s + y.sum()),
                             [torch.zeros((), dtype=torch.int64),
                              torch.zeros(())])
        z = TC.case([(x[0] > 1.0, lambda: y * 3.0),
                     (x[0] > 0.0, lambda: y + 3.0)], default=lambda: -y)
        w = TC.switch_case(n, {1: lambda: x + 100.0, 3: lambda: x * 0.5},
                           default=lambda: x)
        f = TC.fori_loop(0, n, lambda k, v: v + k, torch.zeros(()))
        arr = TC.TensorArray(capacity=3, example=x)
        arr = TC.array_write(x * 2.0, n - n, arr)
        read, length = TC.array_read(arr, 0), TC.array_length(arr)
        return y, s, z, w, f, read.value, length.value


def _jax_branchy(x, n):
    def body(x, n):
        xt = pt.Tensor(x)
        y = JC.cond(pt.Tensor(x.sum() > 0), lambda v: v * 2.0,
                    lambda v: v - 1.0, xt)
        i, s = JC.while_loop(lambda i, s: i < pt.Tensor(n),
                             lambda i, s: (i + 1, s + y.sum()),
                             (pt.to_tensor(0), pt.to_tensor(0.0)))
        z = JC.case([(pt.Tensor(x[0] > 1.0), lambda: y * 3.0),
                     (pt.Tensor(x[0] > 0.0), lambda: y + 3.0)],
                    default=lambda: y * -1.0)
        w = JC.switch_case(pt.Tensor(n), {1: lambda: xt + 100.0,
                                          3: lambda: xt * 0.5},
                           default=lambda: xt)
        f = JC.fori_loop(0, n, lambda k, v: v + k,
                         pt.to_tensor(0.0).value).value
        return (y.value, s.value, z.value, w.value, f)
    import jax
    return jax.jit(body)(x, n)


def test_exported_control_flow_lowers_and_matches_jax():
    import jax.numpy as jnp
    m = _Branchy()
    ep = torch.export.export(m, (torch.tensor([1.5, -0.5]),
                                 torch.tensor(3)))
    text = str(ep.graph)
    assert "cond" in text and "while_loop" in text
    for x, n in (([1.5, -0.5], 3), ([-2.0, 0.5], 1), ([0.5, 0.25], 4),
                 ([-1.0, -1.0], 0)):
        got = ep.module()(torch.tensor(x), torch.tensor(n))
        want = _jax_branchy(jnp.asarray(x, jnp.float32), jnp.asarray(n))
        for a, b in zip(got[:5], want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
        np.testing.assert_array_equal(got[5].numpy(),
                                      np.asarray(x, np.float32) * 2.0)
        assert int(got[6]) == 1
