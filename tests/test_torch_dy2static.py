"""The port's dy2static (``jit/dy2static.py``, ``jit/convert_ops.py``)
against the JAX package's, case for case with ``tests/test_dy2static.py``.

Each function is converted by both packages and run on the same numpy
inputs: the JAX function eagerly and under ``jax.jit`` (its tensor
conditions lower to ``lax.cond`` / ``lax.while_loop``), the port's
eagerly (Python semantics) and through ``torch.export`` (its tensor
conditions lower to ``torch.cond`` / ``while_loop``), the exported
program saved and loaded with ``torch.export.save`` / ``load``. One
program is exported per function and run for every branch outcome.

Tolerances, stated: the port's eager outputs within 1e-6 relative of
JAX's (measured 0: every case is exact small-integer float math); the
exported program equal to the port's eager run bitwise.
"""

import _torch_threads  # noqa: F401

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.jit.dy2static import convert_to_static as jconvert
from paddle_tpu_torch.jit.dy2static import convert_to_static as tconvert

RTOL = 1e-6


def jconv(fn):
    return jconvert(fn, raise_on_error=True)


def tconv(fn):
    return tconvert(fn, raise_on_error=True)


class _Fn(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def exported(fn, *args):
    """``fn`` (converted by the caller) exported at ``args``, saved and
    loaded back: the loaded program's callable."""
    ep = torch.export.export(_Fn(fn), tuple(args), strict=False)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    buf.seek(0)
    return torch.export.load(buf).module()


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def both(fn, *cases):
    """Each case (a tuple of numpy arrays) through JAX's converted
    function eagerly and under jit and through the port's eagerly and
    through one program exported at the first case; returns the port's
    outputs."""
    jf, tf = jconv(fn), tconv(fn)
    prog = exported(tf, *[_t(a) for a in cases[0]])
    outs = []
    for args in cases:
        want = np.asarray(jax.jit(jf)(*[_j(a) for a in args]))
        np.testing.assert_allclose(np.asarray(jf(*[_j(a) for a in args])),
                                   want, rtol=RTOL)
        got = tf(*[_t(a) for a in args])
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
        assert torch.equal(prog(*[_t(a) for a in args]), got)
        outs.append(got.numpy())
    return outs


def f32(*v):
    return np.asarray(v, np.float32)


# ------------------------------------------------------------------ if/else

def test_if_tensor_cond_jittable():
    def f(x):
        if x.sum() > 0:
            y = x * 2
        else:
            y = x - 1
        return y

    pos, neg = both(f, (f32(1.0, 2.0),), (f32(-1.0, -2.0),))
    np.testing.assert_allclose(pos, [2.0, 4.0])
    np.testing.assert_allclose(neg, [-2.0, -3.0])


@pytest.mark.parametrize("flag,want", [(True, 4.0), (False, 2.0)])
def test_if_python_semantics_preserved(flag, want):
    def f(flag, x):
        if flag:  # plain Python bool — must not be traced
            out = x + 1
        else:
            out = x - 1
        return out

    assert float(jconv(f)(flag, jnp.asarray(3.0))) == want
    assert float(tconv(f)(flag, torch.tensor(3.0))) == want
    prog = exported(lambda x: tconv(f)(flag, x), torch.tensor(3.0))
    assert float(prog(torch.tensor(3.0))) == want


def test_if_no_else_with_prior_value():
    def f(x):
        y = x * 0
        if x.max() > 1:
            y = x + 10
        return y

    hi, lo = both(f, (f32(2.0),), (f32(0.5),))
    np.testing.assert_allclose(hi, [12.0])
    np.testing.assert_allclose(lo, [0.0])


def test_elif_chain():
    def f(x):
        s = x.sum()
        if s > 10:
            r = x * 0 + 1
        elif s > 0:
            r = x * 0 + 2
        else:
            r = x * 0 + 3
        return r

    outs = both(f, (f32(20.0),), (f32(5.0),), (f32(-5.0),))
    np.testing.assert_allclose(np.concatenate(outs), [1.0, 2.0, 3.0])


def test_return_in_both_branches():
    def f(x):
        if x.sum() > 0:
            return x * 2
        else:
            return x - 1

    pos, neg = both(f, (f32(3.0),), (f32(-3.0),))
    np.testing.assert_allclose(pos, [6.0])
    np.testing.assert_allclose(neg, [-4.0])


def test_early_return_with_tail():
    def f(x):
        if x.sum() > 0:
            return x * 2
        return x - 1

    pos, neg = both(f, (f32(3.0),), (f32(-3.0),))
    np.testing.assert_allclose(pos, [6.0])
    np.testing.assert_allclose(neg, [-4.0])


# -------------------------------------------------------------------- loops

def test_while_tensor_cond():
    def f(x):
        s = x * 0
        while s.sum() < 10:
            s = s + x
        return s

    # four iterations, and one
    four, one = both(f, (f32(3.0),), (f32(20.0),))
    np.testing.assert_allclose(four, [12.0])
    np.testing.assert_allclose(one, [20.0])


def test_while_python_cond_unrolled():
    def f(x):
        i = 0
        while i < 3:  # concrete — unrolls at trace time
            x = x * 2
            i += 1
        return x

    (out,) = both(f, (np.float32(1.0),))
    np.testing.assert_allclose(out, 8.0)


def test_for_range_concrete():
    def f(x):
        acc = x * 0
        for i in range(4):
            acc = acc + x * i
        return acc

    (out,) = both(f, (np.float32(2.0),))
    np.testing.assert_allclose(out, 12.0)


def test_for_range_traced_bound():
    def f(x, n):
        acc = x * 0
        for _ in range(n):
            acc = acc + x
        return acc

    jf, tf = jconv(f), tconv(f)
    prog = exported(tf, torch.tensor(5.0), torch.tensor(3))
    for n, want in ((3, 15.0), (0, 0.0)):
        assert float(jax.jit(jf)(jnp.asarray(5.0), jnp.asarray(n))) == want
        assert float(tf(torch.tensor(5.0), torch.tensor(n))) == want
        assert float(prog(torch.tensor(5.0), torch.tensor(n))) == want


def test_break_concrete_and_traced():
    def f(x, limit):
        acc = x * 0
        for i in range(10):
            if acc.sum() > limit:
                break
            acc = acc + x
        return acc

    # concrete path
    assert float(jconv(f)(jnp.asarray(1.0), 3.5)) == 4.0
    assert float(tconv(f)(torch.tensor(1.0), 3.5)) == 4.0
    # traced path (limit traced: the break condition is traced)
    outs = both(f, (np.float32(1.0), np.float32(3.5)),
                (np.float32(1.0), np.float32(0.5)),
                (np.float32(1.0), np.float32(100.0)))
    assert [float(o) for o in outs] == [4.0, 1.0, 10.0]


def test_continue():
    def f(x):
        acc = x * 0
        for i in range(6):
            if i % 2 == 1:
                continue
            acc = acc + i
        return acc

    (out,) = both(f, (np.float32(0.0),))
    assert float(out) == 0 + 2 + 4


def test_nested_loop_break_ownership():
    def f(x):
        total = x * 0
        for i in range(3):
            for j in range(5):
                if j >= 2:
                    break
                total = total + 1
        return total

    (out,) = both(f, (np.float32(0.0),))
    assert float(out) == 6.0


@pytest.mark.parametrize("thresh,want", [(50.0, 101.0), (0.5, 1.0)])
def test_for_else(thresh, want):
    def f(x, thresh):
        for i in range(3):
            if float(x) > thresh:
                break
        else:
            x = x + 100
        return x

    assert float(jconv(f)(jnp.asarray(1.0), thresh)) == want
    assert float(tconv(f)(torch.tensor(1.0), thresh)) == want


# ---------------------------------------------------------- logic / assert

def test_logical_and_or_not():
    def f(x):
        if (x.sum() > 0) and (x.max() < 10):
            r = x + 1
        else:
            r = x - 1
        return r

    small, big, neg = both(f, (f32(2.0),), (f32(20.0),), (f32(-2.0),))
    np.testing.assert_allclose(small, [3.0])
    np.testing.assert_allclose(big, [19.0])
    np.testing.assert_allclose(neg, [-3.0])

    def g(flag, x):
        # short-circuit on concrete lhs must be preserved
        if flag and x.undefined_attr:  # never evaluated when flag False
            return x
        return x + 1

    assert float(jconv(g)(False, jnp.asarray(1.0))) == 2.0
    assert float(tconv(g)(False, torch.tensor(1.0))) == 2.0

    def h(x):
        if not (x.sum() > 0) or x.max() > 5:
            r = x * 10
        else:
            r = x
        return r

    outs = both(h, (f32(-1.0),), (f32(6.0),), (f32(2.0),))
    np.testing.assert_allclose(np.concatenate(outs), [-10.0, 60.0, 2.0])


def test_assert_traced_skipped():
    def f(x):
        assert x.sum() > -1e9  # traced → skipped
        return x * 2

    (out,) = both(f, (f32(1.0),))
    np.testing.assert_allclose(out, [2.0])

    def g(n):
        assert n > 0, "need positive"
        return n

    with pytest.raises(AssertionError):
        jconv(g)(0)
    with pytest.raises(AssertionError):
        tconv(g)(0)


# ------------------------------------------------------------- integration

def test_to_static_uses_dy2static():
    import paddle_tpu as pt
    from paddle_tpu.jit import to_static as jto_static
    from paddle_tpu_torch.jit import to_static

    def step(x):
        if x.sum() > 0:
            return x * 2
        return x - 1

    js, ts = jto_static(step), to_static(step)
    for v, want in ((4.0, 8.0), (-4.0, -5.0)):
        j = js(pt.Tensor(jnp.asarray([v])))
        t = ts(torch.tensor([v]))
        np.testing.assert_allclose(np.asarray(j.value), [want])
        np.testing.assert_allclose(t.numpy(), [want])
    # the port's StaticFunction runs the converted function
    assert ts.fn is not step and getattr(ts.fn, "__pt_converted__", False)


def test_grad_through_converted_cond():
    def f(x):
        if x.sum() > 0:
            y = x * x
        else:
            y = x * 3.0
        return y.sum()

    g = jax.grad(jconv(f))
    tf = tconv(f)
    for v, want in ((2.0, 4.0), (-2.0, 3.0)):
        np.testing.assert_allclose(g(jnp.asarray([v])), [want])
        x = torch.tensor([v], requires_grad=True)
        tf(x).backward()
        np.testing.assert_allclose(x.grad.numpy(), [want])


def test_closure_preserved():
    scale = 7.0

    def f(x):
        if x.sum() > 0:
            y = x * scale
        else:
            y = x
        return y

    pos, neg = both(f, (f32(1.0),), (f32(-1.0),))
    np.testing.assert_allclose(pos, [7.0])
    np.testing.assert_allclose(neg, [-1.0])


def test_fallback_on_unsupported_source():
    # builtins have no retrievable source → returned unchanged
    assert tconvert(len) is len
    assert jconvert(len) is len


def test_return_inside_except_handler():
    def f(x):
        for i in range(3):
            try:
                if i == 1:
                    raise ValueError()
            except ValueError:
                return x * 100
        return x + 1

    assert float(jconv(f)(jnp.asarray(2.0))) == 200.0
    assert float(tconv(f)(torch.tensor(2.0))) == 200.0


def test_closure_sees_live_rebinding():
    scale = 1.0

    def f(x):
        if x.sum() > 0:
            y = x * scale
        else:
            y = x
        return y

    jf, tf = jconv(f), tconv(f)
    scale = 10.0  # rebinding after conversion must be visible
    np.testing.assert_allclose(np.asarray(jf(jnp.asarray([1.0]))), [10.0])
    np.testing.assert_allclose(tf(torch.tensor([1.0])).numpy(), [10.0])
    prog = exported(tf, torch.tensor([1.0]))
    np.testing.assert_allclose(prog(torch.tensor([1.0])).numpy(), [10.0])


_gscale = 1.0


def _uses_global(x):
    if x.sum() > 0:
        return x * _gscale
    return x


def test_module_global_sees_live_rebinding():
    global _gscale
    _gscale = 1.0
    jf, tf = jconv(_uses_global), tconv(_uses_global)
    _gscale = 5.0
    assert float(jf(jnp.asarray(2.0))) == 10.0
    assert float(tf(torch.tensor(2.0))) == 10.0
    # the JAX and the port's conversions of one module's function keep
    # their own helper modules apart
    assert float(jax.jit(jf)(jnp.asarray(-2.0))) == -2.0
    assert float(exported(tf, torch.tensor(2.0))(torch.tensor(-2.0))) == -2.0


def test_enable_toggle_after_decoration():
    """JAX: with conversion off, jit cannot trace the tensor-dependent
    if. The port runs eagerly either way; its counterpart is the
    export, which fails on the unconverted function and keeps the
    converted one's branch."""
    from paddle_tpu.jit import enable_to_static as jenable
    from paddle_tpu.jit import to_static as jto_static
    from paddle_tpu_torch.jit import enable_to_static, to_static

    def f(x):
        if x.sum() > 0:
            return x * 2
        return x - 1

    jf, tf = jto_static(f), to_static(f)
    x = torch.tensor([1.0])
    np.testing.assert_allclose(np.asarray(jf(jnp.asarray([1.0]))), [2.0])
    np.testing.assert_allclose(tf(x).numpy(), [2.0])
    jenable(False)
    enable_to_static(False)
    try:
        with pytest.raises(Exception):
            jf(jnp.asarray([1.0]))
        np.testing.assert_allclose(tf(x).numpy(), [2.0])
        with pytest.raises(Exception):
            exported(tf, x)
    finally:
        jenable(True)
        enable_to_static(True)
    np.testing.assert_allclose(np.asarray(jf(jnp.asarray([1.0]))), [2.0])
    prog = exported(tf, x)
    np.testing.assert_allclose(prog(torch.tensor([-1.0])).numpy(), [-2.0])


def test_multi_element_condition_raises():
    def f(x):
        if x > 0:  # elementwise condition — a user bug, must not be
            y = x + 1  # silently reduced
        else:
            y = x - 1
        return y

    with pytest.raises(ValueError, match="ambiguous"):
        jax.jit(jconv(f))(jnp.asarray([1.0, -1.0]))
    with pytest.raises(ValueError, match="ambiguous"):
        tconv(f)(torch.tensor([1.0, -1.0]))
    with pytest.raises(ValueError, match="ambiguous"):
        exported(tconv(f), torch.tensor([1.0, -1.0]))


def test_assert_message_lazy():
    for conv, arg in ((jconv, lambda v: v), (tconv, lambda v: v)):
        evaluated = []

        def f(n):
            assert n > 0, evaluated.append("boom") or "msg"
            return n

        cf = conv(f)
        assert cf(arg(5)) == 5
        assert evaluated == []  # message must not evaluate on success
        with pytest.raises(AssertionError):
            cf(arg(0))
        assert evaluated == ["boom"]
