"""``ops/math_extra.py`` and ``ops/random.py`` of the port against the JAX
package.

math_extra: every op through both packages' public wrappers on seeded
numpy inputs, values and dtypes equal within the stated tolerance, and
the gradient of ``sum(out * w)`` against JAX's tape.

random: the bits cannot match JAX's PRNG, so each op is held to the JAX
op's output shape and dtype, to ``paddle.seed`` determinism (the same
seed draws the same values, another seed other values), and to its
distribution's moments over 20000 draws: the sample mean within 5
standard errors of the distribution's mean, and the sample variance
within 10% of its variance.
"""

import _torch_threads  # noqa: F401

import numpy as np
import pytest

from _torch_eager_parity import (assert_parity, covered, on_cpu,
                                 registry_names)

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from paddle_tpu import dispatch as jdispatch
from paddle_tpu_torch.core.dtype import dtype_name
from paddle_tpu_torch.tools.eager_sweep import N, RANDOM, math_extra_cases

_cpu = pytest.fixture(autouse=True, scope="module")(on_cpu)


EXTRA = math_extra_cases()
LOOSE = {"i0": 1e-5, "i0e": 1e-5, "i1": 1e-5, "i1e": 1e-5,
         "polygamma": 2e-5, "nanquantile": 1e-6, "nanmedian": 1e-6,
         "cdist": 1e-5, "pairwise_distance": 1e-5, "renorm": 1e-5,
         "float_power": 1e-5, "tensordot": 1e-5, "ldexp": 1e-6,
         "polar": 1e-6, "vander": 1e-6, "trapezoid": 1e-6,
         "cumulative_trapezoid": 1e-6, "logit": 1e-6, "addcdiv": 1e-6,
         "addcmul": 1e-6}


@pytest.mark.parametrize("case", EXTRA, ids=[c[0] for c in EXTRA])
def test_math_extra_op_matches_jax(case):
    name, args, kwargs, grad = case
    tol = LOOSE.get(name)
    assert_parity(name, args, kwargs, grad, exact=tol is None,
                  rtol=tol or 0, atol=1e-6 if tol else 0,
                  grad_rtol=(tol or 1e-6) * 10, grad_atol=1e-5)


def test_every_math_extra_op_is_covered_and_registered_as_in_jax():
    jnames, tnames = registry_names("math_extra")
    assert tnames == jnames
    assert covered(EXTRA) == set(jnames)


# -- random ----------------------------------------------------------------------

def _port(name, args, kwargs):
    from paddle_tpu_torch import dispatch
    targs = [paddle.to_tensor(a) if isinstance(a, np.ndarray) else a
             for a in args]
    return dispatch.wrapped_ops[name](*targs, **kwargs)


@pytest.mark.parametrize("case", RANDOM, ids=[c[0] for c in RANDOM])
def test_random_op_shape_dtype_seed_and_moments(case):
    name, args, kwargs, mean, var = case
    small = [a[:64] if isinstance(a, np.ndarray) else
             ([64] if a == [N] else (64 if a == N else a)) for a in args]
    skw = dict(kwargs)
    if skw.get("shape") == [N]:
        skw["shape"] = [64]
    jargs = [pt.to_tensor(a) if isinstance(a, np.ndarray) else a
             for a in small]
    j = jdispatch.wrapped_ops[name](*jargs, **skw)
    t = _port(name, small, skw)
    assert t.shape == tuple(j.shape)
    assert dtype_name(t.dtype) == str(np.dtype(j.dtype))
    paddle.seed(11)
    a = _port(name, args, kwargs).numpy()
    paddle.seed(11)
    b = _port(name, args, kwargs).numpy()
    paddle.seed(12)
    c = _port(name, args, kwargs).numpy()
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    x = a.astype(np.float64).reshape(-1)
    se = np.sqrt(var / x.size)
    assert abs(x.mean() - mean) < 5 * se, (name, x.mean(), mean)
    assert abs(x.var() - var) < 0.1 * var, (name, x.var(), var)


def test_random_ops_without_replacement_and_uniform_seed():
    paddle.seed(3)
    w = paddle.to_tensor(np.array([0.1, 0.2, 0.3, 0.4], np.float32))
    draw = paddle.multinomial(w, 4).numpy()
    assert sorted(draw.tolist()) == [0, 1, 2, 3]
    u1 = paddle.uniform([8], seed=5).numpy()
    u2 = paddle.uniform([8], seed=5).numpy()
    np.testing.assert_array_equal(u1, u2)
    perm = paddle.randperm(50).numpy()
    assert sorted(perm.tolist()) == list(range(50))


def test_every_random_op_is_covered_and_registered_as_in_jax():
    jnames, tnames = registry_names("random")
    assert tnames == jnames
    assert {c[0] for c in RANDOM} == set(jnames)


def test_random_ops_draw_from_the_key_scope_generator():
    import torch

    from paddle_tpu_torch.core import rng
    g1 = torch.Generator().manual_seed(4)
    g2 = torch.Generator().manual_seed(4)
    with rng.key_scope(g1):
        a = paddle.randn([16]).numpy()
    with rng.key_scope(g2):
        b = paddle.randn([16]).numpy()
    np.testing.assert_array_equal(a, b)
    c = paddle.randn([16], generator=torch.Generator().manual_seed(4))
    np.testing.assert_array_equal(c.numpy(), a)
