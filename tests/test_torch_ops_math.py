"""``ops/math.py`` of the port against the JAX package: every op of the
module through both packages' public wrappers (``paddle.add``, ...) on
seeded numpy inputs, values and dtypes equal within the stated
tolerance (bitwise for integer and bool outputs), and the gradient of
``sum(out * w)`` from the port's autograd against JAX's tape. Then the
edge cases where torch's own functions differ from JAX's: ties in
``max`` / ``min`` / ``amax`` / ``median`` / ``clip`` / ``maximum``
gradients, integer ``mod`` / ``floor_divide`` signs and division by
zero, and the weak typing of Python scalars.

Tolerance: fp32 values within rtol 1e-5 / atol 1e-6 (the two libraries'
elementwise kernels round differently in the last bit), the
transcendental and reduction ops where stated; gradients 10x the
values' tolerance.
"""

import _torch_threads  # noqa: F401

import numpy as np
import pytest

from _torch_eager_parity import (assert_parity, covered, on_cpu,
                                 registry_names, run_both)

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from paddle_tpu_torch.tools.eager_sweep import math_cases

_cpu = pytest.fixture(autouse=True, scope="module")(on_cpu)


CASES = math_cases()
# transcendental ops whose two libraries' kernels differ by a few ulps
LOOSE = {"erfinv": 5e-5, "lgamma": 2e-5, "digamma": 2e-5, "tan": 2e-5,
         "logcumsumexp": 2e-5, "pow": 2e-5, "acosh": 2e-5, "atanh": 2e-5,
         "cumprod": 2e-5, "prod": 2e-5, "logaddexp": 2e-5, "std": 2e-5,
         "var": 2e-5, "expm1": 2e-5}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_jax(case):
    name, args, kwargs, grad = case
    rtol = LOOSE.get(name, 1e-5)
    assert_parity(name, args, kwargs, grad, rtol=rtol, atol=1e-6,
                  grad_rtol=rtol * 10, grad_atol=1e-5)


def test_every_math_op_is_covered_and_registered_as_in_jax():
    jnames, tnames = registry_names("math")
    assert tnames == jnames
    assert covered(CASES) == set(jnames)


# -- ties: JAX splits a tie's gradient evenly ---------------------------------

@pytest.mark.parametrize("name,x,kw", [
    ("max", [1.0, 2.0, 2.0], {}), ("min", [3.0, 1.0, 1.0], {}),
    ("amax", [[2.0, 2.0], [1.0, 2.0]], {"axis": 1}),
    ("amin", [[0.5, 0.5, 0.5]], {}),
    ("median", [1.0, 2.0, 2.0, 3.0], {}), ("median", [2.0, 1.0, 2.0], {}),
    ("clip", [1.0, 2.0, 0.5, 1.5], {"min": 1.0, "max": 2.0}),
])
def test_tie_gradient_split_matches_jax(name, x, kw):
    xv = np.asarray(x, np.float32)
    assert_parity(name, [xv], kw, (0,), rtol=0, atol=0, grad_rtol=0,
                  grad_atol=0)


def test_maximum_tie_splits_both_sides():
    a = np.array([1.0, 2.0], np.float32)
    b = np.array([1.0, 3.0], np.float32)
    _, (jg, tg) = run_both("maximum", [a, b], {}, (0, 1))
    # the tie at 0: each side takes half of w[0]
    assert tg[0][0] == tg[1][0] != 0 and tg[0][1] == 0
    for j, t in zip(jg, tg):
        np.testing.assert_array_equal(t, j)


# -- integer edges ------------------------------------------------------------

INT_X = np.array([7, -7, 7, -7, 0, 5, -5, 0], np.int32)
INT_Y = np.array([2, 2, -2, -2, 3, 0, 0, 0], np.int32)


@pytest.mark.parametrize("name", ["floor_divide", "mod", "remainder",
                                  "floor_mod"])
def test_integer_signs_and_division_by_zero_match_jax(name):
    assert_parity(name, [INT_X, INT_Y], exact=True)


def test_float_mod_sign_follows_the_divisor():
    x = np.array([5.5, -5.5, 5.5, -5.5], np.float32)
    y = np.array([2.0, 2.0, -2.0, -2.0], np.float32)
    assert_parity("mod", [x, y], exact=True)
    assert_parity("floor_divide", [x, y], exact=True)


# -- weak typing of Python scalars ---------------------------------------------

@pytest.mark.parametrize("name,arr,scalar", [
    ("multiply", np.array([1, 2, 3], np.int32), 2.5),
    ("add", np.array([1, 2, 3], np.int32), 2),
    ("add", np.array([1.0, 2.0], np.float32), 1),
    ("divide", np.array([1, 2, 3], np.int32), 2),
    ("pow", np.array([1, 2, 3], np.int32), 2),
    ("multiply", np.array([True, False]), 3),
    ("subtract", np.array([1.5, 2.5], np.float16), 1.0),
])
def test_python_scalar_promotion_matches_jax(name, arr, scalar):
    assert_parity(name, [arr, scalar], exact=True)


def test_bf16_plus_python_float_stays_bf16():
    x = np.array([1.0, 2.5, -3.0], np.float32)
    j = pt.to_tensor(x).astype("bfloat16") + 1.0
    t = paddle.to_tensor(x).astype("bfloat16") + 1.0
    assert str(np.dtype(j.dtype)) == "bfloat16"
    assert t.dtype == paddle.bfloat16
    np.testing.assert_array_equal(t.astype("float32").numpy(),
                                  np.asarray(j.astype("float32").numpy()))


def test_int_sum_and_cumsum_stay_int32_and_mean_is_float32():
    x = np.arange(6, dtype=np.int32).reshape(2, 3)
    for name, kw in (("sum", {}), ("cumsum", {"axis": 1}), ("mean", {}),
                     ("prod", {"axis": 0}), ("std", {})):
        assert_parity(name, [x], kw)
