"""``ops/manipulation.py``, ``ops/creation.py`` and ``ops/search.py`` of
the port against the JAX package: every op of the three modules through
both packages' public wrappers on seeded numpy inputs, values and
dtypes equal (bitwise: these ops move data, or compute in the same
order), and the gradient of ``sum(out * w)`` against JAX's tape. Then
the cases where torch's own functions mean something else: ``split``
counts sections, ``gather`` takes slices along ``axis``, ``scatter``
with duplicate indices keeps the last update, ``expand(-1)``, stable
sorts with NaN, ``topk`` ties (the lower index first), ``unique``'s
order and index dtype, and ``getitem`` / ``setitem``.

Tolerance: values bitwise, but ``linspace`` / ``logspace`` and the
float ``arange`` within 1e-6 relative (torch and XLA step in another
order); gradients bitwise, but those that sum over broadcast or
repeated positions within 1e-6 relative (the sums' order differs).
"""

import _torch_threads  # noqa: F401

import numpy as np
import pytest

from _torch_eager_parity import (assert_parity, covered, on_cpu,
                                 registry_names, rng_for, run_both)

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from paddle_tpu_torch.tools.eager_sweep import (creation_cases,
                                                manipulation_cases,
                                                search_cases)

_cpu = pytest.fixture(autouse=True, scope="module")(on_cpu)


MANIP, CREATE, SEARCH = (manipulation_cases(), creation_cases(),
                         search_cases())
LOOSE = {"linspace": 1e-6, "logspace": 1e-6, "arange": 1e-6}


def _id(c):
    return c[0]


@pytest.mark.parametrize("case", MANIP, ids=[_id(c) for c in MANIP])
def test_manipulation_op_matches_jax(case):
    name, args, kwargs, grad = case
    assert_parity(name, args, kwargs, grad, exact=True, grad_rtol=1e-6,
                  grad_atol=0)


@pytest.mark.parametrize("case", CREATE, ids=[_id(c) for c in CREATE])
def test_creation_op_matches_jax(case):
    name, args, kwargs, grad = case
    tol = LOOSE.get(name)
    assert_parity(name, args, kwargs, grad, exact=tol is None,
                  rtol=tol or 0, atol=0, grad_rtol=0, grad_atol=0)


@pytest.mark.parametrize("case", SEARCH, ids=[_id(c) for c in SEARCH])
def test_search_op_matches_jax(case):
    name, args, kwargs, grad = case
    assert_parity(name, args, kwargs, grad, exact=True, grad_rtol=0,
                  grad_atol=0)


@pytest.mark.parametrize("module,cases", [
    ("manipulation", MANIP), ("creation", CREATE), ("search", SEARCH)])
def test_every_op_is_covered_and_registered_as_in_jax(module, cases):
    jnames, tnames = registry_names(module)
    assert tnames == jnames
    assert covered(cases) == set(jnames)


# -- semantics that differ from torch's ----------------------------------------

def test_split_int_counts_sections_not_chunk_size():
    x = paddle.to_tensor(np.arange(12, dtype=np.float32).reshape(6, 2))
    parts = paddle.split(x, 2)
    assert [p.shape for p in parts] == [(3, 2), (3, 2)]
    assert [p.shape for p in x.split(3)] == [(2, 2)] * 3
    with pytest.raises(ValueError):
        paddle.split(x, 4)


def test_gather_takes_slices_along_axis():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    idx = np.array([[2, 0], [1, 1]], np.int32)
    assert_parity("gather", [a, idx], {"axis": 1}, exact=True)
    got = paddle.to_tensor(a).gather(paddle.to_tensor(idx), 0)
    assert got.shape == (2, 2, 4)


def test_scatter_duplicates_keep_the_last_update_and_only_it_has_grad():
    x = np.zeros((3, 2), np.float32)
    idx = np.array([0, 1, 0], np.int32)
    upd = np.arange(6, dtype=np.float32).reshape(3, 2)
    (jv, tv), (jg, tg) = run_both("scatter", [x, idx, upd], {}, (0, 2))
    np.testing.assert_array_equal(tv[0][0], jv[0][0])
    np.testing.assert_array_equal(tv[0][0][0], upd[2])
    for j, t in zip(jg, tg):
        np.testing.assert_array_equal(t, j)
    assert not np.any(tg[1][0])


def test_scatter_accumulate_sums_duplicates():
    x = np.ones((3, 2), np.float32)
    idx = np.array([0, 1, 0], np.int32)
    upd = np.arange(6, dtype=np.float32).reshape(3, 2)
    assert_parity("scatter", [x, idx, upd], {"overwrite": False}, (0, 2),
                  exact=True, grad_rtol=0, grad_atol=0)


def test_std_var_default_unbiased_matches_jax():
    a = rng_for("stdvar").standard_normal((4, 5)).astype(np.float32)
    for name in ("std", "var"):
        assert_parity(name, [a], {}, (0,), rtol=1e-6, atol=1e-7)


def test_expand_minus_one_keeps_the_dim():
    a = np.arange(3, dtype=np.float32).reshape(3, 1)
    assert paddle.to_tensor(a).expand([2, -1, 4]).shape == (2, 3, 4)


def test_sort_and_argsort_are_stable_and_place_nan_as_jax():
    x = np.array([2.0, np.nan, 1.0, 2.0, -np.inf, 1.0], np.float32)
    for desc in (False, True):
        assert_parity("argsort", [x], {"descending": desc}, exact=True)
        assert_parity("sort", [x], {"descending": desc}, exact=True)


def test_topk_tie_takes_the_lower_index_first():
    x = np.array([1.0, 3.0, 3.0, 2.0, 3.0], np.float32)
    _, i = paddle.topk(paddle.to_tensor(x), 2)
    np.testing.assert_array_equal(i.numpy(), [1, 2])
    assert i.dtype == paddle.int32
    assert_parity("topk", [x, 4], exact=True)


def test_unique_sorted_with_int32_inverse_of_the_input_shape():
    x = np.array([[3, 1], [1, 2]], np.int32)
    assert_parity("unique", [x], {"return_inverse": True}, exact=True)
    _, inv = paddle.unique(paddle.to_tensor(x), return_inverse=True)
    assert inv.dtype == paddle.int32 and inv.shape == (2, 2)


def test_getitem_setitem_match_jax_and_keep_the_gradient():
    """Values and ``inplace_version`` as in JAX. The gradient through a
    ``setitem`` is held to the functional ``x.at[idx].set(v)`` by hand:
    the JAX package's eager ``setitem`` records the tensor as its own
    input and loses the history before it (``dispatch.py:258-268``;
    ``x.grad`` stays None there), so it has no gradient to compare."""
    a = rng_for("items").standard_normal((4, 3)).astype(np.float32)
    v = np.float32(7.0)
    jx = pt.to_tensor(a, stop_gradient=False)
    tx = paddle.to_tensor(a, stop_gradient=False)
    jy, ty = jx * 2.0, tx * 2.0
    jy[1:3, 0] = v
    ty[1:3, 0] = v
    jy[np.array([0], np.int32)] = 1.0
    ty[paddle.to_tensor(np.array([0], np.int32))] = 1.0
    assert ty.inplace_version == jy.inplace_version == 2
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy.numpy()))
    w = rng_for("items/w").standard_normal((3, 2)).astype(np.float32)
    (jy[1:, ::2] * pt.to_tensor(w)).sum().backward()
    (ty[1:, ::2] * paddle.to_tensor(w)).sum().backward()
    assert jx.grad is None
    want = np.zeros((4, 3), np.float32)
    want[1:, ::2] = 2.0 * w
    want[1:3, 0] = 0.0   # overwritten by v
    want[0] = 0.0        # overwritten by 1.0
    np.testing.assert_array_equal(tx.grad.numpy(), want)


def test_setitem_leaves_other_holders_of_the_old_value_alone():
    a = paddle.to_tensor(np.zeros(3, np.float32))
    b = paddle.assign(a)
    c = paddle.reshape(a, [3])
    a[0] = 5.0
    assert b.numpy()[0] == 0 and c.numpy()[0] == 0 and a.numpy()[0] == 5


def test_index_outputs_are_int32_as_in_jax():
    x = paddle.to_tensor(np.array([[1.0, 3.0], [2.0, 0.0]], np.float32))
    for out in (paddle.argmax(x), paddle.argsort(x), paddle.topk(x, 1)[1],
                paddle.nonzero(x), paddle.shape(x),
                paddle.arange(3), paddle.to_tensor([1, 2])):
        assert out.dtype == paddle.int32
    assert paddle.to_tensor(np.arange(3, dtype=np.int64)).dtype == \
        paddle.int32
    assert paddle.zeros([2], dtype="int64").dtype == paddle.int32
    assert paddle.to_tensor(np.ones(2)).dtype == paddle.float32
