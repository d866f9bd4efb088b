"""The eager op sweep: seeded numpy inputs for every op of the six eager
modules (``ops/creation.py``, ``math.py``, ``manipulation.py``,
``search.py``, ``random.py``, ``math_extra.py``) and of the tail
(``tail_cases``: linalg, fft, sequence, the CRF / segment ops,
detection, the loss, metric and CTR tails; ``card_sized_cases`` at the
sizes real work gives them).

Each case is ``(op name, args, kwargs, grad)``: ``args`` hold numpy
arrays (made ``Tensor``s by the caller; those at the ``grad`` indices
require grad), lists of arrays (lists of ``Tensor``s) and plain values.
``chip_smoke.py``'s ``phase_eager_api`` runs them on CUDA ``Tensor``s
against CPU ones; ``tests/test_torch_ops_*.py`` run them through this
package against the JAX package. ``RANDOM`` gives each random op's
arguments with the mean and variance of one draw, for the moment checks.
"""

from __future__ import annotations

import zlib

import numpy as np


def rng_for(name: str) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(name.encode()))


def _arrays(name):
    r = rng_for(name)
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    pos = lambda *s: r.uniform(0.5, 2.0, s).astype(np.float32)  # noqa
    unit = lambda *s: r.uniform(-0.9, 0.9, s).astype(np.float32)  # noqa
    ints = lambda lo, hi, *s: r.integers(lo, hi, s).astype(np.int32)  # noqa
    return f, pos, unit, ints


def math_cases():
    f, pos, unit, ints = _arrays("math")
    A, B, P, U = f(3, 4), f(3, 4), pos(3, 4), unit(3, 4)
    I, J = ints(-9, 10, 3, 4), ints(1, 6, 3, 4)
    Bo, Bo2 = A > 0, B > 0
    S = ints(0, 4, 3, 4)
    T = f(2, 3, 4)
    withnan = A.copy()
    withnan[0, 1] = np.nan
    withnan[2, 3] = np.inf
    withnan[1, 0] = -np.inf
    g = (0, 1)
    c = [
        # binary elementwise
        ("add", [A, B], {}, g), ("subtract", [A, B], {}, g),
        ("multiply", [A, B], {}, g), ("divide", [A, P], {}, g),
        ("floor_divide", [I, J], {}, ()), ("mod", [I, J], {}, ()),
        ("remainder", [A, P], {}, (0,)), ("floor_mod", [I, J], {}, ()),
        ("pow", [P, A], {}, g), ("maximum", [A, B], {}, g),
        ("minimum", [A, B], {}, g), ("fmax", [A, B], {}, g),
        ("fmin", [A, B], {}, g), ("atan2", [A, B], {}, g),
        ("hypot", [A, B], {}, g), ("logaddexp", [A, B], {}, g),
        ("heaviside", [A, B], {}, (1,)), ("copysign", [A, B], {}, (0,)),
        ("nextafter", [A, B], {}, ()), ("lcm", [I, J], {}, ()),
        ("gcd", [I, J], {}, ()),
        # unary elementwise
        ("abs", [A], {}, (0,)), ("neg", [A], {}, (0,)),
        ("exp", [A], {}, (0,)), ("expm1", [A], {}, (0,)),
        ("log", [P], {}, (0,)), ("log2", [P], {}, (0,)),
        ("log10", [P], {}, (0,)), ("log1p", [P], {}, (0,)),
        ("sqrt", [P], {}, (0,)), ("rsqrt", [P], {}, (0,)),
        ("square", [A], {}, (0,)), ("reciprocal", [P], {}, (0,)),
        ("sin", [A], {}, (0,)), ("cos", [A], {}, (0,)),
        ("tan", [U], {}, (0,)), ("asin", [U], {}, (0,)),
        ("acos", [U], {}, (0,)), ("atan", [A], {}, (0,)),
        ("sinh", [A], {}, (0,)), ("cosh", [A], {}, (0,)),
        ("tanh", [A], {}, (0,)), ("asinh", [A], {}, (0,)),
        ("acosh", [P + 1], {}, (0,)), ("atanh", [U], {}, (0,)),
        ("floor", [A * 3], {}, (0,)), ("ceil", [A * 3], {}, (0,)),
        ("round", [A * 3], {}, (0,)), ("trunc", [A * 3], {}, (0,)),
        ("frac", [A * 3], {}, (0,)), ("sign", [A], {}, (0,)),
        ("sgn", [A], {}, (0,)), ("erf", [A], {}, (0,)),
        ("erfinv", [U], {}, (0,)), ("lgamma", [P], {}, (0,)),
        ("digamma", [P], {}, (0,)), ("angle", [A], {}, ()),
        ("conj", [A], {}, (0,)), ("real", [A], {}, (0,)),
        ("imag", [A], {}, ()),
        ("clip", [A, -0.5, 0.5], {}, (0,)),
        ("scale", [A], {"scale": 2.0, "bias": 0.5}, (0,)),
        ("stanh", [A], {}, (0,)), ("lerp", [A, B, 0.3], {}, g),
        ("rad2deg", [A], {}, (0,)), ("deg2rad", [A], {}, (0,)),
        ("exponent", [A], {}, ()),
        # nan handling
        ("isnan", [withnan], {}, ()), ("isinf", [withnan], {}, ()),
        ("isfinite", [withnan], {}, ()),
        ("nan_to_num", [withnan], {"nan": 0.5}, ()),
        ("nansum", [withnan[:, :1].repeat(4, 1)], {"axis": 0}, ()),
        ("nanmean", [np.where(np.isinf(withnan), 1.0, withnan)],
         {"axis": 1}, ()),
        # reductions
        ("sum", [A], {"axis": 1}, (0,)), ("mean", [T], {"axis": [0, 2]},
                                          (0,)),
        ("max", [A], {"axis": 0}, (0,)), ("min", [A], {"axis": 1,
                                                       "keepdim": True},
                                          (0,)),
        ("amax", [T], {"axis": [1, 2]}, (0,)), ("amin", [A], {}, (0,)),
        ("prod", [P], {"axis": 1}, (0,)),
        ("logsumexp", [A], {"axis": -1}, (0,)),
        ("all", [Bo], {"axis": 0}, ()), ("any", [Bo], {"axis": 1}, ()),
        ("std", [A], {"axis": 1}, (0,)),
        ("var", [A], {"axis": 0, "unbiased": False}, (0,)),
        ("median", [A], {"axis": 1}, (0,)),
        ("quantile", [A, 0.3], {"axis": 1}, (0,)),
        ("count_nonzero", [S], {"axis": 1}, ()),
        # cumulative
        ("cumsum", [A], {"axis": 1}, (0,)), ("cumprod", [P], {"dim": 1},
                                             (0,)),
        ("cummax", [A], {"axis": 1}, (0,)), ("cummin", [A], {"axis": 0},
                                             (0,)),
        ("logcumsumexp", [A], {"axis": 1}, (0,)),
        # comparison
        ("equal", [S, S.T.copy().reshape(3, 4)], {}, ()),
        ("not_equal", [S, S[::-1].copy()], {}, ()),
        ("greater_than", [A, B], {}, ()), ("greater_equal", [A, B], {}, ()),
        ("less_than", [A, B], {}, ()), ("less_equal", [A, B], {}, ()),
        ("equal_all", [S, S.copy()], {}, ()),
        ("allclose", [A, A + 1e-7], {}, ()),
        ("isclose", [A, B + A], {"atol": 0.5}, ()),
        # logical / bitwise
        ("logical_and", [Bo, Bo2], {}, ()), ("logical_or", [Bo, Bo2], {}, ()),
        ("logical_xor", [Bo, Bo2], {}, ()), ("logical_not", [Bo], {}, ()),
        ("bitwise_and", [I, J], {}, ()), ("bitwise_or", [I, J], {}, ()),
        ("bitwise_xor", [I, J], {}, ()), ("bitwise_not", [I], {}, ()),
        ("left_shift", [I, S], {}, ()), ("right_shift", [I, S], {}, ()),
        # matmul family
        ("matmul", [A, B], {"transpose_y": True}, g),
        ("dot", [A, B], {}, g), ("mm", [A, B.T.copy()], {}, g),
        ("bmm", [T, f(2, 4, 5)], {}, g),
        ("addmm", [f(3, 3), A, B.T.copy()], {"beta": 0.5, "alpha": 2.0},
         (0, 1, 2)),
        ("inner", [A, B], {}, g), ("outer", [A[0], B[1]], {}, g),
        ("kron", [A[:2, :2].copy(), B[:2].copy()], {}, g),
        ("cross", [f(4, 3), f(4, 3)], {}, g),
        ("trace", [f(4, 4)], {"offset": 1}, (0,)),
        ("diagonal", [T], {"axis1": 1, "axis2": 2}, (0,)),
        ("multiply_sum", [A, B], {"axis": 1}, g),
        ("diff", [A], {"n": 2, "axis": 1}, (0,)),
        ("histogram", [A], {"bins": 5}, ()),
        ("add_n", [[A, B, P]], {}, (0,)),
        ("broadcast_shape", [[3, 1, 4], [5, 1]], {}, ()),
    ]
    return c


def manipulation_cases():
    r = rng_for("manipulation")
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    A, T = f(3, 4), f(2, 3, 4)
    idx = np.array([2, 0, 1, 2], np.int32)
    g = (0,)
    cplx = (f(3) + 1j * f(3)).astype(np.complex64)
    return [
        ("reshape", [A, [4, 3]], {}, g), ("transpose", [T, [2, 0, 1]], {}, g),
        ("t", [A], {}, g), ("moveaxis", [T, 0, 2], {}, g),
        ("swapaxes", [T, 0, 2], {}, g),
        ("concat", [[A, f(2, 4)]], {"axis": 0}, g),
        ("stack", [[A, A * 2]], {"axis": 1}, g),
        ("unstack", [T], {"axis": 1}, g), ("unbind", [T], {"axis": 2}, g),
        ("split", [f(6, 2), 3], {}, g),
        ("split", [f(6, 2), [1, -1, 2]], {}, g),
        ("chunk", [f(7, 2), 3], {}, g),
        ("squeeze", [f(3, 1, 4, 1)], {"axis": [1, 2]}, g),
        ("unsqueeze", [A, [0, 2]], {}, g),
        ("flatten", [T], {"start_axis": 1}, g), ("ravel", [T], {}, g),
        ("expand", [f(3, 1), [2, -1, 5]], {}, g),
        ("broadcast_to", [f(1, 4), [3, 4]], {}, g),
        ("broadcast_tensors", [[f(3, 1), f(1, 4)]], {}, g),
        ("expand_as", [f(1, 4), A], {}, g),
        ("tile", [A, [2, 1]], {}, g),
        ("repeat_interleave", [A, 2], {"axis": 1}, g),
        ("flip", [A, [0, 1]], {}, g), ("roll", [A, 2], {"axis": 1}, g),
        ("rot90", [A], {"k": 1}, g),
        ("pad", [A, [1, 0, 2, 1]], {"mode": "constant", "value": 0.5}, g),
        ("gather", [A, idx], {"axis": 1}, g),
        ("index_select", [A, idx[:2]], {"axis": 0}, g),
        ("take_along_axis", [A, np.argsort(A, 1).astype(np.int32), 1], {},
         g),
        ("put_along_axis", [A, np.array([[0], [1], [3]], np.int32),
                            f(3, 1), 1], {}, (0, 2)),
        ("gather_nd", [T, np.array([[0, 1], [1, 2]], np.int32)], {}, g),
        ("scatter", [A, np.array([2, 0], np.int32), f(2, 4)], {}, (0, 2)),
        ("scatter_nd_add", [A, np.array([[0, 1], [2, 3], [0, 1]], np.int32),
                            f(3)], {}, (0, 2)),
        ("scatter_nd", [np.array([[1], [3]], np.int32), f(2, 3), [5, 3]],
         {}, (1,)),
        ("index_add", [A, np.array([0, 2, 0], np.int32), 0, f(3, 4)], {},
         (0, 3)),
        ("index_put", [A, (np.array([0, 2], np.int32),
                           np.array([1, 3], np.int32)), f(2)], {}, (0,)),
        ("slice", [T, [1, 2], [0, 1], [2, 4]], {}, g),
        ("strided_slice", [T, [1, 2], [2, 3], [-4, 0], [-1, -2]], {}, g),
        ("where", [A > 0, A, f(3, 4)], {}, (1, 2)),
        ("nonzero", [A > 0], {}, ()),
        ("masked_select", [A, A > 0], {}, ()),
        ("masked_fill", [A, A > 0, 2.0], {}, g),
        ("unique", [np.array([3, 1, 2, 1, 3, 3], np.int32)],
         {"return_index": True, "return_inverse": True,
          "return_counts": True}, ()),
        ("unique_consecutive", [np.array([1, 1, 2, 2, 3, 1, 1], np.int32)],
         {"return_inverse": True, "return_counts": True}, ()),
        ("one_hot", [np.array([0, 2, 1, 5], np.int32), 4], {}, ()),
        ("cast", [A * 3, "int32"], {}, ()),
        ("numel", [T], {}, ()),
        ("shard_index", [np.array([[1], [6], [12], [19]], np.int32), 20, 2,
                         1], {}, ()),
        ("as_real", [cplx], {}, ()), ("as_complex", [f(3, 2)], {}, ()),
        ("view", [A, [2, 6]], {}, g),
        ("crop", [T, [1, 2, 2]], {"offsets": [1, 0, 1]}, g),
        ("reverse", [A, 0], {}, g), ("shape", [T], {}, ()),
        ("is_empty", [A], {}, ()),
    ]


def creation_cases():
    r = rng_for("creation")
    v = r.standard_normal(4).astype(np.float32)
    A = r.standard_normal((3, 4)).astype(np.float32)
    return [
        ("to_array", [[1, 2, 3]], {}, ()),
        ("to_array", [[1.5, 2.0]], {"dtype": "float16"}, ()),
        ("zeros", [[2, 3]], {}, ()), ("ones", [[2, 3]], {"dtype": "int64"},
                                      ()),
        ("full", [[2, 2], 3], {}, ()), ("zeros_like", [A], {}, ()),
        ("ones_like", [A], {"dtype": "int32"}, ()),
        ("full_like", [A, 7.5], {}, ()), ("empty", [[3]], {}, ()),
        ("empty_like", [A], {}, ()),
        ("arange", [5], {}, ()), ("arange", [1, 10, 3], {}, ()),
        ("arange", [0.0, 1.0, 0.25], {}, ()),
        ("linspace", [0.0, 1.0, 7], {}, ()),
        ("logspace", [0.0, 2.0, 5], {}, ()),
        ("eye", [3, 4], {}, ()),
        ("diag", [v], {"offset": 1}, (0,)), ("diag", [A], {}, (0,)),
        ("diag", [v], {"padding_value": 2.0}, (0,)),
        ("diagflat", [A[:2]], {}, (0,)),
        ("tril", [A], {"diagonal": -1}, (0,)), ("triu", [A], {}, (0,)),
        ("meshgrid", [v[:2], v], {}, (0, 1)),
        ("assign", [A], {}, (0,)), ("clone", [A], {}, (0,)),
        ("tril_indices", [4, 3, 1], {}, ()),
        ("triu_indices", [3], {}, ()),
        ("complex_", [v, v[::-1].copy()], {}, ()),
    ]


def search_cases():
    r = rng_for("search")
    A = r.standard_normal((3, 5)).astype(np.float32)
    ties = np.array([[3, 1, 3, 2, 1], [2, 2, 2, 0, 5]], np.float32)
    seq = np.sort(r.standard_normal((3, 6)).astype(np.float32), axis=1)
    return [
        ("argmax", [A], {"axis": 1}, ()), ("argmin", [ties], {}, ()),
        ("argsort", [ties], {"axis": 1}, ()),
        ("argsort", [ties], {"descending": True}, ()),
        ("sort", [A], {"axis": 0}, (0,)),
        ("sort", [ties], {"descending": True}, (0,)),
        ("topk", [A, 2], {}, (0,)), ("topk", [ties, 3], {}, (0,)),
        ("topk", [ties, 2], {"largest": False}, (0,)),
        ("kthvalue", [A, 2], {"axis": 1}, (0,)),
        ("kthvalue", [ties, 3], {"keepdim": True}, (0,)),
        ("mode", [ties], {}, ()),
        ("index_sample", [A, np.array([[0, 4], [1, 1], [3, 2]], np.int32)],
         {}, (0,)),
        ("searchsorted", [seq, A[:, :4].copy()], {}, ()),
        ("searchsorted", [seq[0], A[0]], {"right": True}, ()),
        ("bucketize", [A, seq[0]], {}, ()),
    ]


def math_extra_cases():
    r = rng_for("math_extra")
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    pos = lambda *s: r.uniform(0.5, 2.0, s).astype(np.float32)  # noqa
    A, B, P = f(3, 4), f(3, 4), pos(3, 4)
    v = f(5)
    lu = np.array([[4.0, 3.0, 2.0], [0.5, 1.5, 0.5], [0.25, 0.5, 2.0]],
                  np.float32)
    piv = np.array([2, 3, 3], np.int32)
    g = (0,)
    return [
        ("frexp", [A * 10], {}, ()), ("ldexp", [A, np.array(
            [[1, 2, -1, 0]] * 3, np.int32)], {}, g),
        ("renorm", [A, 2.0, 0, 1.5], {}, g),
        ("trapezoid", [A], {"dx": 0.5}, g),
        ("trapezoid", [A, np.cumsum(P, 1)], {"axis": 1}, g),
        ("cumulative_trapezoid", [A], {"axis": 1}, g),
        ("vander", [v[:4]], {"n": 3}, g),
        ("nanmedian", [np.where(A > 1.0, np.nan, A)], {"axis": 1}, g),
        ("nanquantile", [np.where(A > 1.0, np.nan, A), 0.25], {"axis": 1},
         g),
        ("cartesian_prod", [[v[:2], v[2:5]]], {}, g),
        ("combinations", [v[:4]], {"r": 2}, g),
        ("index_fill", [A, np.array([0, 2], np.int32), 1, 9.0], {}, g),
        ("masked_scatter", [A, A > 0, f(12)], {}, (0, 2)),
        ("diag_embed", [f(2, 3)], {"offset": 1}, g),
        ("diag_embed", [f(2, 3)], {"dim1": 0, "dim2": 2}, g),
        ("unflatten", [f(2, 6), 1, [2, 3]], {}, g),
        ("view_as", [A, f(4, 3)], {}, g),
        ("as_strided", [f(4, 4), [3, 2], [4, 1], 1], {}, g),
        ("bincount", [np.array([0, 3, 1, 3, 3], np.int32)], {}, ()),
        ("bincount", [np.array([0, 2, 2], np.int32)],
         {"weights": np.array([0.5, 1.0, 2.0], np.float32),
          "minlength": 5}, ()),
        ("lu_unpack", [lu, piv], {}, g),
        ("cdist", [f(2, 3, 4), f(2, 5, 4)], {}, (0, 1)),
        ("cdist", [f(3, 4), f(2, 4)], {"p": 1.0}, (0, 1)),
        ("pairwise_distance", [A, B], {}, (0, 1)),
        ("complex", [A, B], {}, ()),
        ("polar", [P, A], {}, ()),
        ("take", [A, np.array([[0, 5], [11, -1]], np.int32)], {}, g),
        ("take", [A, np.array([13, -14], np.int32)], {"mode": "wrap"}, g),
        ("logit", [np.clip(P / 2.5, 0.05, 0.95)], {}, g),
        ("logit", [P / 2.5], {"eps": 0.1}, g),
        ("polygamma", [P, 1], {}, g), ("i0", [A], {}, g),
        ("i0e", [A], {}, g), ("i1", [A], {}, g), ("i1e", [A], {}, g),
        ("digitize", [A, np.array([-1.0, 0.0, 0.5, 2.0], np.float32)], {},
         ()),
        ("digitize", [np.array([0.0, 0.5, 1.0], np.float32),
                      np.array([0.0, 0.5, 1.0], np.float32)],
         {"right": True}, ()),
        ("tensordot", [f(2, 3, 4), f(3, 4, 5)], {"axes": 2}, (0, 1)),
        ("tensordot", [A, f(4, 3)], {"axes": [[1], [0]]}, (0, 1)),
        ("tensor_split", [f(7, 2), 3], {}, g),
        ("tensor_split", [f(7, 2), [2, 5]], {}, g),
        ("hsplit", [f(2, 6), 3], {}, g), ("vsplit", [f(6, 2), [1, 4]], {},
                                           g),
        ("dsplit", [f(2, 2, 4), 2], {}, g),
        ("atleast_1d", [np.float32(3.0)], {}, ()),
        ("atleast_2d", [v], {}, g),
        ("atleast_3d", [A], {}, g),
        ("block_diag", [[A[:2, :2].copy(), B[:1].copy()]], {}, g),
        ("float_power", [P, A], {}, (0, 1)),
        ("addcmul", [A, B, P], {"value": 0.5}, (0, 1, 2)),
        ("addcdiv", [A, B, P], {"value": 2.0}, (0, 1, 2)),
        ("bitwise_left_shift", [np.array([1, -3, 7], np.int32),
                                np.array([2, 1, 0], np.int32)], {}, ()),
        ("bitwise_right_shift", [np.array([16, -8, 7], np.int32),
                                 np.array([2, 1, 3], np.int32)], {}, ()),
        ("is_complex", [A], {}, ()), ("is_floating_point", [A], {}, ()),
        ("rank", [A], {}, ()),
    ]


N = 20000
P_IN = np.full((N,), 0.3, np.float32)
LAM = np.full((N,), 3.0, np.float32)
ALPHA = np.full((N,), 0.7, np.float32)


# (name, args, kwargs, mean, var) per draw; None skips the moment check
RANDOM = [
    ("uniform", [[N]], {"min": -1.0, "max": 3.0}, 1.0, 16 / 12),
    ("normal", [], {"mean": 2.0, "std": 0.5, "shape": [N]}, 2.0, 0.25),
    ("randn", [[N]], {}, 0.0, 1.0),
    ("rand", [[N]], {}, 0.5, 1 / 12),
    ("randint", [2, 10, [N]], {}, 5.5, (8 ** 2 - 1) / 12),
    ("randint_like", [np.zeros(N, np.int32), 0, 4], {}, 1.5, 15 / 12),
    ("randperm", [N], {}, (N - 1) / 2, (N ** 2 - 1) / 12),
    ("shuffle", [np.arange(N, dtype=np.float32)], {}, (N - 1) / 2,
     (N ** 2 - 1) / 12),
    ("bernoulli", [P_IN], {}, 0.3, 0.21),
    ("multinomial", [np.array([0.2, 0.3, 0.5], np.float32), N],
     {"replacement": True}, 1.3, 0.61),
    ("poisson", [LAM], {}, 3.0, 3.0),
    ("exponential", [LAM], {"lam": 2.0}, 0.5, 0.25),
    ("standard_gamma", [ALPHA], {}, 0.7, 0.7),
    ("normal_like", [np.zeros(N, np.float32)], {"mean": -1.0, "std": 2.0},
     -1.0, 4.0),
    ("uniform_like", [np.zeros(N, np.float32)], {"min": 0.0, "max": 2.0},
     1.0, 1 / 3),
    ("rand_like", [np.zeros(N, np.float32)], {}, 0.5, 1 / 12),
    ("gumbel", [[N]], {}, 0.5772156649, np.pi ** 2 / 6),
    ("binomial", [np.full(N, 10, np.int32), np.full(N, 0.4, np.float32)],
     {}, 4.0, 2.4),
    ("lognormal", [], {"mean": 0.0, "std": 0.5, "shape": [N]},
     np.exp(0.125), (np.exp(0.25) - 1) * np.exp(0.25)),
    ("standard_normal", [[N]], {}, 0.0, 1.0),
]


def all_cases():
    """Every non-random case, as ``(module, case)`` pairs."""
    return ([("math", c) for c in math_cases()]
            + [("manipulation", c) for c in manipulation_cases()]
            + [("creation", c) for c in creation_cases()]
            + [("search", c) for c in search_cases()]
            + [("math_extra", c) for c in math_extra_cases()])


# -- the rest of the op library (linalg, fft, sequence, the CRF / segment,
# detection, loss, metric and CTR tails) ---------------------------------------

# ops whose factors are defined only up to sign or phase: compared by
# property (``property_residual``), never entry by entry
PROPERTY_OPS = frozenset({"svd", "qr", "eig", "eigh", "eigvals"})
# ops whose results are host numpy in both packages (no device work)
HOST_OPS = frozenset({
    "rpn_target_assign", "distribute_fpn_proposals", "collect_fpn_proposals",
    "mine_hard_examples", "locality_aware_nms", "retinanet_target_assign",
    "retinanet_detection_output", "generate_proposal_labels",
    "generate_mask_labels", "chunk_eval", "detection_map",
    "positive_negative_pair", "filter_by_instag", "tdm_sampler",
    "similarity_focus", "sequence_unpad"})
# random ops of the tail, held to statistics (tests/test_torch_loss_
# metric_ctr.py, chip_smoke's sweep), not to values
TAIL_RANDOM = frozenset({"sample_logits", "nce", "sampling_id",
                         "random_crop"})


def _spd(r, n, batch=()):
    a = r.standard_normal(tuple(batch) + (n, n)).astype(np.float32)
    return (a @ np.swapaxes(a, -1, -2) / n
            + np.eye(n, dtype=np.float32)).astype(np.float32)


def linalg_cases():
    f, pos, unit, ints = _arrays("linalg")
    r = rng_for("linalg/spd")
    A, B = f(3, 4), f(3, 4)
    S = _spd(r, 4)
    Q = f(4, 4) + 4 * np.eye(4, dtype=np.float32)
    L = np.linalg.cholesky(S).astype(np.float32)
    U = np.triu(Q).astype(np.float32)
    R2 = f(4, 2)
    low = (f(5, 2) @ f(2, 4)).astype(np.float32)
    g = (0,)
    return [
        ("norm", [A], {}, g), ("norm", [A], {"p": 1, "axis": 1}, g),
        ("norm", [A], {"p": "fro", "axis": [0, 1]}, g),
        ("norm", [A], {"p": "nuc", "axis": [0, 1]}, g),
        ("norm", [A], {"p": np.inf}, ()),
        ("norm", [A], {"p": 2, "axis": [0, 1], "keepdim": True}, g),
        ("vector_norm", [A], {"p": 3, "axis": 1}, g),
        ("matrix_norm", [A], {}, g), ("matrix_norm", [A], {"p": 1}, g),
        ("dist", [A, B], {"p": 2}, (0, 1)), ("dist", [A, B], {"p": 1}, ()),
        ("cholesky", [S], {}, g), ("cholesky", [S], {"upper": True}, g),
        ("cholesky_solve", [R2, L], {}, (0, 1)),
        ("svd", [A], {}, ()), ("qr", [f(4, 3)], {}, ()),
        ("lu", [Q], {}, ()),
        ("inverse", [Q], {}, g), ("inv", [Q], {}, g),
        ("pinv", [A], {}, g),
        ("solve", [Q, R2], {}, (0, 1)), ("solve", [Q, R2[:, 0].copy()], {},
                                         (0, 1)),
        ("triangular_solve", [U, R2], {}, (0, 1)),
        ("triangular_solve", [U, R2], {"transpose": True}, (0, 1)),
        ("triangular_solve", [np.tril(Q).astype(np.float32), R2],
         {"upper": False, "unitriangular": True}, (0, 1)),
        ("lstsq", [f(5, 3), f(5, 2)], {}, (0, 1)),
        ("eig", [Q], {}, ()), ("eigh", [S], {}, ()),
        ("eigvals", [Q], {}, ()), ("eigvalsh", [S], {}, g),
        ("matrix_power", [Q, 3], {}, g), ("matrix_power", [Q, -2], {}, g),
        ("matrix_rank", [low], {}, ()),
        ("matrix_rank", [low], {"tol": 0.5}, ()),
        ("det", [Q], {}, g), ("slogdet", [Q], {}, g),
        ("multi_dot", [[A, B.T.copy(), A]], {}, g),
        ("einsum", ["ij,kj->ik", A, B], {}, (1, 2)),
        ("cov", [A], {}, g), ("cov", [A], {"rowvar": False, "ddof": False},
                              g),
        ("corrcoef", [A], {}, g),
        ("householder_product", [f(4, 3), unit(3)], {}, (0, 1)),
    ]


def fft_cases():
    f, pos, unit, ints = _arrays("fft")
    A, T = f(3, 8), f(2, 4, 6)
    C = (f(3, 5) + 1j * f(3, 5)).astype(np.complex64)
    C2 = (f(4, 5) + 1j * f(4, 5)).astype(np.complex64)
    g = (0,)
    return [
        ("fft", [A], {}, ()), ("ifft", [C], {"norm": "ortho"}, ()),
        ("rfft", [A], {}, ()), ("rfft", [A], {"n": 6, "norm": "forward"}, ()),
        ("irfft", [C], {}, ()), ("irfft", [C], {"n": 9}, ()),
        ("hfft", [C], {}, ()), ("ihfft", [A], {}, ()),
        ("fft2", [T], {}, ()), ("ifft2", [T], {"norm": "ortho"}, ()),
        ("rfft2", [T], {}, ()), ("irfft2", [C2], {}, ()),
        ("fftn", [T], {"axes": [0, 2]}, ()), ("ifftn", [T], {}, ()),
        ("fftshift", [A], {}, g), ("ifftshift", [T], {"axes": [1]}, g),
        ("fftfreq", [8], {"d": 0.5}, ()),
        ("rfftfreq", [9, 0.1], {}, ()),
        ("fftfreq", [5], {"dtype": "float32"}, ()),
    ]


def sequence_cases():
    f, pos, unit, ints = _arrays("sequence")
    X, X2 = f(3, 5, 2), f(3, 4, 2)
    L, L2 = np.array([5, 2, 0], np.int32), np.array([1, 4, 3], np.int32)
    Xi = ints(0, 4, 3, 5)
    g = (0,)
    pools = [("sequence_pool", [X, L, t], {}, g)
             for t in ("sum", "mean", "sqrt", "max", "min", "first",
                       "last")]
    return pools + [
        ("sequence_pad", [X, L], {"pad_value": -1.0}, g),
        ("sequence_pad", [X, L], {"padded_length": 7}, g),
        ("sequence_first_step", [X, L], {}, g),
        ("sequence_last_step", [X, L], {}, g),
        ("sequence_softmax", [f(3, 5), L], {}, g),
        ("sequence_reverse", [X, L], {}, g),
        ("sequence_slice", [X, L, np.array([1, 0, 0], np.int32), 3], {}, g),
        ("sequence_expand", [f(3, 2), np.array([2, 0, 3], np.int32)], {},
         g),
        ("sequence_expand_as", [f(3, 2), np.array([1, 3, 2], np.int32)],
         {"max_ref": 4}, g),
        ("sequence_enumerate", [Xi, L, 2], {"pad_value": -1}, ()),
        ("sequence_erase", [Xi, L, [1, 3]], {}, ()),
        ("sequence_concat", [[X, X2], [L, L2]], {}, g),
        ("sequence_unpad", [X, L], {}, ()),
        ("sequence_conv", [X, L, f(6, 4), 3], {}, (0, 2)),
        ("sequence_conv", [X, L, f(6, 4), 3],
         {"context_start": -2, "padding_trainable": True,
          "padding_data": f(2, 2)}, (0, 2)),
        ("sequence_reshape", [f(3, 4, 2), L2, 4], {}, g),
        ("sequence_scatter", [f(3, 6), ints(0, 6, 3, 4), f(3, 4), L2[:] - 1],
         {}, (0, 2)),
    ]


def decode_extra_cases():
    f, pos, unit, ints = _arrays("decode_extra")
    A = f(3, 4)
    em, tr = f(3, 5, 4), f(6, 4)
    lab, ln = ints(0, 4, 3, 5), np.array([5, 2, 3], np.int32)
    seg = np.array([0, 0, 1, 3, 3, 3], np.int32)
    x6 = f(6, 3)
    g = (0,)
    return [
        ("linear_chain_crf", [em, tr, lab, ln], {}, (0, 1)),
        ("linear_chain_crf", [em, tr, lab], {}, (0, 1)),
        ("crf_decoding", [em, tr, ln], {}, ()),
        ("crf_decoding", [em, tr], {}, ()),
        ("segment_sum", [x6, seg, 4], {}, g),
        ("segment_mean", [x6, seg, 4], {}, g),
        ("segment_max", [x6, seg, 4], {}, g),
        ("segment_min", [x6, seg, 4], {}, g),
        ("segment_pool", [x6, seg, "MEAN", 4], {}, g),
        ("multiplex", [[A, f(3, 4)], np.array([[1], [0], [1]], np.int32)],
         {}, g),
        ("mv", [A, f(4)], {}, (0, 1)),
        ("increment", [f(1)], {"value": 2.5}, g),
        ("p_norm", [A], {"p": 3.0, "axis": 1}, g),
        ("p_norm", [A], {"p": float("inf"), "axis": 0}, g),
        ("p_norm", [A], {"p": 0, "keepdim": True}, ()),
        ("frobenius_norm", [A], {"axis": [0, 1]}, g),
        ("mul", [f(2, 3, 4), f(4, 5)], {"x_num_col_dims": 2}, (0, 1)),
    ]


def _boxes(r, n, scale=1.0):
    xy = r.uniform(0.0, 0.7, (n, 2))
    wh = r.uniform(0.05, 0.3, (n, 2))
    return (np.concatenate([xy, xy + wh], 1) * scale).astype(np.float32)


def detection_cases():
    f, pos, unit, ints = _arrays("detection")
    r = rng_for("detection/boxes")
    b8, b3 = _boxes(r, 8), _boxes(r, 3)
    s8 = r.uniform(0.0, 1.0, 8).astype(np.float32)
    s38 = r.uniform(0.0, 1.0, (3, 8)).astype(np.float32)
    var = np.array([0.1, 0.1, 0.2, 0.2], np.float32)
    img = f(2, 8, 8)
    rois = np.array([[0.5, 1.0, 6.0, 5.5], [2.0, 2.0, 7.5, 7.0],
                     [-0.5, 0.0, 3.0, 2.0]], np.float32)
    anchors = _boxes(r, 20, 32.0)
    gts = _boxes(r, 3, 32.0)
    g = (0,)
    return [
        ("box_area", [b8], {}, g),
        ("iou_similarity", [b8, b3], {}, (0, 1)),
        ("iou_similarity", [b8 * 10, b3 * 10], {"box_normalized": False}, ()),
        ("box_clip", [b8 * 20, np.array([10.0, 12.0], np.float32)], {}, g),
        ("box_coder", [b8, var, b3], {}, (0, 2)),
        ("box_coder", [b8, var, f(8, 4) * 0.1], {"code_type": "decode"},
         (0, 2)),
        ("box_coder", [b8, None, f(2, 8, 4) * 0.1],
         {"code_type": "decode", "box_normalized": False}, ()),
        ("box_coder", [b3, np.tile(var, (3, 1)), f(3, 2, 4) * 0.1],
         {"code_type": "decode", "axis": 1}, ()),
        ("prior_box", [4, 4, 32, 32, [8.0, 16.0]],
         {"max_sizes": [12.0, 24.0], "aspect_ratios": [2.0, 3.0],
          "clip": True}, ()),
        ("prior_box", [3, 5, 30, 50, [10.0]],
         {"max_sizes": [20.0], "aspect_ratios": [2.0],
          "min_max_aspect_ratios_order": True}, ()),
        ("anchor_generator", [4, 4, [16.0, 32.0], [0.5, 1.0, 2.0],
                              [8.0, 8.0]], {}, ()),
        ("nms", [b8, s8], {"iou_threshold": 0.3}, ()),
        ("nms", [b8, s8], {"iou_threshold": 0.7, "score_threshold": 0.2,
                           "max_out": 4, "eta": 0.9}, ()),
        ("multiclass_nms", [b8, s38], {"score_threshold": 0.1,
                                       "nms_top_k": 6, "keep_top_k": 10,
                                       "iou_threshold": 0.3,
                                       "background_label": 0}, ()),
        ("roi_align", [img, rois, 2], {"sampling_ratio": 2}, g),
        ("roi_align", [img, rois, [3, 2]], {"spatial_scale": 0.5,
                                             "aligned": True}, g),
        ("roi_pool", [img, rois, 2], {}, g),
        ("bipartite_match", [r.uniform(0, 1, (3, 5)).astype(np.float32)],
         {}, ()),
        ("bipartite_match", [r.uniform(0, 1, (3, 5)).astype(np.float32)],
         {"match_type": "per_prediction", "dist_threshold": 0.3}, ()),
        ("density_prior_box", [4, 4, 32, 32, [8.0, 16.0]],
         {"fixed_ratios": [1.0, 2.0], "densities": [2, 1],
          "flatten_to_2d": True}, ()),
        ("target_assign", [f(4, 4), np.array([[0, -1, 3, 1, -1],
                                              [2, 2, -1, 0, 3]], np.int32)],
         {"mismatch_value": 0.5}, ()),
        ("rpn_target_assign", [anchors, gts],
         {"im_height": 32, "im_width": 32, "rpn_batch_size_per_im": 8,
          "use_random": False, "rpn_positive_overlap": 0.5}, ()),
        ("generate_proposals", [s8 * 0 + r.uniform(0, 1, 8).astype(
            np.float32), f(8, 4) * 0.1, np.array([32.0, 32.0], np.float32),
            _boxes(r, 8, 32.0)], {"pre_nms_top_n": 6, "post_nms_top_n": 4,
                                  "min_size": 0.5}, ()),
        ("matrix_nms", [b8, s38], {"score_threshold": 0.1, "nms_top_k": 6,
                                   "keep_top_k": 8}, ()),
        ("distribute_fpn_proposals", [anchors * 8], {}, ()),
        ("collect_fpn_proposals", [[b8, b3], [s8, s8[:3].copy()], 5], {},
         ()),
        ("box_decoder_and_assign", [b8 * 30, var, f(8, 8) * 0.1,
                                    r.uniform(0, 1, (8, 2)).astype(
                                        np.float32)], {}, ()),
        ("mine_hard_examples", [pos(2, 6), np.array(
            [[0, -1, -1, 2, -1, -1], [-1, 1, -1, -1, -1, -1]], np.int32)],
         {"neg_pos_ratio": 2.0}, ()),
        ("polygon_box_transform", [f(1, 4, 3, 3)], {}, g),
        ("locality_aware_nms", [b8, s8], {"iou_threshold": 0.2}, ()),
        ("retinanet_target_assign", [anchors, gts,
                                     np.array([1, 3, 2], np.int32)], {}, ()),
        ("retinanet_detection_output", [[f(20, 4) * 0.1], [r.uniform(
            0, 1, (20, 3)).astype(np.float32)], [anchors]],
         {"score_threshold": 0.3, "keep_top_k": 6}, ()),
        ("generate_proposal_labels", [anchors, np.array([1, 2, 1], np.int32),
                                      gts], {"batch_size_per_im": 8,
                                             "use_random": False,
                                             "num_classes": 4}, ()),
        ("generate_mask_labels", [32, 32, np.array([1, 2], np.int32),
                                  [[2, 2, 12, 3, 10, 14], [16, 16, 28, 18,
                                                           22, 30]],
                                  np.array([[1, 1, 13, 15], [15, 15, 29, 31],
                                            [0, 0, 4, 4]], np.float32),
                                  np.array([1, 2, 0], np.int32)],
         {"num_classes": 3, "resolution": 4}, ()),
    ]


def loss_extra_cases():
    f, pos, unit, ints = _arrays("loss_extra")
    A, B = f(4, 3), f(4, 3)
    pm = np.where(f(4, 3) > 0, 1.0, -1.0).astype(np.float32)
    z01 = (f(4, 3) > 0).astype(np.float32)
    probs = r_probs = np.abs(unit(4, 5)) + 0.05
    r_probs = (r_probs / r_probs.sum(1, keepdims=True)).astype(np.float32)
    ts = np.array([[-2.0], [-1.0], [0.3], [1.6]], np.float32)
    g = (0,)
    return [
        ("hinge_loss", [A, pm], {}, g),
        ("huber_loss", [A, B], {"delta": 0.5}, g),
        ("huber_loss", [A, B], {"reduction": "none"}, g),
        ("modified_huber_loss", [A * 2, z01], {}, g),
        ("rank_loss", [z01, A, B], {}, (1, 2)),
        ("margin_rank_loss", [pm, A, B], {"margin": 0.2}, (1, 2)),
        ("bpr_loss", [f(3, 5), ints(0, 5, 3, 1)], {}, g),
        ("teacher_student_sigmoid_loss", [f(4, 1) * 3, ts], {}, g),
        ("squared_l2_distance", [A, B], {}, (0, 1)),
        ("squared_l2_norm", [A], {}, g), ("l1_norm", [A], {}, g),
        ("cos_sim", [A, B], {}, (0, 1)), ("cos_sim", [A, B[:1].copy()], {},
                                          (0, 1)),
        ("dice_loss", [r_probs, ints(0, 5, 4, 1)], {}, g),
        ("npair_loss", [A, B, np.array([0, 1, 0, 2], np.int32)], {},
         (0, 1)),
        ("center_loss", [A, np.array([0, 2, 0, 4], np.int32), f(5, 3)], {},
         (0, 2)),
        ("bce_loss", [probs[:, :3].clip(0.05, 0.95).astype(np.float32),
                      z01], {}, g),
        ("kldiv_loss", [np.log(r_probs), r_probs[::-1].copy()],
         {"reduction": "sum"}, g),
    ]


def metric_extra_cases():
    f, pos, unit, ints = _arrays("metric_extra")
    tags = ints(0, 5, 3, 7)
    return [
        ("edit_distance", [ints(0, 4, 3, 5), ints(0, 4, 3, 4),
                           np.array([5, 3, 0], np.int32),
                           np.array([4, 4, 2], np.int32)], {}, ()),
        ("edit_distance", [ints(0, 3, 2, 4), ints(0, 3, 2, 6)],
         {"normalized": False}, ()),
        ("ctc_align", [ints(0, 3, 3, 8), np.array([8, 5, 1], np.int32)], {},
         ()),
        ("ctc_align", [ints(0, 3, 2, 6), np.array([6, 4], np.int32)],
         {"blank": 2, "merge_repeated": False}, ()),
        ("mean_iou", [ints(0, 4, 12), ints(0, 4, 12), 4], {}, ()),
        ("precision_recall", [f(6, 3), ints(0, 3, 6), 3], {}, ()),
        ("precision_recall", [ints(0, 3, 6), ints(0, 3, 6), 3],
         {"weights": pos(6), "states": pos(3, 4)}, ()),
        ("chunk_eval", [tags, ints(0, 5, 3, 7), np.array([7, 4, 6],
                                                         np.int32)],
         {"chunk_scheme": "IOB", "num_chunk_types": 2}, ()),
        ("chunk_eval", [ints(0, 9, 2, 6), ints(0, 9, 2, 6),
                        np.array([6, 5], np.int32)],
         {"chunk_scheme": "IOBES", "num_chunk_types": 2}, ()),
        ("detection_map", [np.array([[0, 0.9, 0.1, 0.1, 0.4, 0.4],
                                     [0, 0.8, 0.5, 0.5, 0.9, 0.9],
                                     [1, 0.7, 0.1, 0.1, 0.3, 0.3],
                                     [1, 0.3, 0.6, 0.6, 0.7, 0.8]],
                                    np.float32),
                           np.array([[0.1, 0.1, 0.4, 0.5],
                                     [0.6, 0.6, 0.9, 0.9],
                                     [0.1, 0.1, 0.3, 0.3]], np.float32),
                           np.array([0, 0, 1], np.int32), 2], {}, ()),
        ("positive_negative_pair", [f(8), ints(0, 3, 8), ints(0, 2, 8)], {},
         ()),
    ]


def nlp_ctr_cases():
    f, pos, unit, ints = _arrays("nlp_ctr_extra")
    tree = np.array([[0, 0, 0, 1, 2], [10, 1, 0, 3, 4], [11, 1, 0, 0, 0],
                     [12, 2, 1, 0, 0], [13, 2, 1, 0, 0]], np.int32)
    ro = np.array([[0, 1, 0, 0, 1], [1, 0, 2, -1, 0], [-1, 0, 0, 1, 1]],
                  np.int32)
    g = (0,)
    return [
        ("sequence_topk_avg_pooling", [f(2, 2, 3, 5), np.array([3, 2],
                                                               np.int32),
                                       np.array([5, 2], np.int32), [1, 3],
                                       2], {}, g),
        ("match_matrix_tensor", [f(2, 3, 4), f(2, 5, 6), f(4, 2, 6)],
         {"x_lengths": np.array([3, 1], np.int32),
          "y_lengths": np.array([4, 5], np.int32)}, (0, 1, 2)),
        ("var_conv_2d", [f(2, 2, 5, 5), np.array([5, 3], np.int32),
                         np.array([4, 5], np.int32), f(3, 2, 3, 3), 2, 3, 3],
         {}, (0, 3)),
        ("var_conv_2d", [f(2, 2, 5, 5), np.array([5, 3], np.int32),
                         np.array([4, 5], np.int32), f(3, 2, 3, 3), 2, 3, 3],
         {"stride": 2}, (0, 3)),
        ("tree_conv", [f(2, 4, 3), np.array([[[0, 1], [0, 2], [1, 3]],
                                             [[0, 1], [0, 0], [0, 0]]],
                                            np.int32), f(3, 3, 5)],
         {"max_depth": 3}, (0, 2)),
        ("hash_ids", [ints(0, 10 ** 6, 4, 1)], {"num_hash": 2}, ()),
        ("pyramid_hash", [ints(0, 100, 2, 6), np.array([6, 4], np.int32),
                          f(50, 4), 8, 50], {"rand_len": 4}, (2,)),
        ("rank_attention", [f(3, 4), ro, f(2 * 2 * 4, 3), 2], {}, (0, 2)),
        ("filter_by_instag", [f(4, 3), [[1, 2], [3], [2, 5], [4]], [2, 4]],
         {}, ()),
        ("tdm_child", [np.array([0, 1, 2], np.int32), tree, 2], {}, ()),
        ("tdm_sampler", [np.array([0, 1], np.int32), [[1, 3], [2, 4]],
                         [[1, 2], [3, 4, 5, 6]], [1, 2]], {"seed": 3}, ()),
        ("similarity_focus", [f(1, 2, 3, 4), 1, [0, 1]], {}, ()),
        ("pad_constant_like", [f(3, 4), f(2, 3)], {"pad_value": 0.5}, (1,)),
    ]


TAIL_MODULES = ("linalg", "fft", "sequence", "decode_extra", "detection",
                "loss_extra", "metric_extra", "nlp_ctr_extra")


def tail_cases():
    """Every non-random case of the modules this sweep adds, as
    ``(module, case)`` pairs."""
    return ([("linalg", c) for c in linalg_cases()]
            + [("fft", c) for c in fft_cases()]
            + [("sequence", c) for c in sequence_cases()]
            + [("decode_extra", c) for c in decode_extra_cases()]
            + [("detection", c) for c in detection_cases()]
            + [("loss_extra", c) for c in loss_extra_cases()]
            + [("metric_extra", c) for c in metric_extra_cases()]
            + [("nlp_ctr_extra", c) for c in nlp_ctr_cases()])


def card_sized_cases():
    """Cases at the sizes real work gives these ops, for the card: a batch
    of 1024 x 1024 SPD matrices (Cholesky, solve), 16000-sample signals
    (rfft), a CRF over 128 x 64 steps of 57 tags, 8732-prior IoU."""
    r = rng_for("card_sized")
    spd = _spd(r, 1024, (4,))
    rhs = r.standard_normal((4, 1024, 64)).astype(np.float32)
    sig = r.standard_normal((64, 16000)).astype(np.float32)
    em = r.standard_normal((128, 64, 57)).astype(np.float32)
    tr = (0.1 * r.standard_normal((59, 57))).astype(np.float32)
    ln = r.integers(8, 65, 128).astype(np.int32)
    lab = r.integers(0, 57, (128, 64)).astype(np.int32)
    pri, gt = _boxes(r, 8732), _boxes(r, 64)
    return [
        ("linalg", ("cholesky", [spd], {}, (0,))),
        ("linalg", ("solve", [spd, rhs], {}, (0, 1))),
        ("fft", ("rfft", [sig], {}, ())),
        ("fft", ("irfft", [np.fft.rfft(sig).astype(np.complex64)], {}, ())),
        ("decode_extra", ("linear_chain_crf", [em, tr, lab, ln], {},
                          (0, 1))),
        ("decode_extra", ("crf_decoding", [em, tr, ln], {}, ())),
        ("detection", ("iou_similarity", [gt, pri], {}, ())),
    ]


def property_residual(name, args, outs):
    """How far an up-to-sign factorisation misses its defining property
    (numpy, float64): reconstruction and orthogonality for ``svd`` /
    ``qr`` / ``eigh``, ``A v - v w`` for ``eig``, and for ``eigvals`` the
    distance to ``numpy``'s eigenvalues after sorting. The largest
    residual over the checks, relative to ``|A|``."""
    a = np.asarray(args[0], np.float64)
    scale = max(np.abs(a).max(), 1.0)
    o = [np.asarray(x).astype(np.complex128 if np.iscomplexobj(x)
                              else np.float64) for x in outs]
    if name == "svd":
        u, s, vh = o
        res = [np.abs(u @ np.diag(s) @ vh - a).max(),
               np.abs(u.T @ u - np.eye(u.shape[1])).max() * scale,
               np.abs(vh @ vh.T - np.eye(vh.shape[0])).max() * scale,
               np.abs(s - np.linalg.svd(a, compute_uv=False)).max()]
    elif name == "qr":
        q, rr = o
        res = [np.abs(q @ rr - a).max(),
               np.abs(q.T @ q - np.eye(q.shape[1])).max() * scale,
               np.abs(np.tril(rr, -1)).max()]
    elif name == "eigh":
        w, v = o
        res = [np.abs(v @ np.diag(w) @ v.T - a).max(),
               np.abs(w - np.linalg.eigvalsh(a)).max()]
    elif name == "eig":
        w, v = o
        res = [np.abs(a @ v - v * w[None, :]).max()]
    else:
        w = np.sort_complex(o[0])
        res = [np.abs(w - np.sort_complex(np.linalg.eigvals(a))).max()]
    return float(max(res) / scale)
