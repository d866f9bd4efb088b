"""The eager op sweep: seeded numpy inputs for every op of the six eager
modules (``ops/creation.py``, ``math.py``, ``manipulation.py``,
``search.py``, ``random.py``, ``math_extra.py``).

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
