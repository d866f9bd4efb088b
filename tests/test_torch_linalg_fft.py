"""``ops/linalg.py`` / ``paddle.linalg`` and ``ops/fft.py`` /
``paddle.fft`` of the port against the JAX package.

Every op of both modules through both packages' public wrappers on the
same seeded numpy inputs (``tools/eager_sweep.py``): values and dtypes
within ``_torch_tail_parity.LOOSE``'s relative limit (1e-5 for the
LAPACK-backed and FFT ops, exact elsewhere) and the gradient of ``sum(out
* w)`` within 10x that. ``svd``, ``qr``, ``eig``, ``eigh`` and
``eigvals`` are held by their property in each package (reconstruction
and orthogonality within 1e-5 of ``|A|``), since their factors are
defined only up to sign or phase.
"""

import _torch_threads  # noqa: F401

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from _torch_eager_parity import covered, on_cpu, registry_names
from _torch_tail_parity import tail_parity
from paddle_tpu_torch.tools.eager_sweep import fft_cases, linalg_cases

_cpu = pytest.fixture(autouse=True, scope="module")(on_cpu)

LINALG, FFT = linalg_cases(), fft_cases()


@pytest.mark.parametrize("case", LINALG, ids=[c[0] for c in LINALG])
def test_linalg_op_matches_jax(case):
    tail_parity(case)


@pytest.mark.parametrize("case", FFT, ids=[c[0] for c in FFT])
def test_fft_op_matches_jax(case):
    tail_parity(case)


@pytest.mark.parametrize("module,cases", [("linalg", LINALG),
                                          ("fft", FFT)])
def test_every_op_is_covered_and_registered_as_in_jax(module, cases):
    jnames, tnames = registry_names(module)
    assert tnames == jnames
    assert covered(cases) == set(jnames)


def test_namespaces_list_the_jax_names():
    import paddle_tpu.fft as jfft
    import paddle_tpu.linalg as jlinalg
    assert paddle.linalg.__all__ == sorted(jlinalg.__all__)
    assert paddle.fft.__all__ == sorted(jfft.__all__)
    x = np.array([[2.0, 1.0], [1.0, 3.0]], np.float32)
    got = paddle.linalg.cdist(paddle.to_tensor(x), paddle.to_tensor(x))
    want = pt.linalg.cdist(pt.to_tensor(x), pt.to_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               rtol=1e-6)


def test_jax_conventions_are_kept():
    """1-based int32 pivots, slogdet stacked, lstsq's four outputs with an
    int32 rank, matrix_rank's absolute tol, cov's ddof=True as 1."""
    a = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    lu, piv = paddle.linalg.lu(paddle.to_tensor(a))
    assert piv.dtype == paddle.int32 and piv.numpy().tolist() == [2, 2]
    sd = paddle.linalg.slogdet(paddle.to_tensor(a)).numpy()
    np.testing.assert_allclose(sd, [-1.0, np.log(2.0)], rtol=1e-6)
    sol, res, rank, sv = paddle.linalg.lstsq(
        paddle.to_tensor(np.ones((3, 2), np.float32)),
        paddle.to_tensor(np.arange(3, dtype=np.float32)))
    assert rank.dtype == paddle.int32 and int(rank) == 1
    assert tuple(sol.shape) == (2,) and tuple(sv.shape) == (2,)
    assert int(paddle.linalg.matrix_rank(paddle.to_tensor(a),
                                         tol=5.0)) == 1
    c = paddle.linalg.cov(paddle.to_tensor(a), ddof=True).numpy()
    np.testing.assert_allclose(c, np.cov(a, ddof=1), rtol=1e-6)


def test_lstsq_rank_deficient_and_rcond_match_jax():
    r = np.random.default_rng(3)
    a = (r.standard_normal((6, 2)) @ r.standard_normal((2, 4))).astype(
        np.float32)
    b = r.standard_normal((6, 3)).astype(np.float32)
    for rcond in (None, 1e-3):
        j = pt.linalg.lstsq(pt.to_tensor(a), pt.to_tensor(b), rcond=rcond)
        t = paddle.linalg.lstsq(paddle.to_tensor(a), paddle.to_tensor(b),
                                rcond=rcond)
        assert int(t[2]) == int(np.asarray(j[2].numpy())) == 2
        for x, y in zip(t, j):
            np.testing.assert_allclose(x.numpy(), np.asarray(y.numpy()),
                                       rtol=1e-4, atol=1e-5)


def test_fftfreq_dtype_and_complex64_outputs():
    f = paddle.fft.fftfreq(6, d=0.25, dtype="float64")
    assert f.dtype == paddle.float32
    np.testing.assert_allclose(f.numpy(), np.fft.fftfreq(6, 0.25),
                               rtol=1e-6)
    y = paddle.fft.fft(paddle.to_tensor(np.arange(4, dtype=np.float32)))
    assert y.dtype == paddle.complex64
    z = paddle.fft.fft(paddle.to_tensor(np.arange(4, dtype=np.int32)))
    np.testing.assert_allclose(z.numpy(), np.fft.fft(np.arange(4)),
                               atol=1e-5)
