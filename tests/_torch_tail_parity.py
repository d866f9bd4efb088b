"""The tail modules' sweep cases (``tools/eager_sweep.py``: linalg, fft,
sequence, the CRF / segment ops, detection, the loss, metric and CTR
tails) through both packages' public wrappers on the same seeded numpy
inputs, with the tolerance stated per op.

Factorisations defined up to sign or phase (``PROPERTY_OPS``) are held by
their defining property in each package (reconstruction, orthogonality,
the spectrum against numpy's); host-side ops return numpy in both
packages and are compared as such.
"""

import numpy as np

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from _torch_eager_parity import _jax_arg, _port_arg, assert_parity
from paddle_tpu import dispatch as jdispatch
from paddle_tpu_torch import dispatch as tdispatch
from paddle_tpu_torch.framework.ragged import RaggedTensor
from paddle_tpu_torch.tools.eager_sweep import (HOST_OPS, PROPERTY_OPS,
                                                property_residual)

# float32 limits: the LAPACK-backed and summed ops differ from XLA's by
# rounding; everything else is held to 1e-6 relative
LOOSE = {"pinv": 1e-4, "lstsq": 1e-4, "inverse": 1e-5, "inv": 1e-5,
         "solve": 1e-5, "cholesky_solve": 1e-5, "triangular_solve": 1e-5,
         "matrix_power": 1e-5, "det": 1e-5, "slogdet": 1e-5,
         "householder_product": 1e-5, "norm": 1e-5, "matrix_norm": 1e-5,
         "cholesky": 1e-5, "eigvalsh": 1e-5, "lu": 1e-5, "cov": 1e-5,
         "corrcoef": 1e-5, "multi_dot": 1e-5, "einsum": 1e-5,
         "fft": 1e-5, "ifft": 1e-5, "rfft": 1e-5, "irfft": 1e-5,
         "hfft": 1e-5, "ihfft": 1e-5, "fft2": 1e-5, "ifft2": 1e-5,
         "rfft2": 1e-5, "irfft2": 1e-5, "fftn": 1e-5, "ifftn": 1e-5,
         "linear_chain_crf": 1e-5, "sequence_conv": 1e-5,
         "roi_align": 1e-5, "match_matrix_tensor": 1e-5,
         "var_conv_2d": 1e-5, "tree_conv": 1e-5, "rank_attention": 1e-5,
         "npair_loss": 1e-5, "dice_loss": 1e-5, "edit_distance": 0,
         "sequence_topk_avg_pooling": 1e-5, "pyramid_hash": 1e-5,
         "precision_recall": 1e-6, "box_decoder_and_assign": 1e-6,
         "retinanet_detection_output": 1e-6, "cos_sim": 1e-6,
         "kldiv_loss": 1e-6, "p_norm": 1e-6, "vector_norm": 1e-6,
         "dist": 1e-6, "mv": 1e-6, "mul": 1e-6, "segment_mean": 1e-6,
         "frobenius_norm": 1e-6, "squared_l2_norm": 1e-6, "l1_norm": 1e-6,
         "squared_l2_distance": 1e-6,
         # exp / log round differently in XLA and torch (an ulp)
         "box_coder": 1e-6, "generate_proposals": 1e-6,
         "rpn_target_assign": 1e-6, "retinanet_target_assign": 1e-6,
         "generate_proposal_labels": 1e-6}
PROPERTY_TOL = 1e-5


def _call(pkg, name, args, kwargs):
    if pkg == "jax":
        return jdispatch.wrapped_ops[name](
            *[_jax_arg(a, False) for a in args], **kwargs)
    return tdispatch.wrapped_ops[name](*[_port_arg(a, False) for a in args],
                                       **kwargs)


def _np(t):
    if isinstance(t, (pt.Tensor, paddle.Tensor)):
        return np.asarray(t.numpy())
    return t


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _flat(o)]
    if isinstance(out, RaggedTensor) or type(out).__name__ == \
            "RaggedTensor":
        return [np.asarray(out.values), np.asarray(out.row_splits)]
    return [_np(out)]


def tail_parity(case, default_tol=None):
    """One sweep case in both packages; ``default_tol`` is the relative
    limit of the ops ``LOOSE`` does not name (None: exact)."""
    name, args, kwargs, grad = case
    if name in PROPERTY_OPS:
        for pkg in ("jax", "port"):
            outs = _flat(_call(pkg, name, args, kwargs))
            res = property_residual(name, args, outs)
            assert res <= PROPERTY_TOL, (pkg, name, res)
        return
    if name not in HOST_OPS:
        tol = LOOSE.get(name, default_tol)
        assert_parity(name, args, kwargs, grad, exact=tol is None,
                      rtol=tol or 0, atol=(tol or 0) and 1e-6,
                      grad_rtol=(tol or 1e-6) * 10, grad_atol=1e-5)
        return
    # host-side ops: numpy in JAX, wrapped in each package's Tensor; the
    # port's carry the x32 dtypes (int64 -> int32, float64 -> float32)
    jout, tout = _call("jax", name, args, kwargs), _call("port", name,
                                                          args, kwargs)
    ja, ta = _flat(jout), _flat(tout)
    assert len(ja) == len(ta), (name, len(ja), len(ta))
    tol = LOOSE.get(name, default_tol or 0)
    for k, (a, b) in enumerate(zip(ja, ta)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (name, k, a.shape, b.shape)
        assert b.dtype in (a.dtype, _X32.get(a.dtype)), (name, k, a.dtype,
                                                         b.dtype)
        if tol and np.issubdtype(a.dtype, np.inexact):
            np.testing.assert_allclose(b, a, rtol=tol, atol=1e-6,
                                       err_msg=f"{name}[{k}]")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{name}[{k}]")


_X32 = {np.dtype(np.int64): np.dtype(np.int32),
        np.dtype(np.float64): np.dtype(np.float32)}
