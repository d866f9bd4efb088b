"""Linear algebra ops (port of ``paddle_tpu/ops/linalg.py``).

``torch.linalg`` computes them: LAPACK on the CPU, cuSOLVER / cuBLAS on
the card. The JAX package's conventions stay: ``lu`` gives 1-based int32
pivots, ``slogdet`` stacks ``[sign, logdet]``, ``lstsq`` returns
``(solution, residuals, rank, singular values)`` computed through an SVD
as ``jnp.linalg.lstsq`` computes them (on the card too, where
``torch.linalg.lstsq`` has only the ``gels`` driver and gives neither
rank nor singular values), ``pinv`` / ``matrix_rank`` take JAX's
tolerances, and ``cov``'s ``ddof=True`` means 1.

Factors that are defined only up to sign or phase (``svd``, ``eig``,
``eigh``, ``qr``) may differ between LAPACK, cuSOLVER and XLA; tests
compare reconstructions and orthogonality.
"""

from __future__ import annotations

import torch

from ._eager import axes, floating, tensor


def _f(x):
    return floating(tensor(x))


def norm(x, p="fro", axis=None, keepdim=False):
    x = _f(x)
    if p == "fro":
        if axis is None:
            return torch.sqrt(torch.sum(torch.square(x)))
        if isinstance(axis, (list, tuple)):
            return torch.linalg.matrix_norm(x, ord="fro", dim=tuple(axis),
                                            keepdim=keepdim)
        return torch.linalg.vector_norm(x, 2, dim=int(axis),
                                        keepdim=keepdim)
    if p == "nuc":
        return torch.linalg.matrix_norm(x, ord="nuc", dim=tuple(axis),
                                        keepdim=keepdim)
    if axis is None:
        out = torch.linalg.vector_norm(x.reshape(-1), p)
        return out.reshape(1) if keepdim else out
    return torch.linalg.norm(x, ord=p, dim=axes(axis), keepdim=keepdim)


def vector_norm(x, p=2, axis=None, keepdim=False):
    return torch.linalg.vector_norm(_f(x), p, dim=axes(axis),
                                    keepdim=keepdim)


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False):
    # the JAX function ignores ``axis``: the last two dims
    return torch.linalg.matrix_norm(_f(x), ord=p, keepdim=keepdim)


def dist(x, y, p=2):
    return torch.linalg.vector_norm((_f(x) - _f(y)).reshape(-1), p)


def cholesky(x, upper=False):
    lower = torch.linalg.cholesky(_f(x))
    return lower.transpose(-1, -2) if upper else lower


def cholesky_solve(x, y, upper=False):
    """``x`` solved against the Cholesky factor ``y``; only ``y``'s
    triangle is read (and differentiated), as ``cho_solve`` reads it."""
    y = _f(y)
    tri = torch.triu(y) if upper else torch.tril(y)
    return torch.cholesky_solve(_f(x), tri, upper=upper)


def svd(x, full_matrices=False):
    return torch.linalg.svd(_f(x), full_matrices=full_matrices)


def qr(x, mode="reduced"):
    q, r = torch.linalg.qr(_f(x), mode=mode)
    return r if mode == "r" else (q, r)


def lu(x):
    """``(LU, pivots)``: LAPACK's packed factors and its 1-based pivots
    as int32 (``jax.scipy.linalg.lu_factor``'s 0-based ones plus 1)."""
    lu_mat, piv = torch.linalg.lu_factor(_f(x))
    return lu_mat, piv.to(torch.int32)


def inverse(x):
    return torch.linalg.inv(_f(x))


inv = inverse


def pinv(x, rcond=1e-15, hermitian=False):
    return torch.linalg.pinv(_f(x), rtol=rcond, hermitian=hermitian)


def solve(x, y):
    """``jnp.linalg.solve``: ``y`` is a vector only when it is 1-D."""
    x, y = _f(x), _f(y)
    if y.dim() == 1:
        return torch.linalg.solve(x, y[:, None])[:, 0]
    return torch.linalg.solve(x, y)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False):
    x, y = _f(x), _f(y)
    if transpose:
        x, upper = x.transpose(-1, -2), not upper
    vec = y.dim() == 1
    out = torch.linalg.solve_triangular(x, y[:, None] if vec else y,
                                        upper=upper,
                                        unitriangular=unitriangular)
    return out[:, 0] if vec else out


def lstsq(x, y, rcond=None):
    """``jnp.linalg.lstsq`` on a 2-D ``x``: the SVD's pseudo-inverse with
    the singular values below ``rcond * s[0]`` dropped (``rcond``
    defaults to eps * max(m, n)); residuals are the squared column norms
    of ``y - x @ sol``, always returned; rank is int32."""
    x, y = _f(x), _f(y)
    vec = y.dim() == 1
    if vec:
        y = y[:, None]
    m, n = x.shape
    eps = torch.finfo(x.dtype).eps
    if rcond is None:
        rcond = eps * max(m, n)
    elif rcond < 0:
        rcond = eps
    u, s, vt = torch.linalg.svd(x, full_matrices=False)
    mask = (s > 0) & (s >= rcond * s[0])
    rank = mask.sum().to(torch.int32)
    safe = torch.where(mask, s, torch.ones_like(s))
    s_inv = torch.where(mask, 1.0 / safe, torch.zeros_like(s))[:, None]
    sol = vt.transpose(0, 1).conj() @ (s_inv * (u.transpose(0, 1).conj()
                                                @ y))
    resid = torch.linalg.vector_norm(y - x @ sol, dim=0) ** 2
    if vec:
        sol = sol.reshape(-1)
    return sol, resid, rank, s


def eig(x):
    return torch.linalg.eig(_f(x))


def eigh(x, UPLO="L"):  # noqa: N803 - reference name
    return torch.linalg.eigh(_f(x), UPLO=UPLO)


def eigvals(x):
    return torch.linalg.eigvals(_f(x))


def eigvalsh(x, UPLO="L"):  # noqa: N803 - reference name
    return torch.linalg.eigvalsh(_f(x), UPLO=UPLO)


def matrix_power(x, n):
    return torch.linalg.matrix_power(_f(x), int(n))


def matrix_rank(x, tol=None, hermitian=False):
    """``jnp.linalg.matrix_rank``: the count of singular values above
    ``tol``, which JAX compares as an absolute bound; without it, above
    ``s.max() * max(m, n) * eps``. int32."""
    x = _f(x)
    if x.dim() < 2:
        return (x != 0).any().to(torch.int32)
    s = torch.linalg.svdvals(x)
    if tol is None:
        bound = s.max(-1).values * max(x.shape[-2:]) * \
            torch.finfo(s.dtype).eps
        bound = bound[..., None]
    else:
        bound = torch.as_tensor(tol, dtype=s.dtype, device=s.device)
        bound = bound[..., None] if bound.dim() else bound
    return (s > bound).sum(-1).to(torch.int32)


def det(x):
    return torch.linalg.det(_f(x))


def slogdet(x):
    sign, logdet = torch.linalg.slogdet(_f(x))
    return torch.stack([sign, logdet])


def multi_dot(xs):
    return torch.linalg.multi_dot([_f(t) for t in xs])


def einsum(equation, *operands):
    return torch.einsum(equation, *operands)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None):
    x = _f(x)
    if not rowvar and x.dim() > 1:
        x = x.transpose(0, 1)
    fw = None if fweights is None else tensor(fweights, x.device).long()
    aw = None if aweights is None else _f(tensor(aweights, x.device))
    return torch.cov(x, correction=1 if ddof else 0, fweights=fw,
                     aweights=aw)


def corrcoef(x, rowvar=True):
    x = _f(x)
    if not rowvar and x.dim() > 1:
        x = x.transpose(0, 1)
    return torch.corrcoef(x)


def householder_product(x, tau):
    """The first ``n`` columns of ``H_1 ... H_n``, ``H_i = I - tau_i v_i
    v_i^T`` with ``v_i`` one at ``i`` and ``x[i+1:, i]`` below (LAPACK
    ``orgqr``), batched over leading dims."""
    return torch.linalg.householder_product(_f(x), _f(tau))
