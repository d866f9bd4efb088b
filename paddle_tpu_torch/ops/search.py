"""Search and sort ops (port of ``paddle_tpu/ops/search.py``).

Sorts are stable, as ``jnp.sort`` / ``jnp.argsort``: ties keep their
order (a descending ``sort`` is the reverse of the ascending one, as in
JAX), and ``topk`` / ``kthvalue`` take the lower index of a tie first
(``lax.top_k``), from a stable sort rather than ``torch.topk``, whose
tie order is unspecified. NaN sorts last ascending and first
descending in both. Index outputs are int32.
"""

from __future__ import annotations

import torch

from ..core.dtype import convert_dtype
from ._eager import long, tensor


def argmax(x, axis=None, keepdim=False, dtype="int64"):
    if axis is None:
        out = torch.argmax(x.reshape(-1))
    else:
        out = torch.argmax(x, dim=int(axis), keepdim=keepdim)
    return out.to(convert_dtype(dtype))


def argmin(x, axis=None, keepdim=False, dtype="int64"):
    if axis is None:
        out = torch.argmin(x.reshape(-1))
    else:
        out = torch.argmin(x, dim=int(axis), keepdim=keepdim)
    return out.to(convert_dtype(dtype))


def argsort(x, axis=-1, descending=False, stable=True):
    return torch.argsort(x, dim=int(axis), descending=descending,
                         stable=True).to(torch.int32)


def sort(x, axis=-1, descending=False, stable=True):
    """A stable ascending sort; descending is its reverse (as
    ``jnp.sort``: ties come out in reverse order, which decides where
    their gradients go, and NaN comes first)."""
    out = torch.sort(x, dim=int(axis), stable=True).values
    return out.flip(int(axis)) if descending else out


def topk(x, k, axis=-1, largest=True, sorted=True):  # noqa: A002
    if axis is None:
        axis = -1
    vals, inds = torch.sort(x, dim=int(axis), descending=largest,
                            stable=True)
    k = int(k)
    return (vals.narrow(int(axis), 0, k),
            inds.narrow(int(axis), 0, k).to(torch.int32))


def kthvalue(x, k, axis=-1, keepdim=False):
    vals, inds = torch.sort(x, dim=int(axis), stable=True)
    v = vals.select(int(axis), int(k) - 1)
    i = inds.select(int(axis), int(k) - 1).to(torch.int32)
    if keepdim:
        return v.unsqueeze(int(axis)), i.unsqueeze(int(axis))
    return v, i


def mode(x, axis=-1, keepdim=False):
    """The most frequent value along ``axis`` (the first one of the
    largest count), counted by pairwise equality as in JAX."""
    xm = torch.movedim(x, int(axis), -1)
    eq = (xm[..., :, None] == xm[..., None, :]).sum(-1)
    idx = torch.argmax(eq, dim=-1)
    vals = torch.take_along_dim(xm, idx[..., None], dim=-1)[..., 0]
    idx = idx.to(torch.int32)
    if keepdim:
        return vals.unsqueeze(int(axis)), idx.unsqueeze(int(axis))
    return vals, idx


def index_sample(x, index):
    """Per-row gather: ``out[i, j] = x[i, index[i, j]]``."""
    return torch.take_along_dim(x, long(index, x.device), dim=1)


def searchsorted(sorted_sequence, values, right=False):
    values = tensor(values, sorted_sequence.device)
    return torch.searchsorted(sorted_sequence, values, right=right,
                              out_int32=True)


def bucketize(x, sorted_sequence, right=False):
    return torch.bucketize(x, tensor(sorted_sequence, x.device),
                           right=right, out_int32=True)
