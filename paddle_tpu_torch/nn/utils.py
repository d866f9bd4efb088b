"""Weight reparametrisations and parameter vectors (port of
``paddle_tpu/nn/utils.py``).

``weight_norm`` replaces ``layer.<name>`` by the parameters
``<name>_g`` and ``<name>_v`` and ``spectral_norm`` by ``<name>_orig``
with the buffers ``<name>_u`` / ``<name>_v``, JAX's names; a forward
pre-hook recomputes the derived weight before every forward (and once at
once, for direct reads), so optimizers see only the reparametrised
parameters and autograd differentiates through the derivation.
"""

from __future__ import annotations

import numpy as np
import torch

from ..tensor import Parameter, Tensor, unwrap


def _norm_except_dim(v, dim):
    dims = tuple(i for i in range(v.dim()) if i != dim)
    return torch.sqrt(torch.sum(v * v, dim=dims, keepdim=True))


def _full_norm(v):
    return torch.sqrt(torch.sum(v * v))


def weight_norm(layer, name: str = "weight", dim: int = 0):
    """``layer.<name> = g * v / ||v||``, the norms taken over every dim
    but ``dim`` (over all with ``dim=None``). Returns the layer."""
    w = layer._parameters[name]
    dim = dim % w.dim() if dim is not None else None
    with torch.no_grad():
        g0 = _full_norm(w).reshape(()) if dim is None else \
            _norm_except_dim(w, dim)
    del layer._parameters[name]
    layer.register_parameter(name + "_g", Parameter(g0.clone()))
    layer.register_parameter(name + "_v", Parameter(w.detach().clone()))

    def _compute(lyr, _inputs):
        g = lyr._parameters[name + "_g"]
        v = lyr._parameters[name + "_v"]
        nrm = _full_norm(v) if dim is None else _norm_except_dim(v, dim)
        object.__setattr__(lyr, name, v * (g / nrm))
        return None

    helper = layer.register_forward_pre_hook(_compute)
    hooks = layer.__dict__.setdefault("_weight_norm_hooks", {})
    hooks[name] = (helper, dim)
    _compute(layer, None)
    return layer


def remove_weight_norm(layer, name: str = "weight"):
    """Fold ``g`` and ``v`` back into a plain ``<name>`` parameter."""
    helper, dim = layer.__dict__["_weight_norm_hooks"].pop(name)
    helper.remove()
    g = layer._parameters.pop(name + "_g")
    v = layer._parameters.pop(name + "_v")
    with torch.no_grad():
        nrm = _full_norm(v) if dim is None else _norm_except_dim(v, dim)
        w = v * (g / nrm)
    layer.__dict__.pop(name, None)
    layer.register_parameter(name, Parameter(w.clone()))
    return layer


def _l2norm(x, eps):
    return x / (torch.linalg.vector_norm(x) + eps)


def spectral_norm(layer, name: str = "weight", n_power_iterations: int = 1,
                  eps: float = 1e-12, dim: int = 0):
    """``layer.<name> = orig / sigma``: sigma estimated by power
    iteration on the persistent ``<name>_u`` / ``<name>_v`` buffers
    (drawn from ``np.random.default_rng(0)`` as in JAX) and taken as
    ``sum(W * outer(u, v))`` through the live weight, so the gradient
    sees sigma's dependence on it."""
    w = layer._parameters[name]
    dim = dim % w.dim()
    h = int(w.shape[dim])
    ww = int(w.numel() // h)
    rng = np.random.default_rng(0)
    f = dict(dtype=w.dtype, device=w.device)
    layer.register_buffer(name + "_u", _l2norm(torch.as_tensor(
        rng.standard_normal(h), **f), eps))
    layer.register_buffer(name + "_v", _l2norm(torch.as_tensor(
        rng.standard_normal(ww), **f), eps))
    del layer._parameters[name]
    layer.register_parameter(name + "_orig", Parameter(w.detach().clone()))

    def _compute(lyr, _inputs):
        wo = lyr._parameters[name + "_orig"]
        flat = torch.movedim(wo, dim, 0).reshape(wo.shape[dim], -1)
        with torch.no_grad():
            u, v = lyr._buffers[name + "_u"], lyr._buffers[name + "_v"]
            m = flat.detach()
            for _ in range(max(1, n_power_iterations)):
                v = _l2norm(m.T @ u, eps)
                u = _l2norm(m @ v, eps)
            lyr._buffers[name + "_u"].copy_(u)
            lyr._buffers[name + "_v"].copy_(v)
        sigma = torch.sum(flat * torch.outer(u, v))
        object.__setattr__(lyr, name, wo / sigma)
        return None

    layer.register_forward_pre_hook(_compute)
    _compute(layer, None)
    return layer


def parameters_to_vector(parameters):
    """Every parameter flattened and concatenated, a ``Tensor``."""
    return Tensor._wrap(torch.cat([unwrap(p).reshape(-1)
                                   for p in parameters]))


def vector_to_parameters(vec, parameters):
    """Copy consecutive slices of ``vec`` into the parameters in place."""
    vec = unwrap(vec)
    offset = 0
    with torch.no_grad():
        for p in parameters:
            n = int(np.prod(p.shape))
            unwrap(p).copy_(vec[offset:offset + n].reshape(p.shape))
            offset += n
