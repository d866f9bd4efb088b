"""The port's attention backward against the JAX package's.

The plain versions of the backward kernels (``attention_bwd_reference``
for the flash kernels #6-#8, ``folded_bwd_reference`` for the folded
kernel #10) and the autograd Functions around the kernels, called on
CPU tensors that require grad, are held against ``jax.vjp`` of
``flash_attention_lse`` and ``folded_attention`` on the same numpy
inputs and cotangents. The JAX kernels run as their own tests run them
on the CPU: through the Pallas interpreter. Tolerance 1e-5 in fp32:
both sides compute in fp32 on the CPU, with sums in different orders.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import folded_attention as jfo

from paddle_tpu_torch.ops.kernels import attention as tat
from paddle_tpu_torch.ops.kernels import launch_counts

TOL = 1e-5
H = 2


@pytest.fixture
def _interpret(monkeypatch):
    for mod in (jfa, jfo):
        monkeypatch.setattr(mod.pl, "pallas_call",
                            functools.partial(mod.pl.pallas_call,
                                              interpret=True))
    yield


def _t(x, grad=False):
    return torch.from_numpy(np.asarray(x).copy()).requires_grad_(grad)


def _inputs(seed, s, d, glse=True):
    """q, k, v ~ N(0, 1); the cotangents dO and g_lse ~ N(0, 0.1^2), the
    small end of what a loss hands back. (With dO ~ N(0, 1), dP = dO V^T
    reaches ~sqrt(d) and dP - delta cancels, so a rounding difference
    of the CPU GEMMs between runs can reach 5e-5 relative.)"""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((1, s, H, d)).astype(np.float32)
               for _ in range(3))
    do = (0.1 * rng.standard_normal((1, s, H, d))).astype(np.float32)
    g = ((0.1 * rng.standard_normal((1, s, H))).astype(np.float32)
         if glse else np.zeros((1, s, H), np.float32))
    return q, k, v, do, g


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=TOL, rtol=TOL)


def _jax_flash_vjp(q, k, v, do, g_lse, causal):
    def f(qq, kk, vv):
        return jfa.flash_attention_lse(qq, kk, vv, causal=causal,
                                       block_q=128, block_k=128)
    with jfa.force_flash_for_aot():
        (out, lse), vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v))
        grads = vjp((jnp.asarray(do), jnp.asarray(g_lse)))
    return out, lse, grads


# S=128 is one 128-row Q block (the fused pass, #6); S=256 is two (the
# dQ and dK/dV passes, #7 and #8)
@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("glse", [False, True])
def test_flash_backward_matches_jax_vjp(_interpret, s, d, causal, glse):
    q, k, v, do, g = _inputs(s + d + causal + 2 * glse, s, d, glse)
    jout, jlse, want = _jax_flash_vjp(q, k, v, do, g, causal)

    # the plain version, given the forward's lse and delta
    out, lse = tat.attention_reference(_t(q), _t(k), _t(v), causal=causal)
    delta = (_t(do) * out).sum(-1) - _t(g)
    _close(tat.attention_bwd_reference(_t(q), _t(k), _t(v), _t(do), lse,
                                       delta, causal=causal), want)

    # the autograd Function, both outputs differentiable; a lse that
    # takes no part in the loss gets a None cotangent (zeros)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    o, l_ = tat.flash_attention(tq, tk, tv, causal=causal, block_q=128,
                                block_k=128)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jout),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(l_.detach().numpy(), np.asarray(jlse),
                               atol=1e-4, rtol=1e-4)
    outputs, cots = ((o, l_), (_t(do), _t(g))) if glse else \
        ((o,), (_t(do),))
    _close(torch.autograd.grad(outputs, (tq, tk, tv), cots), want)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_folded_backward_matches_jax_vjp(_interpret, d, causal):
    q, k, v, do, _ = _inputs(d + causal, 128, d)
    with jfa.force_flash_for_aot():
        _, vjp = jax.vjp(functools.partial(jfo.folded_attention,
                                           causal=causal),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = vjp(jnp.asarray(do))
    _close(tat.folded_bwd_reference(_t(q), _t(k), _t(v), _t(do),
                                    causal=causal), want)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = tat.folded_attention(tq, tk, tv, causal=causal)
    _close(torch.autograd.grad(out, (tq, tk, tv), _t(do)), want)


def test_flash_lse_alone_backpropagates():
    """Only lse in the loss: the out cotangent is None and counts as
    zeros, so the gradient is that of logsumexp alone."""
    q, k, v, _, g = _inputs(11, 256, 64)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    _, lse = tat.flash_attention(tq, tk, tv, causal=True, block_q=128,
                                 block_k=128)
    got = torch.autograd.grad((lse * _t(g)).sum(), (tq, tk, tv))
    rq, rk, rv = _t(q, True), _t(k, True), _t(v, True)
    s = torch.einsum("bqhd,bkhd->bhqk", rq, rk) / 8.0
    s = s.masked_fill(~torch.ones(256, 256, dtype=torch.bool).tril(),
                      float("-inf"))
    ref = torch.logsumexp(s, -1).transpose(1, 2)
    want = torch.autograd.grad((ref * _t(g)).sum(), (rq, rk, rv),
                               allow_unused=True)
    _close(got[:2], [w.numpy() for w in want[:2]])
    assert float(got[2].abs().max()) == 0.0


def test_sdpa_training_reaches_the_autograd_functions(monkeypatch):
    """Under the kernel gates the training branch of
    ``scaled_dot_product_attention`` goes through the Functions (here
    their plain versions, CPU tensors) and differentiates into q, k, v
    of a fused QKV projection."""
    from paddle_tpu_torch.ops import nn_functional as tnf
    used = []

    def record(name, fn, *args, **kw):
        used.append(name)
        return fn(*args, **kw)

    for name in ("flash_attention", "folded_attention"):
        monkeypatch.setattr(tnf, name, functools.partial(
            record, name, getattr(tnf, name)))
    monkeypatch.setattr(tnf, "_on_card", lambda t: True)
    for s in (256, 512):
        qkv = torch.randn(1, s, 3, 2, 128, requires_grad=True)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        out = tnf.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               use_flash=True)
        assert type(out.grad_fn).__name__.endswith(
            "AttentionFunctionBackward")
        out.sum().backward()
        assert qkv.grad is not None and float(qkv.grad.abs().sum()) > 0
    assert used == ["folded_attention", "flash_attention"]


def test_backward_wrappers_on_cpu_are_plain_and_refuse_other_devices():
    q, k, v, do, g = _inputs(12, 128, 64)
    out, lse = tat.attention_reference(_t(q), _t(k), _t(v), causal=True)
    delta = ((_t(do) * out).sum(-1) - _t(g)).contiguous()
    args = (_t(q), _t(k), _t(v), _t(do), lse, delta, True)
    ref = tat.attention_bwd_reference(*args)
    assert all(torch.equal(a, b)
               for a, b in zip(tat.attention_bwd_fused(*args), ref))
    assert torch.equal(tat.attention_bwd_dq(*args), ref[0])
    assert all(torch.equal(a, b)
               for a, b in zip(tat.attention_bwd_dkv(*args), ref[1:]))
    fref = tat.folded_bwd_reference(*args[:4], True)
    assert all(torch.equal(a, b) for a, b in
               zip(tat.folded_attention_bwd(*args[:4], True), fref))
    counts = launch_counts()
    assert all(counts[n] == 0 for n in (
        "attention_bwd_fused", "attention_bwd_dq", "attention_bwd_dkv",
        "folded_attention_bwd"))
    meta = [torch.empty(1, 128, 2, 64, device="meta") for _ in range(4)]
    stats = torch.empty(1, 128, 2, device="meta")
    for fn in (tat.attention_bwd_fused, tat.attention_bwd_dq,
               tat.attention_bwd_dkv):
        with pytest.raises(ValueError, match="meta"):
            fn(*meta, stats, stats, True)
    with pytest.raises(ValueError, match="meta"):
        tat.folded_attention_bwd(*meta, True)
