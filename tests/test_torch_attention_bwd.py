"""The port's attention backward against the JAX package's.

The plain versions of the backward kernels (``attention_bwd_reference``
for the flash kernels #6-#8, ``folded_bwd_reference`` for the folded
kernel #10) and the autograd Functions around the kernels, called on
CPU tensors that require grad, are held against ``jax.vjp`` of
``flash_attention_lse`` and ``folded_attention`` on the same numpy
inputs and cotangents. The JAX kernels run as their own tests run them
on the CPU: through the Pallas interpreter. Tolerance 1e-5 in fp32:
both sides compute in fp32 on the CPU, with sums in different orders.

The single pass on the tensor cores (``csrc/attention_bwd.cu`` modes 2
and 3) runs only on the card; its arithmetic is rehearsed here by an
emulation written in this file: the key-major walk (a block per K tile,
the Q tiles that see it, each split into two 32-query halves with their
own dK/dV partial sums), S^T = K Q^T and dP^T = V dO^T with P^T and dS^T
as A operands, dS staged query-major for the dQ share, the per-K-tile
dQ shares summed in tile order, all five products (and the two of the
folded statistics launch) in 3xTF32. It is held within 1e-5 of the
plain versions and of the JAX vjps.

The dQ and dK/dV passes (modes 0 and 1) are emulated the same way, down
to the warp's patch and its skip rule: the dK/dV pass is the key-major
walk without the dQ share (16 keys x one 32-query half a warp), the dQ
pass the query-major walk of the forward (16 queries x one 32-key half
of every K tile a warp, the two halves' partial sums added first then
second).
"""

import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import folded_attention as jfo

from paddle_tpu_torch.ops.kernels import attention as tat
from paddle_tpu_torch.ops.kernels import launch_counts
from tf32_emulation import tc_matmul as _tc_matmul

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


# -- the tensor-core single pass, emulated ------------------------------------

KT = tat.KERNEL_TILE  # keys of a K tile and queries of a Q tile
HALF = KT // 2        # queries of a Q tile each warp takes


def _walk(sq, sk, causal):
    """(K tile, Q tile) pairs in the single pass's order: one block per K
    tile (tile 0, the longest walk when causal, first), each walking the
    Q tiles from its first key on (causal) or from 0."""
    for kt in range(-(-sk // KT)):
        for qt in range(kt if causal else 0, -(-sq // KT)):
            yield kt, qt


def _stats_walk(sq, sk, causal):
    """(Q tile, K tile) pairs of the folded statistics launch: one block
    per Q tile (the last, the longest walk when causal, first), each
    walking the K tiles up to its last row (causal) or all of them."""
    for qt in reversed(range(-(-sq // KT))) if causal else \
            range(-(-sq // KT)):
        k_end = min(sk, qt * KT + KT) if causal else sk
        for kt in range(-(-k_end // KT)):
            yield qt, kt


def _visible(sq, sk, causal):
    """The (K tile, Q tile) pairs holding a visible (query, key) pair."""
    return {(j // KT, i // KT) for i in range(sq) for j in range(sk)
            if not causal or j <= i}


def _bhsd(*ts):
    return [t.to(torch.float32).permute(0, 2, 1, 3) for t in ts]


def _emulated_single_pass(q, k, v, do, lse, delta, causal, passes=3):
    """The single pass on [B, S, H, D] f32 with lse and delta [B, Sq, H]:
    per (K tile, Q tile) of ``_walk`` and per 32-query half, S^T and
    dP^T, P^T = exp(S^T scale - lse), dS^T = P^T (dP^T - delta) scale,
    dV and dK partial sums per query half (half 0 + half 1 at the end),
    dS^T staged for the K tile's dQ share dS K, the shares summed in K
    tile order; every product ``_tc_matmul`` with ``passes``."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qb, kb, vb, db = _bhsd(q, k, v, do)
    lb, deb = (t.transpose(1, 2) for t in (lse, delta))  # [B, H, Sq]
    dk = torch.zeros((2, b, h, sk, d))
    dv = torch.zeros((2, b, h, sk, d))
    shares = {}
    for kt, qt in _walk(sq, sk, causal):
        k0, q0 = kt * KT, qt * KT
        kk, vv = kb[:, :, k0:k0 + KT], vb[:, :, k0:k0 + KT]
        keys = torch.arange(k0, k0 + kk.shape[2])
        ds_tile = torch.zeros((b, h, kk.shape[2], min(KT, sq - q0)))
        for half in (0, 1):
            a, e = q0 + HALF * half, min(q0 + HALF * (half + 1), sq)
            if a >= sq:
                continue
            qq, dd = qb[:, :, a:e], db[:, :, a:e]
            st = _tc_matmul(kk, qq.transpose(-1, -2), passes) * scale
            if causal:
                seen = keys[:, None] <= torch.arange(a, e)[None, :]
                st = torch.where(seen, st, torch.tensor(-1e30))
            pt = torch.exp(st - lb[:, :, None, a:e])
            dpt = _tc_matmul(vv, dd.transpose(-1, -2), passes)
            dst = pt * (dpt - deb[:, :, None, a:e]) * scale
            dv[half, :, :, k0:k0 + KT] += _tc_matmul(pt, dd, passes)
            dk[half, :, :, k0:k0 + KT] += _tc_matmul(dst, qq, passes)
            ds_tile[..., a - q0:e - q0] = dst
        share = shares.setdefault(kt, torch.zeros((b, h, sq, d)))
        share[:, :, q0:q0 + ds_tile.shape[-1]] = _tc_matmul(
            ds_tile.transpose(-1, -2), kk, passes)
    dq = torch.zeros((b, h, sq, d))
    for kt in sorted(shares):
        dq = dq + shares[kt]
    return tuple(x.permute(0, 2, 1, 3) for x in (dq, dk[0] + dk[1],
                                                  dv[0] + dv[1]))


def _merge(s1, s2):
    """Two online-softmax states (max m, l = rowsum(e), a = rowsum(e dP))
    merged, the first then the second."""
    (m1, l1, a1), (m2, l2, a2) = s1, s2
    mt = torch.maximum(m1, m2)
    f1, f2 = torch.exp(m1 - mt), torch.exp(m2 - mt)
    return mt, l1 * f1 + l2 * f2, a1 * f1 + a2 * f2


def _emulated_stats(q, k, v, do, causal, passes=3):
    """The folded statistics launch: per Q tile of ``_stats_walk``, each
    K tile's two 32-key halves in their own running state (a row that
    has seen only masked keys takes its exponentials against 0), the
    halves merged (first, then second) at the end. Returns ``(lse,
    delta)`` [B, Sq, H]."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qb, kb, vb, db = _bhsd(q, k, v, do)
    neg = torch.tensor(-1e30)
    lse = torch.zeros((b, h, sq))
    delta = torch.zeros((b, h, sq))
    walk = list(_stats_walk(sq, sk, causal))
    for qt in range(-(-sq // KT)):
        q0 = qt * KT
        rows = torch.arange(q0, min(q0 + KT, sq))
        qq, dd = qb[:, :, q0:q0 + KT], db[:, :, q0:q0 + KT]
        halves = []
        for first in (0, HALF):
            m = torch.full((b, h, len(rows)), -1e30)
            l = torch.zeros((b, h, len(rows)))  # noqa: E741
            acc = torch.zeros((b, h, len(rows)))
            for kt in (w[1] for w in walk if w[0] == qt):
                k0 = kt * KT + first
                kk, vv = kb[:, :, k0:k0 + HALF], vb[:, :, k0:k0 + HALF]
                if kk.shape[2] == 0:
                    continue
                s = _tc_matmul(qq, kk.transpose(-1, -2), passes) * scale
                if causal:
                    cols = torch.arange(k0, k0 + kk.shape[2])
                    s = torch.where(cols[None, :] <= rows[:, None], s, neg)
                dp = _tc_matmul(dd, vv.transpose(-1, -2), passes)
                m_new = torch.maximum(m, s.amax(-1))
                ref = torch.where(m_new == neg, torch.tensor(0.0), m_new)
                alpha = torch.exp(m - ref)
                p = torch.exp(s - ref[..., None])
                l = l * alpha + p.sum(-1)  # noqa: E741
                acc = acc * alpha + (p * dp).sum(-1)
                m = m_new
            halves.append((m, l, acc))
        m, l, acc = _merge(*halves)  # noqa: E741
        den = l.clamp_min(1e-30)
        lse[:, :, rows] = m + torch.log(den)
        delta[:, :, rows] = acc / den
    return lse.transpose(1, 2), delta.transpose(1, 2)


@pytest.mark.parametrize("sq,sk", [(128, 128), (200, 200), (256, 256),
                                   (130, 200), (200, 70)])
@pytest.mark.parametrize("causal", [False, True])
def test_single_pass_walk_visits_each_visible_tile_pair_once(sq, sk,
                                                             causal):
    pairs = list(_walk(sq, sk, causal))
    assert len(pairs) == len(set(pairs))
    assert set(pairs) == _visible(sq, sk, causal)
    # the blocks' walks shorten along the grid: tile 0 is launched first
    lengths = [sum(1 for kt, _ in pairs if kt == t)
               for t in range(-(-sk // KT))]
    if causal:
        assert lengths == sorted(lengths, reverse=True)
    # the statistics launch: every visible pair of each Q tile once, the
    # longest walks first
    stats = [(kt, qt) for qt, kt in _stats_walk(sq, sk, causal)]
    assert len(stats) == len(set(stats))
    assert set(stats) == _visible(sq, sk, causal)
    if causal:
        walks = [sum(1 for _, q_ in stats if q_ == qt)
                 for qt in dict.fromkeys(q_ for _, q_ in stats)]
        assert walks == sorted(walks, reverse=True)


def _flash_case(s, d, causal, glse):
    q, k, v, do, g = _inputs(300 + s + d + causal + 2 * glse, s, d, glse)
    tq, tk, tv, tdo = _t(q), _t(k), _t(v), _t(do)
    out, lse = tat.attention_reference(tq, tk, tv, causal=causal)
    delta = (tdo * out).sum(-1) - _t(g)
    return (q, k, v, do, g), (tq, tk, tv, tdo, lse, delta.contiguous())


# S=200 is not a multiple of the 64-row tile: the last Q tile's second
# half and the last K tile are ragged
@pytest.mark.parametrize("s", [128, 200])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("glse", [False, True])
def test_emulated_single_pass_keeps_fp32_accuracy(s, d, causal, glse):
    _, args = _flash_case(s, d, causal, glse)
    want = tat.attention_bwd_reference(*args, causal=causal)
    got = _emulated_single_pass(*args, causal)
    for g_, w in zip(got, want):
        torch.testing.assert_close(g_, w, atol=TOL, rtol=TOL)
    # one TF32 pass keeps about three digits: it misses the fp32 limit
    one = _emulated_single_pass(*args, causal, passes=1)
    assert not all(torch.allclose(g_, w, atol=TOL, rtol=TOL)
                   for g_, w in zip(one, want))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("glse", [False, True])
def test_emulated_single_pass_matches_jax_vjp(_interpret, d, causal, glse):
    (q, k, v, do, g), args = _flash_case(128, d, causal, glse)
    _, _, want = _jax_flash_vjp(q, k, v, do, g, causal)
    _close(_emulated_single_pass(*args, causal), want)


@pytest.mark.parametrize("s", [128, 200])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_emulated_folded_keeps_fp32_accuracy(s, d, causal):
    q, k, v, do, _ = _inputs(400 + s + d + causal, s, d)
    tq, tk, tv, tdo = _t(q), _t(k), _t(v), _t(do)
    want_l = tat.attention_reference(tq, tk, tv, causal=causal)[1]
    want = tat.folded_bwd_reference(tq, tk, tv, tdo, causal=causal)
    lse, delta = _emulated_stats(tq, tk, tv, tdo, causal)
    torch.testing.assert_close(lse, want_l, atol=TOL, rtol=TOL)
    got = _emulated_single_pass(tq, tk, tv, tdo, lse, delta, causal)
    for g_, w in zip(got, want):
        torch.testing.assert_close(g_, w, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_emulated_folded_matches_jax_vjp(_interpret, d, causal):
    q, k, v, do, _ = _inputs(500 + d + causal, 128, d)
    with jfa.force_flash_for_aot():
        _, vjp = jax.vjp(functools.partial(jfo.folded_attention,
                                           causal=causal),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = _t(q), _t(k), _t(v), _t(do)
    lse, delta = _emulated_stats(tq, tk, tv, tdo, causal)
    _close(_emulated_single_pass(tq, tk, tv, tdo, lse, delta, causal), want)


# -- the tensor-core dQ and dK/dV passes, emulated ----------------------------

GROUP = 16  # rows of a warp's patch: keys (dK/dV pass), queries (dQ pass)


def _dkv_patches(sq, sk, causal):
    """(K tile, Q tile, key group, query half) of the dK/dV pass in its
    order: the single pass's walk (``_walk``), each pair split among 8
    warps, 16 keys x 32 queries each; a warp skips a patch past Sk or Sq,
    or whose every query is above every key (causal)."""
    for kt, qt in _walk(sq, sk, causal):
        for rg in range(KT // GROUP):
            for qh in range(2):
                kw, qw = kt * KT + GROUP * rg, qt * KT + HALF * qh
                if kw < sk and qw < sq and not (causal and qw + HALF - 1 < kw):
                    yield kt, qt, rg, qh


def _dq_patches(sq, sk, causal):
    """(Q tile, K tile, row group, key half) of the dQ pass in its order:
    the query-major walk (``_stats_walk``: the longest Q tiles first, K
    tiles wholly above the diagonal never loaded), each pair split among
    8 warps, 16 queries x 32 keys each; a warp skips a half tile past Sk
    or wholly above its rows (causal)."""
    for qt, kt in _stats_walk(sq, sk, causal):
        for rg in range(KT // GROUP):
            for kh in range(2):
                w0, k0 = qt * KT + GROUP * rg, kt * KT + HALF * kh
                if not ((causal and k0 > w0 + GROUP - 1) or k0 >= sk):
                    yield qt, kt, rg, kh


def _patch_pairs(rows, cols, sq, sk, causal):
    """The visible (query, key) pairs of a patch."""
    return {(i, j) for i in range(*rows) for j in range(*cols)
            if i < sq and j < sk and (not causal or j <= i)}


def _patch_probs(qq, kk, vv, dd, lb, deb, queries, keys, causal, passes):
    """P and dS [B, H, queries, keys] of one patch from its rows: S = Q
    K^T and dP = dO V^T on the emulated tensor cores, the causal mask
    -1e30 before the exp."""
    scale = 1.0 / math.sqrt(qq.shape[-1])
    s = _tc_matmul(qq, kk.transpose(-1, -2), passes) * scale
    if causal:
        s = torch.where(keys[None, :] <= queries[:, None], s,
                        torch.tensor(-1e30))
    p = torch.exp(s - lb[..., None])
    dp = _tc_matmul(dd, vv.transpose(-1, -2), passes)
    return p, p * (dp - deb[..., None]) * scale


def _emulated_dkv(q, k, v, do, lse, delta, causal, passes=3):
    """The dK/dV pass on [B, S, H, D] f32: per patch of ``_dkv_patches``,
    P and dS of its 16 keys x 32 queries, dV += P^T dO and dK += dS^T Q
    into the partial sums of its query half; half 0 + half 1 at the end.
    Returns ``(dk, dv)``."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qb, kb, vb, db = _bhsd(q, k, v, do)
    lb, deb = (t.transpose(1, 2) for t in (lse, delta))
    dk = torch.zeros((2, b, h, sk, d))
    dv = torch.zeros((2, b, h, sk, d))
    for kt, qt, rg, qh in _dkv_patches(sq, sk, causal):
        a = kt * KT + GROUP * rg
        e = min(a + GROUP, sk)
        qa = qt * KT + HALF * qh
        qe = min(qa + HALF, sq)
        qq, dd = qb[:, :, qa:qe], db[:, :, qa:qe]
        p, ds = _patch_probs(qq, kb[:, :, a:e], vb[:, :, a:e], dd,
                             lb[:, :, qa:qe], deb[:, :, qa:qe],
                             torch.arange(qa, qe), torch.arange(a, e),
                             causal, passes)
        dv[qh, :, :, a:e] += _tc_matmul(p.transpose(-1, -2), dd, passes)
        dk[qh, :, :, a:e] += _tc_matmul(ds.transpose(-1, -2), qq, passes)
    return tuple(x.permute(0, 2, 1, 3) for x in (dk[0] + dk[1],
                                                  dv[0] + dv[1]))


def _emulated_dq(q, k, v, do, lse, delta, causal, passes=3):
    """The dQ pass on [B, S, H, D] f32: per patch of ``_dq_patches``, P
    and dS of its 16 queries x 32 keys, dQ += dS K into the partial sum
    of its key half; the first half + the second at the end."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qb, kb, vb, db = _bhsd(q, k, v, do)
    lb, deb = (t.transpose(1, 2) for t in (lse, delta))
    dq = torch.zeros((2, b, h, sq, d))
    for qt, kt, rg, kh in _dq_patches(sq, sk, causal):
        a = qt * KT + GROUP * rg
        e = min(a + GROUP, sq)
        ka = kt * KT + HALF * kh
        ke = min(ka + HALF, sk)
        if a >= e:  # rows past Sq: computed on the card, never written
            continue
        kk = kb[:, :, ka:ke]
        _, ds = _patch_probs(qb[:, :, a:e], kk, vb[:, :, ka:ke],
                             db[:, :, a:e], lb[:, :, a:e], deb[:, :, a:e],
                             torch.arange(a, e), torch.arange(ka, ke),
                             causal, passes)
        dq[kh, :, :, a:e] += _tc_matmul(ds, kk, passes)
    return (dq[0] + dq[1]).permute(0, 2, 1, 3)


@pytest.mark.parametrize("sq,sk", [(128, 128), (200, 200), (256, 256),
                                   (130, 200), (200, 70), (64, 300),
                                   (8, 8)])
@pytest.mark.parametrize("causal", [False, True])
def test_dq_and_dkv_walks_visit_each_visible_pair_once(sq, sk, causal):
    visible = _patch_pairs((0, sq), (0, sk), sq, sk, causal)
    for patches, rows_cols in (
            (_dkv_patches, lambda kt, qt, rg, qh: (
                (qt * KT + HALF * qh, qt * KT + HALF * (qh + 1)),
                (kt * KT + GROUP * rg, kt * KT + GROUP * (rg + 1)))),
            (_dq_patches, lambda qt, kt, rg, kh: (
                (qt * KT + GROUP * rg, qt * KT + GROUP * (rg + 1)),
                (kt * KT + HALF * kh, kt * KT + HALF * (kh + 1))))):
        seen = []
        for patch in patches(sq, sk, causal):
            rows, cols = rows_cols(*patch)
            seen.extend(_patch_pairs(rows, cols, sq, sk, causal))
        assert len(seen) == len(set(seen))
        assert set(seen) == visible, patches.__name__
    # causal: the blocks' walks shorten along each grid (the dK/dV pass's
    # K tiles, the dQ pass's Q tiles in launch order)
    if causal:
        kts = [kt for kt, _, _, _ in _dkv_patches(sq, sk, causal)]
        walks = [kts.count(t) for t in dict.fromkeys(kts)]
        assert walks == sorted(walks, reverse=True)
        qts = [qt for qt, _ in _stats_walk(sq, sk, causal)]
        walks = [qts.count(t) for t in dict.fromkeys(qts)]
        assert walks == sorted(walks, reverse=True)


def _cross_case(seed, sq, sk, d, causal, glse):
    """Inputs with Sq queries and Sk keys, the forward's lse and delta =
    rowsum(dO*O) - g_lse from the plain forward, as torch tensors."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, sq, H, d)).astype(np.float32)
    k, v = (rng.standard_normal((1, sk, H, d)).astype(np.float32)
            for _ in range(2))
    do = (0.1 * rng.standard_normal((1, sq, H, d))).astype(np.float32)
    g = ((0.1 * rng.standard_normal((1, sq, H))).astype(np.float32)
         if glse else np.zeros((1, sq, H), np.float32))
    tq, tk, tv, tdo = _t(q), _t(k), _t(v), _t(do)
    out, lse = tat.attention_reference(tq, tk, tv, causal=causal)
    delta = (tdo * out).sum(-1) - _t(g)
    return tq, tk, tv, tdo, lse, delta.contiguous()


# Sq != Sk and sizes that are not multiples of the 64-row tile: ragged
# last tiles, half tiles and patches past Sq or Sk
@pytest.mark.parametrize("sq,sk", [(128, 128), (200, 200), (130, 200),
                                   (200, 70)])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_emulated_dq_and_dkv_keep_fp32_accuracy(sq, sk, d, causal):
    args = _cross_case(600 + sq + sk + d + causal, sq, sk, d, causal,
                       glse=sq == sk)
    want = tat.attention_bwd_reference(*args, causal=causal)
    got = (_emulated_dq(*args, causal),) + _emulated_dkv(*args, causal)
    for g_, w in zip(got, want):
        torch.testing.assert_close(g_, w, atol=TOL, rtol=TOL)
    # one TF32 pass keeps about three digits: it misses the fp32 limit
    one = (_emulated_dq(*args, causal, passes=1),) + _emulated_dkv(
        *args, causal, passes=1)
    assert not all(torch.allclose(g_, w, atol=TOL, rtol=TOL)
                   for g_, w in zip(one, want))


# S=256 is two 128-row Q blocks: the JAX vjp runs the dQ and dK/dV
# kernels (#7, #8) in the Pallas interpreter
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("glse", [False, True])
def test_emulated_dq_and_dkv_match_jax_vjp(_interpret, d, causal, glse):
    (q, k, v, do, g), args = _flash_case(256, d, causal, glse)
    _, _, want = _jax_flash_vjp(q, k, v, do, g, causal)
    _close((_emulated_dq(*args, causal),) + _emulated_dkv(*args, causal),
           want)


@pytest.mark.parametrize("fn", [tat.attention_bwd_dq, tat.attention_bwd_dkv])
@pytest.mark.parametrize("bad", ["q", "k", "v", "dO"])
def test_dq_and_dkv_refuse_misaligned_operands(monkeypatch, fn, bad):
    """The passes stage rows with 16-byte copies: a q, k, v or dO whose
    rows are not whole 16-byte steps (or that starts off a 16-byte
    boundary) is refused before any launch."""
    monkeypatch.setattr(tat, "_check_operands",
                        lambda name, q, k, v, dims, extra=(): q.device)
    def operand(name, offset):
        if name != bad:
            return torch.empty(1, 128, 2, 64, device="meta")
        if offset:  # starts 4 bytes in
            return torch.empty(1 + 128 * 2 * 64, device="meta")[1:].view(
                1, 128, 2, 64)
        return torch.empty(1, 128, 2, 66, device="meta")[..., :64]
    stats = torch.empty(1, 128, 2, device="meta")
    for offset in (False, True):
        ops = [operand(n, offset) for n in ("q", "k", "v", "dO")]
        with pytest.raises(ValueError, match=f"{bad} needs a 16-byte"):
            fn(*ops, stats, stats, True)


# -- chip_smoke.py's reading of the build's ptxas report ----------------------

def _ptxas_lines(kernel, dtype, d, regs, spill=0):
    """``ptxas -v``'s lines for one instantiation, as nvcc prints them."""
    arg = "f" if dtype == "fp32" else "13__nv_bfloat16"
    name = (f"_ZN49_GLOBAL__N__52f9eb2c_16_attention_bwd_cu_ccd79dfe"
            f"{len(kernel)}{kernel}I{arg}Li{d}EEEvPKT_")
    return (f"ptxas info    : Compiling entry function '{name}' for "
            f"'sm_90a'\nptxas info    : Function properties for {name}\n"
            f"    {2 * spill} bytes stack frame, {spill} bytes spill "
            f"stores, {spill} bytes spill loads\nptxas info    : Used "
            f"{regs} registers, used 1 barriers, 221184 bytes smem\n")


def _served(spill_at=None, skip=None):
    """The report of the served instantiations of the backward's
    tensor-core kernels (four each), one of them spilling 8 bytes
    (``spill_at``) or left out (``skip``)."""
    from test_torch_attention_fwd import _chip_smoke
    return "".join(
        _ptxas_lines(k, dt, d, 200 + d // 64,
                     spill=8 if (k, dt, d) == spill_at else 0)
        for k in _chip_smoke().BWD_TC_KERNELS
        for dt in ("fp32", "bf16") for d in (64, 128)
        if (k, dt, d) != skip)


def test_ptxas_report_reads_registers_and_spills_per_kernel():
    from test_torch_attention_fwd import _chip_smoke
    cs = _chip_smoke()
    usage = cs.ptxas_usage(_served())
    assert len(usage) == 4 * len(cs.BWD_TC_KERNELS) == 16
    assert all(u == {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                     "registers": u["registers"]} for u in usage.values())
    assert sorted({u["registers"] for u in usage.values()}) == [201, 202]


def test_chip_smoke_refuses_a_spilling_or_missing_single_pass_kernel():
    from test_torch_attention_fwd import _chip_smoke
    cs = _chip_smoke()
    rows = cs.bwd_ptxas(cs.ptxas_usage(_served()))
    assert sorted(rows) == sorted(
        f"{k} {dt} D={d}" for k in cs.BWD_TC_KERNELS
        for dt in ("fp32", "bf16") for d in (64, 128))
    for kernel in cs.BWD_TC_KERNELS:
        spilling = _served((kernel, "fp32", 128))
        with pytest.raises(AssertionError, match="spills"):
            cs.bwd_ptxas(cs.ptxas_usage(spilling))
        missing = _served(skip=(kernel, "bf16", 64))
        with pytest.raises(AssertionError, match="no lines"):
            cs.bwd_ptxas(cs.ptxas_usage(missing))


def test_chip_smoke_records_a_failed_closeness_check_and_goes_on(capsys):
    from test_torch_attention_fwd import _chip_smoke
    cs = _chip_smoke()
    want = torch.tensor([1.0, 2.0, 4.0])
    assert cs.check_close("near", want + 1e-6, want, 1e-4) < 1e-4
    assert cs.FAILED_CHECKS == []
    got = torch.tensor([1.0, 2.0, 4.0078125])
    assert cs.check_close("one ulp apart", got, want, 2.5e-3, 0.0) == \
        pytest.approx(0.0078125)
    assert cs.FAILED_CHECKS == [
        "one ulp apart: max abs err 0.00781 over atol 0.0025 rtol 0.0"]
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["check"] == "one ulp apart" and line["ok"] is False


def test_chip_smoke_bf16_apart_counts_the_elements_that_differ():
    from test_torch_attention_fwd import _chip_smoke
    cs = _chip_smoke()
    want = torch.tensor([1.0, 2.0, 4.0, 0.5], dtype=torch.bfloat16)
    got = torch.tensor([1.0, 2.0, 4.03125, 0.5], dtype=torch.bfloat16)
    assert cs.bf16_apart(got, want) == [0.03125, 0.25]
    assert cs.bf16_apart(want, want) == [0.0, 0.0]


# -- chip_smoke.py's bf16 check of the single pass ---------------------------

def _card_case(cs, s, d, seed):
    """bf16 inputs as chip_smoke's backward phase makes them (B=2, H=16,
    causal, no lse cotangent), from a CPU generator."""
    gen = torch.Generator().manual_seed(seed)
    return cs._bwd_inputs(torch, gen, torch.device("cpu"), 2, s,
                          torch.bfloat16, True, False, D=d)


def _f64_grads(name, q, k, v, do, lse, delta):
    """The causal gradient in f64 from the same bf16 inputs: the value
    that every f32 sum order approximates."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    n = q.shape[1]
    s = s.masked_fill(torch.arange(n)[None, :] > torch.arange(n)[:, None],
                      -math.inf)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    if name == "folded_attention_bwd":
        p = torch.softmax(s, dim=-1)
        dl = (p * dp).sum(dim=-1, keepdim=True)
    else:
        p = torch.exp(s - lse.double().transpose(1, 2)[..., None])
        dl = delta.double().transpose(1, 2)[..., None]
    ds = p * (dp - dl) * scale
    return {"dq": torch.einsum("bhqk,bkhd->bqhd", ds, k),
            "dk": torch.einsum("bhqk,bqhd->bkhd", ds, q),
            "dv": torch.einsum("bhqk,bqhd->bkhd", p, do)}


@pytest.mark.parametrize("name,s,seed", [("attention_bwd_fused", 512, 1),
                                         ("folded_attention_bwd", 256, 2)])
def test_bf16_limit_after_rounding_refuses_the_exact_gradient(name, s, seed):
    """Why chip_smoke holds the single pass's bf16 outputs to BF16_ATOL
    before the rounding: the exact gradient, rounded to bf16, lies one
    ulp from the plain version's rounded f32 result in some element
    larger than 0.5, beyond the limit; taken before the rounding, the
    limit passes it."""
    from test_torch_attention_fwd import _chip_smoke
    cs = _chip_smoke()
    ins = _card_case(cs, s, 128, seed)
    _, plain32 = cs._bwd_call(name, *(t.float() for t in ins), True)
    exact = _f64_grads(name, *ins)
    tol = cs.BF16_ATOL[name]
    after = [cs.max_err(exact[key].to(torch.bfloat16),
                        plain32[key].to(torch.bfloat16)) for key in exact]
    assert max(after) > tol
    assert all(cs.rounded_from(exact[key].to(torch.bfloat16), plain32[key],
                               tol) for key in exact)


@pytest.mark.parametrize("name,s,seed", [
    ("attention_bwd_fused", 512, 1), ("folded_attention_bwd", 256, 2),
    ("attention_bwd_fused", 200, 3), ("folded_attention_bwd", 200, 3),
    ("attention_bwd_dq", 512, 1), ("attention_bwd_dkv", 512, 1),
    ("attention_bwd_dq", 200, 3), ("attention_bwd_dkv", 200, 3)])
def test_bf16_check_before_rounding_takes_two_term_p_refuses_one_term(
        name, s, seed):
    """The check tells the kernel's design (P and dS as two bf16 terms)
    from one bf16 term on the card check's causal shapes; each holds
    only the gradients the kernel returns."""
    from test_torch_attention_fwd import _chip_smoke
    cs = _chip_smoke()
    ins = _card_case(cs, s, 128, seed)
    _, plain32 = cs._bwd_call(name, *(t.float() for t in ins), True)
    tol = cs.BF16_ATOL[name]
    two = cs.bf16_terms_bwd(torch, name, 2, *ins, True)
    one = cs.bf16_terms_bwd(torch, name, 1, *ins, True)
    assert set(two) == set(one) == set(plain32) == set(cs.BWD_OUTPUTS[name])
    assert all(cs.rounded_from(two[key], plain32[key], tol) for key in two)
    assert not all(cs.rounded_from(one[key], plain32[key], tol)
                   for key in one)


def test_rounded_from_allows_the_other_rounding_only_near_a_midpoint(capsys):
    from test_torch_attention_fwd import _chip_smoke
    cs = _chip_smoke()
    bf = torch.bfloat16
    # 1.0039 lies 2.6e-5 below the midpoint of 1 and 1.0078125
    near = torch.tensor([1.0039, 3.0])
    assert cs.rounded_from(torch.tensor([1.0, 3.0], dtype=bf), near, 2.5e-3)
    assert cs.rounded_from(torch.tensor([1.0078125, 3.0], dtype=bf), near,
                           2.5e-3)
    assert not cs.rounded_from(torch.tensor([1.015625, 3.0], dtype=bf),
                               near, 2.5e-3)
    assert not cs.rounded_from(torch.tensor([1.0, 3.015625], dtype=bf),
                               near, 2.5e-3)
    assert cs.check_rounded_from("far", torch.tensor([1.0, 3.015625],
                                                     dtype=bf), near,
                                 2.5e-3) == pytest.approx(0.015625)
    assert len(cs.FAILED_CHECKS) == 1 and cs.FAILED_CHECKS[0].startswith(
        "far: not the rounding of a value within 0.0025")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["check"] == "far" and line["before_rounding"] is True
