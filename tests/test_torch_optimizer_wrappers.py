"""The port's optimizer wrappers and DGC momentum against the JAX
package's, on the CPU.

- ``ExponentialMovingAverage``, ``ModelAverage`` and ``Lookahead`` step
  by step on ``gpt_tiny``'s parameters (the JAX model's weights loaded
  into the port's): the same parameter values (seeded numpy updates) or
  gradients (for Lookahead's inner SGD) on both sides each step; the
  shadows, sums and parameters after every step, ``apply`` /
  ``restore`` / ``apply_guard``, the state dicts.
- ``DGCMomentum`` on the cases of ``tests/test_comm_strategies.py``'s
  ``test_dgc_*`` tests (the JAX ``apply_gradients`` against the port's
  eager step), the sparsity ramp, and a few steps on ``gpt_tiny``.

Tolerances, stated: the wrappers run the JAX expressions operation for
operation in fp32, so values agree within 1e-6 relative / 1e-7 absolute
(XLA may fuse a multiply-add into an FMA on the CPU). DGC's masks come
from the same quantile of the same sample on both sides; the parameters
then agree as Momentum's do.
"""

import _torch_threads  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import optimizer as jopt
from paddle_tpu.optimizer import wrappers as jwrap
from paddle_tpu.models import gpt as jgpt

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import gpt as tgpt

RTOL, ATOL = 1e-6, 1e-7


@pytest.fixture(scope="module", autouse=True)
def _single_device_jax():
    """The JAX models of this file on one device, whatever ran before in
    the worker (``tests/test_torch_hot_swap.py``'s guard)."""
    from paddle_tpu.distributed.topology import (
        get_hybrid_communicate_group, set_hybrid_communicate_group)
    prev = get_hybrid_communicate_group()
    set_hybrid_communicate_group(None)
    try:
        yield
    finally:
        set_hybrid_communicate_group(prev)


def _models():
    pt.seed(0)
    jm = jgpt.GPTForCausalLM(jgpt.gpt_tiny())
    tm = tgpt.GPTForCausalLM(tgpt.gpt_tiny(), device="cpu")
    tgpt.load_jax_state(tm, jgpt.checkpoint_state(jm))
    return jm, tm


def _pairs(jm, tm):
    tp = dict(tm.named_parameters())
    return [(p, tp[n]) for n, p in jm.named_parameters()]


def _set_values(pairs, rng, scale=0.01):
    """Move every parameter by the same seeded numpy step on both
    sides."""
    for jp, tp in pairs:
        new = (np.asarray(jp.numpy()) + scale * rng.standard_normal(
            tuple(tp.shape))).astype(np.float32)
        jp.value = jnp.asarray(new)
        with torch.no_grad():
            tp.copy_(torch.from_numpy(new))


def _close(t, j):
    np.testing.assert_allclose(
        t.detach().numpy(), np.asarray(j.numpy() if hasattr(j, "numpy")
                                       else j), rtol=RTOL, atol=ATOL)


def _values(pairs):
    return [tp.detach().clone() for _, tp in pairs]


def test_ema_matches_jax_step_by_step():
    jm, tm = _models()
    pairs = _pairs(jm, tm)
    je = jwrap.ExponentialMovingAverage(jm, decay=0.9)
    te = topt.ExponentialMovingAverage(tm, decay=0.9)
    rng = np.random.default_rng(0)
    for _ in range(12):  # past the (1 + n) / (10 + n) warm-up
        _set_values(pairs, rng)
        je.update()
        te.update()
        for jp, tp in pairs:
            _close(te._shadow[id(tp)], je._shadow[id(jp)])
            assert te._shadow[id(tp)].dtype == tp.dtype
    before = _values(pairs)
    with te.apply_guard():
        je.apply()
        for (jp, tp), b in zip(pairs, before):
            assert torch.equal(tp.detach(), te._shadow[id(tp)])
            _close(tp, jp)
            assert not torch.equal(tp.detach(), b)
        je.restore()
    for (jp, tp), b in zip(pairs, before):
        assert torch.equal(tp.detach(), b)
        _close(tp, jp)
    state = te.state_dict()
    jstate = je.state_dict()
    assert set(state) == set(jstate) and state["step"] == 12
    fresh = topt.ExponentialMovingAverage(tm)
    fresh.set_state_dict({k: (v.clone() if torch.is_tensor(v) else v)
                          for k, v in state.items()})
    assert fresh._step == 12
    for _, tp in pairs:
        assert torch.equal(fresh._shadow[id(tp)], te._shadow[id(tp)])
    # a JAX state dict loads into the port's
    fresh.set_state_dict({k: (np.asarray(v.numpy()) if hasattr(v, "numpy")
                              else v) for k, v in jstate.items()})
    for _, tp in pairs:
        _close(fresh._shadow[id(tp)], te._shadow[id(tp)])


@pytest.mark.parametrize("rate,lo,hi", [(0.5, 2, 3), (0.15, 10000, 10000),
                                        (1.0, 1, 2)])
def test_model_average_matches_jax_step_by_step(rate, lo, hi):
    jm, tm = _models()
    pairs = _pairs(jm, tm)
    ja = jwrap.ModelAverage(rate, [jp for jp, _ in pairs], lo, hi)
    ta = topt.ModelAverage(rate, [tp for _, tp in pairs], lo, hi)
    rng = np.random.default_rng(1)
    for _ in range(7):
        _set_values(pairs, rng)
        ja.step()
        ta.step()
        assert ta._count == ja._count
        for jp, tp in pairs:
            _close(ta._sum[id(tp)], ja._sum[id(jp)])
    before = _values(pairs)
    ja.apply()
    with ta.apply_guard():
        for jp, tp in pairs:
            _close(tp, jp)
    ja.restore()
    for (jp, tp), b in zip(pairs, before):
        assert torch.equal(tp.detach(), b)
        _close(tp, jp)


def test_lookahead_matches_jax_step_by_step():
    jm, tm = _models()
    pairs = _pairs(jm, tm)
    jl = jwrap.Lookahead(jopt.SGD(learning_rate=0.1,
                                 parameters=[jp for jp, _ in pairs]),
                        alpha=0.5, k=2)
    tl = topt.Lookahead(topt.SGD(learning_rate=0.1,
                                 parameters=tm.named_parameters()),
                        alpha=0.5, k=2)
    assert tl.get_lr() == pytest.approx(0.1) and tl.k == 2
    rng = np.random.default_rng(2)
    first = _values(pairs)
    for i in range(5):
        for jp, tp in pairs:
            g = (0.1 * rng.standard_normal(tuple(tp.shape))).astype(
                np.float32)
            jp.grad = pt.Tensor(g)
            tp.grad = torch.from_numpy(g)
        jl.step()
        tl.step()
        if i == 0:  # the slow copy was taken before the first inner step
            for (_, tp), f in zip(pairs, first):
                assert torch.equal(tl._slow[id(tp)], f)
        for jp, tp in pairs:
            _close(tp, jp)
            _close(tl._slow[id(tp)], jl._slow[id(jp)])
        if (i + 1) % 2 == 0:  # a sync step: the fast weights take the slow
            for _, tp in pairs:
                assert torch.equal(tp.detach(), tl._slow[id(tp)])
        tl.clear_grad()
        assert all(tp.grad is None for _, tp in pairs)
    assert tl._steps == jl._steps == 5


def test_lookahead_follows_a_train_step():
    """``TrainStep`` drives a ``Lookahead`` through ``_step``: every k-th
    step the parameters are the slow weights, moved ``alpha`` toward the
    fast ones."""
    _, tm = _models()
    inner = topt.AdamW(learning_rate=1e-3)
    look = topt.Lookahead(inner, alpha=0.5, k=2)
    step = TrainStep(tm, look, lambda m, x: m(x, labels=x), device="cpu")
    assert inner._named is not None  # bound through the delegation
    ids = torch.from_numpy(np.random.default_rng(3).integers(
        0, 1024, (2, 16))).long()
    start = {n: p.detach().clone() for n, p in tm.named_parameters()}
    step(ids)
    fast = {n: p.detach().clone() for n, p in tm.named_parameters()}
    assert not all(torch.equal(fast[n], start[n]) for n in start)
    step(ids)
    assert look._steps == 2 and inner._global_step == 2
    for n, p in tm.named_parameters():
        assert torch.equal(p.detach(), look._slow[id(p)])


# -- DGC ----------------------------------------------------------------------

def _dgc_pair(**kw):
    return (jopt.DGCMomentum(**kw),
            lambda params: topt.DGCMomentum(parameters=params, **kw))


def _port_apply(make, params, grads, steps=1):
    """The port's eager steps from numpy params and grads; returns the
    params and the optimizer."""
    ts = [(n, torch.from_numpy(np.asarray(v).copy()).requires_grad_(True))
          for n, v in params.items()]
    opt = make(ts)
    for _ in range(steps):
        for n, t in ts:
            t.grad = torch.from_numpy(np.asarray(grads[n]).copy())
        opt.step()
    return {n: t.detach().numpy() for n, t in ts}, opt


def test_dgc_matches_momentum_during_warmup():
    params = {"w": np.random.RandomState(0).randn(4, 4).astype(np.float32)}
    grads = {"w": np.ones((4, 4), np.float32)}
    jd, make = _dgc_pair(learning_rate=0.1, momentum=0.9,
                         rampup_begin_step=100)
    jp, _ = jd.apply_gradients({"w": jnp.asarray(params["w"])},
                               {"w": jnp.asarray(grads["w"])},
                               jd.init({"w": jnp.asarray(params["w"])}))
    got, _ = _port_apply(make, params, grads)
    mom, _ = _port_apply(lambda ts: topt.Momentum(
        learning_rate=0.1, momentum=0.9, parameters=ts), params, grads)
    np.testing.assert_allclose(got["w"], np.asarray(jp["w"]), rtol=1e-6)
    np.testing.assert_array_equal(got["w"], mom["w"])


def test_dgc_sparsifies_and_keeps_error_feedback():
    jd, make = _dgc_pair(learning_rate=0.1, momentum=0.9,
                         rampup_begin_step=0, sparsity=[0.75])
    signs = np.where(np.arange(64) % 2 == 0, 1.0, -1.0)
    g = ((np.arange(64, dtype=np.float32) + 1.0) * signs).astype(np.float32)
    params = {"w": np.zeros((64,), np.float32)}
    jp, jst = jd.apply_gradients({"w": jnp.zeros((64,))},
                                 {"w": jnp.asarray(g)},
                                 jd.init({"w": jnp.zeros((64,))}))
    got, opt = _port_apply(make, params, {"w": g})
    applied = int((got["w"] != 0).sum())
    assert 4 <= applied <= 32
    v = opt._state["w"]["v"].numpy()
    assert int((v != 0).sum()) == 64 - applied
    # masked-out entries are kept, not lost
    np.testing.assert_allclose(v[v != 0], g[got["w"] == 0], rtol=1e-6)
    np.testing.assert_allclose(got["w"], np.asarray(jp["w"]), rtol=1e-6)
    for slot in ("u", "v", "velocity"):
        np.testing.assert_allclose(opt._state["w"][slot].numpy(),
                                   np.asarray(jst["slots"]["w"][slot]),
                                   rtol=1e-6)


def test_dgc_converges_on_quadratic_like_jax():
    kw = dict(learning_rate=0.01, momentum=0.9, rampup_begin_step=0,
              sparsity=[0.9])
    jd = jopt.DGCMomentum(**kw)
    target = np.random.RandomState(1).randn(32).astype(np.float32)
    jparams = {"w": jnp.zeros((32,), jnp.float32)}
    st = jd.init(jparams)

    @jax.jit
    def jstep(p, s):
        g = jax.grad(lambda q: ((q["w"] - jnp.asarray(target)) ** 2)
                     .sum())(p)
        return jd.apply_gradients(p, g, s)

    w = torch.zeros(32, requires_grad=True)
    opt = topt.DGCMomentum(parameters=[("w", w)], **kw)
    tt = torch.from_numpy(target)
    for i in range(300):
        jparams, st = jstep(jparams, st)
        w.grad = 2 * (w.detach() - tt)
        opt.step()
        if i < 5:  # the first steps against JAX's
            np.testing.assert_allclose(w.detach().numpy(),
                                       np.asarray(jparams["w"]), rtol=1e-5,
                                       atol=1e-7)
    err = float(((w.detach() - tt) ** 2).mean())
    assert err < 1e-2, err


def test_dgc_uniform_magnitudes_still_update():
    # ties at the quantile threshold must not starve the update
    _, make = _dgc_pair(learning_rate=0.1, momentum=0.9,
                        rampup_begin_step=0, sparsity=[0.999])
    params = {"b": np.zeros((4,), np.float32),
              "s": np.zeros((1,), np.float32)}
    grads = {"b": np.ones((4,), np.float32), "s": np.ones((1,), np.float32)}
    got, _ = _port_apply(make, params, grads)
    assert float(np.abs(got["b"]).max()) > 0, "uniform grads starved"
    assert float(np.abs(got["s"]).max()) > 0, "size-1 tensor starved"


@pytest.mark.parametrize("levels,begin,ramp", [
    ((0.999,), 0, 1), ((0.75, 0.9375, 0.984375, 0.996, 0.999), 2, 4),
    ((0.5, 0.9), 3, 7)])
def test_dgc_sparsity_ramp_matches_jax(levels, begin, ramp):
    kw = dict(rampup_begin_step=begin, rampup_step=ramp, sparsity=levels)
    jd = jopt.DGCMomentum(**kw)
    td = topt.DGCMomentum(parameters=[], **kw)
    for step in range(0, 14):
        assert td.sparsity_at(step) == np.float32(jd.sparsity_at(step)), \
            step


def test_dgc_steps_on_gpt_tiny_match_jax():
    """Three steps of every gpt_tiny parameter's gradient (seeded numpy),
    the ramp starting after one step of plain momentum."""
    jm, tm = _models()
    kw = dict(learning_rate=0.05, momentum=0.9, rampup_begin_step=1,
              rampup_step=2, sparsity=(0.75, 0.9, 0.99))
    jd = jopt.DGCMomentum(**kw)
    names = [n for n, _ in jm.named_parameters()]
    jparams = {n: p.value for n, p in jm.named_parameters()}
    st = jd.init(jparams)
    td = topt.DGCMomentum(parameters=tm.named_parameters(), **kw)
    tparams = dict(tm.named_parameters())
    rng = np.random.default_rng(4)
    for _ in range(3):
        grads = {n: rng.standard_normal(tuple(tparams[n].shape)).astype(
            np.float32) for n in names}
        jparams, st = jd.apply_gradients(
            jparams, {n: jnp.asarray(g) for n, g in grads.items()}, st)
        for n in names:
            tparams[n].grad = torch.from_numpy(grads[n])
        td.step()
    for n in names:
        np.testing.assert_allclose(tparams[n].detach().numpy(),
                                   np.asarray(jparams[n]), rtol=1e-5,
                                   atol=1e-6, err_msg=n)
        np.testing.assert_allclose(td._state[n]["v"].numpy(),
                                   np.asarray(st["slots"][n]["v"]),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
    assert "DGCMomentum" in topt.__all__ and not td._elementwise_update
