"""The port's optimizer surface against the JAX package's, on the CPU.

Every optimizer of ``paddle_tpu/optimizer/optimizer.py`` (with L2, L1
and decoupled decay where it takes them, and each gradient clip) runs 3
steps on the same numpy parameters and gradients in both packages: the
JAX ``apply_gradients`` with a float32 learning rate, the port's eager
``step``. ``fuse_optimizer`` runs on both sides, and in the port the
fused update gives the bits of the unfused one.

Tolerances, stated: fp32 on both sides, elementwise rules whose
operations (sqrt, division, pow, norms) the two libraries round alike up
to an ulp or two: parameters and slots within rtol 1e-5 / atol 1e-6.
Adam and Lamb divide by sqrt(v) + eps, which turns an ulp of v into an
ulp of the step, well inside that. bf16 parameters (``multi_precision``)
within one bf16 ulp (rtol 2^-7).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import jax.numpy as jnp
from paddle_tpu import optimizer as jopt
from paddle_tpu import regularizer as jreg

from paddle_tpu_torch import get_flags, set_flags
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.optimizer import optimizer as topt_mod

RTOL, ATOL = 1e-5, 1e-6
LR = 0.01
STEPS = 3
SHAPES = {"w": (8, 16), "ln.weight": (16,), "b": (16,), "v": (5, 3)}


def _data(seed=0):
    rng = np.random.default_rng(seed)
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in SHAPES.items()}
    grads = [{n: (3.0 * rng.standard_normal(s)).astype(np.float32)
              for n, s in SHAPES.items()} for _ in range(STEPS)]
    return params, grads


def _cases():
    """(id, factory(opt module, regularizer module) -> optimizer)."""
    return [
        ("SGD", lambda o, r: o.SGD(LR)),
        ("SGD-L2Decay", lambda o, r: o.SGD(LR, weight_decay=r.L2Decay(0.05))),
        ("SGD-L1Decay", lambda o, r: o.SGD(LR, weight_decay=r.L1Decay(0.05))),
        ("Momentum", lambda o, r: o.Momentum(LR, momentum=0.9)),
        ("Momentum-nesterov-wd",
         lambda o, r: o.Momentum(LR, momentum=0.8, use_nesterov=True,
                                 weight_decay=0.01)),
        ("Adagrad", lambda o, r: o.Adagrad(LR, initial_accumulator_value=0.1)),
        ("Adadelta", lambda o, r: o.Adadelta(1.0, rho=0.9)),
        ("RMSProp", lambda o, r: o.RMSProp(LR)),
        ("RMSProp-centered-momentum",
         lambda o, r: o.RMSProp(LR, momentum=0.9, centered=True)),
        ("Adam", lambda o, r: o.Adam(LR)),
        ("Adam-L2", lambda o, r: o.Adam(LR, weight_decay=0.01)),
        ("Adam-L1Decay",
         lambda o, r: o.Adam(LR, weight_decay=r.L1Decay(0.01))),
        ("AdamW", lambda o, r: o.AdamW(LR, weight_decay=0.05)),
        ("AdamW-L1Decay",
         lambda o, r: o.AdamW(LR, weight_decay=r.L1Decay(0.05))),
        ("AdamW-decay-fun",
         lambda o, r: o.AdamW(LR, apply_decay_param_fun=lambda n: False)),
        ("Adam-multi_precision",
         lambda o, r: o.Adam(LR, multi_precision=True)),
        ("Adamax", lambda o, r: o.Adamax(LR)),
        ("Lamb", lambda o, r: o.Lamb(LR, lamb_weight_decay=0.01)),
        ("LarsMomentum", lambda o, r: o.LarsMomentum(LR)),
        ("Ftrl", lambda o, r: o.Ftrl(LR, l1=0.001, l2=0.001)),
        ("Dpsgd-noise-free",
         lambda o, r: o.Dpsgd(LR, clip=2.0, batch_size=4.0, sigma=0.0)),
        ("DecayedAdagrad", lambda o, r: o.DecayedAdagrad(LR)),
        ("Rprop", lambda o, r: o.Rprop(LR)),
        ("Adam-ClipGradByValue",
         lambda o, r: o.Adam(LR, grad_clip=o.ClipGradByValue(0.5))),
        ("Adam-ClipGradByNorm",
         lambda o, r: o.Adam(LR, grad_clip=o.ClipGradByNorm(1.0))),
        ("AdamW-ClipGradByGlobalNorm",
         lambda o, r: o.AdamW(LR, grad_clip=o.ClipGradByGlobalNorm(1.0))),
        ("SGD-ClipGradByValue-min",
         lambda o, r: o.SGD(LR, grad_clip=o.ClipGradByValue(0.5, -0.25))),
        ("Momentum-ClipGradByNorm",
         lambda o, r: o.Momentum(LR, grad_clip=o.ClipGradByNorm(2.0))),
    ]


CASES = _cases()
IDS = [c[0] for c in CASES]
FACTORIES = [c[1] for c in CASES]


def _jax_run(make, params, grads, fuse=False):
    opt = make(jopt, jreg)
    prev = pt.get_flags("fuse_optimizer")
    pt.set_flags({"fuse_optimizer": fuse})
    try:
        jp = {n: jnp.asarray(v) for n, v in params.items()}
        js = opt.init(jp)
        for g in grads:
            jp, js = opt.apply_gradients(
                jp, {n: jnp.asarray(v) for n, v in g.items()}, js,
                lr=jnp.asarray(LR if not isinstance(opt, jopt.Adadelta)
                               else 1.0, jnp.float32))
    finally:
        pt.set_flags(prev)
    return ({n: np.asarray(v) for n, v in jp.items()},
            {n: {k: np.asarray(v) for k, v in s.items()}
             for n, s in js["slots"].items()})


def _torch_run(make, params, grads, fuse=False, dtype=torch.float32):
    tp = [(n, torch.nn.Parameter(torch.from_numpy(v.copy()).to(dtype)))
          for n, v in params.items()]
    opt = make(topt, treg)
    opt.bind(tp)
    prev = get_flags("fuse_optimizer")["fuse_optimizer"]
    set_flags({"fuse_optimizer": fuse})
    try:
        for g in grads:
            for n, p in tp:
                p.grad = torch.from_numpy(g[n].copy()).to(dtype)
            opt.step()
    finally:
        set_flags({"fuse_optimizer": prev})
    state = opt.state_dict()
    assert state["global_step"] == len(grads)
    slots = {}
    for key, v in state.items():
        if key != "global_step":
            name, _, slot = key.rpartition(".")
            slots.setdefault(name, {})[slot] = v
    return {n: p.detach() for n, p in tp}, slots


def _assert_match(got, want, rtol=RTOL, atol=ATOL):
    gp, gs = got
    wp, ws = want
    if "noise_id" in ws["w"]:
        assert sorted(int(gs[n]["noise_id"]) for n in SHAPES) == sorted(
            int(ws[n]["noise_id"]) for n in SHAPES)
    for n in SHAPES:
        np.testing.assert_allclose(gp[n].float().numpy(), wp[n], rtol=rtol,
                                   atol=atol, err_msg=n)
        assert set(gs.get(n, {})) == set(ws[n]), n
        for k, v in ws[n].items():
            if k == "noise_id":  # Dpsgd's ids follow each side's order
                continue
            np.testing.assert_allclose(
                np.asarray(gs[n][k].float()), np.asarray(v, np.float32),
                rtol=rtol, atol=atol, err_msg=f"{n}.{k}")


@pytest.mark.parametrize("make", FACTORIES, ids=IDS)
def test_optimizer_matches_jax_apply_gradients(make):
    params, grads = _data()
    _assert_match(_torch_run(make, params, grads),
                  _jax_run(make, params, grads))


@pytest.mark.parametrize("make", FACTORIES, ids=IDS)
def test_fuse_optimizer_matches_jax_and_the_unfused_bits(make):
    """Under ``fuse_optimizer`` each side groups by (dtype, slot dtypes):
    the port's result is the unfused one, bit for bit, and the JAX
    fused one within the tolerance."""
    params, grads = _data(1)
    fused = _torch_run(make, params, grads, fuse=True)
    plain = _torch_run(make, params, grads, fuse=False)
    for n in SHAPES:
        assert torch.equal(fused[0][n], plain[0][n]), n
        for k, v in plain[1].get(n, {}).items():
            assert torch.equal(fused[1][n][k], v), f"{n}.{k}"
    _assert_match(fused, _jax_run(make, params, grads, fuse=True))


def test_adam_multi_precision_bf16_matches_jax():
    """bf16 parameters with fp32 moments (``multi_precision``): the
    moments within the fp32 tolerance, the parameters within one bf16
    ulp of the JAX ones."""
    params, grads = _data(2)
    params = {n: np.asarray(torch.from_numpy(v).bfloat16().float())
              for n, v in params.items()}
    grads = [{n: np.asarray(torch.from_numpy(v).bfloat16().float())
              for n, v in g.items()} for g in grads]

    def make(o, r):
        return o.AdamW(LR, multi_precision=True)

    jo = make(jopt, jreg)
    jp = {n: jnp.asarray(v, jnp.bfloat16) for n, v in params.items()}
    js = jo.init(jp)
    for g in grads:
        jp, js = jo.apply_gradients(
            jp, {n: jnp.asarray(v, jnp.bfloat16) for n, v in g.items()}, js,
            lr=jnp.asarray(LR, jnp.float32))
    gp, gs = _torch_run(make, params, grads, dtype=torch.bfloat16)
    for n in SHAPES:
        assert gp[n].dtype == torch.bfloat16
        assert gs[n]["moment1"].dtype == torch.float32
        np.testing.assert_allclose(gp[n].float().numpy(),
                                   np.asarray(jp[n], np.float32),
                                   rtol=2.0 ** -7, atol=ATOL, err_msg=n)
        for k in ("moment1", "moment2"):
            np.testing.assert_allclose(gs[n][k].numpy(),
                                       np.asarray(js["slots"][n][k]),
                                       rtol=RTOL, atol=ATOL)


def test_fuse_optimizer_updates_one_group_per_dtype(monkeypatch):
    """Adam under ``fuse_optimizer`` hands each (dtype, slot dtypes)
    group to one ``adam_update`` call, one call a parameter without it;
    rules that are not elementwise (Lamb) and ``apply_decay_param_fun``
    keep one update a parameter, as in ``_apply_flat``."""
    calls = []
    real = topt_mod.adam_update

    def spy(params, *a, **kw):
        calls.append(len(params))
        return real(params, *a, **kw)

    monkeypatch.setattr(topt_mod, "adam_update", spy)
    dtypes = [torch.float32, torch.bfloat16, torch.float32, torch.bfloat16,
              torch.float32]
    named = [(f"p{i}", torch.nn.Parameter(torch.ones(4, dtype=dt)))
             for i, dt in enumerate(dtypes)]
    for fuse, want in ((True, [3, 2]), (False, [1] * 5)):
        calls.clear()
        opt = topt.AdamW(LR, parameters=named)
        set_flags({"fuse_optimizer": fuse})
        try:
            for _, p in named:
                p.grad = torch.full_like(p, 0.5)
            opt.step()
        finally:
            set_flags({"fuse_optimizer": False})
        assert sorted(calls, reverse=True) == want
    calls.clear()
    with_fun = topt.AdamW(LR, parameters=named,
                          apply_decay_param_fun=lambda n: True)
    set_flags({"fuse_optimizer": True})
    try:
        with_fun.step()
    finally:
        set_flags({"fuse_optimizer": False})
    assert calls == [1] * 5
    groups = []
    lamb = topt.Lamb(LR, parameters=named)
    monkeypatch.setattr(lamb, "_update_group", lambda v, *a: groups.append(
        len(v)))
    set_flags({"fuse_optimizer": True})
    try:
        lamb.step()
    finally:
        set_flags({"fuse_optimizer": False})
    assert groups == [1] * 5


def test_flags_surface():
    """``get_flags``/``set_flags`` at the package top, as in the JAX
    package: the default is the JAX default, strings parse by type, an
    unknown flag raises."""
    assert get_flags("fuse_optimizer") == {"fuse_optimizer": False}
    assert pt.get_flags("fuse_optimizer")["fuse_optimizer"] is False
    set_flags({"fuse_optimizer": "true"})
    try:
        assert get_flags(["fuse_optimizer"])["fuse_optimizer"] is True
    finally:
        set_flags({"fuse_optimizer": False})
    with pytest.raises(KeyError):
        set_flags({"no_such_flag": 1})


def test_dpsgd_noise_is_gaussian_independent_and_replayable():
    """Dpsgd's noise has the std ``clip * sigma / batch``, differs between
    two parameters of one shape (JAX folds a per-parameter id into its
    key: ``tests/test_optimizer.py``), differs between steps, and is the
    same again from the same (seed, step, parameter)."""
    n = 20000

    def run(seed=0, steps=1):
        named = [(k, torch.nn.Parameter(torch.zeros(n))) for k in "ab"]
        opt = topt.Dpsgd(1.0, clip=1.0, batch_size=2.0, sigma=3.0,
                         parameters=named, seed=seed)
        out = []
        for _ in range(steps):
            before = [p.detach().clone() for _, p in named]
            for _, p in named:
                p.grad = torch.zeros(n)
            opt.step()
            out.append([b - p.detach() for b, (_, p) in zip(before, named)])
        return out

    (a, b), (a2, _) = run(steps=2)
    assert abs(float(a.std()) - 1.5) < 0.05 and abs(float(a.mean())) < 0.05
    corr = float(torch.corrcoef(torch.stack([a, b]))[0, 1])
    assert abs(corr) < 0.05 and not torch.equal(a, b)
    assert not torch.equal(a, a2)
    ((again, _),) = run()
    assert torch.equal(again, a)
    ((other, _),) = run(seed=1)
    assert not torch.equal(other, a)


def test_minimize_and_clear_gradients():
    w = torch.nn.Parameter(torch.tensor([1.0, -2.0]))
    opt = topt.SGD(0.5, parameters=[("w", w)])
    loss = (w * w).sum()
    opt.minimize(loss)
    assert torch.equal(w.detach(), torch.tensor([0.0, 0.0]))
    opt.clear_gradients()
    assert w.grad is None
    with pytest.raises(TypeError, match="iterable"):
        topt.SGD(0.1, parameters=w)
