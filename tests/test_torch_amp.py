"""The port's mixed precision against the JAX package's, on the CPU.

- ``auto_cast``: the (op name, target dtype) multiset that the port's
  hook (``amp.record_casts``) sees on ``gpt_tiny``'s forward and loss
  equals the one the JAX dispatch layer's ``call_fn`` sees, for the
  default config, ``loss_chunk_size``, ``remat`` and
  ``remat_save_attention``, in bf16 and fp16, at O1 and O2; logits,
  loss and every gradient against JAX's on the same weights, the
  gradients in fp32; the remat and fused-optimizer paths bitwise the
  plain one; ``TrainStep`` with a ``train_fn`` that enters ``auto_cast``
  against the JAX ``TrainStep``; ``decorate``.
- ``GradScaler``: the scale's path, the good and bad counters and the
  parameters over 12 steps with planted infs against JAX's, in the
  reference's ``scale -> backward -> step -> update`` loop (``step``
  updates too, so each loop updates twice); ``enable=False``,
  ``minimize``, ``state_dict``.
- fp16 storage: the plain versions of the attention kernels and of
  ``adam_update`` in fp16 against the JAX functions (the Pallas kernels
  in interpret mode, the JAX Adam rule with fp16 slots).

Tolerances, stated with u the amp dtype's unit roundoff (bf16 2^-8,
fp16 2^-11). Both packages cast at the same points with the same
round-to-nearest-even, but each product sums in fp32 in its own order,
so an output can round to the neighbouring value on one side; logits
are held within 4u of their largest magnitude (one ulp is at most 2u of
it; 2u seen at gpt_tiny), gradients within 16u of each tensor's largest
entry (the one-ulp differences travel through the backward: ~5u seen).
"""

import _torch_threads  # noqa: F401

import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import amp as jamp
from paddle_tpu import dispatch
from paddle_tpu import optimizer as jopt
from paddle_tpu.amp.auto_cast import amp_state as jamp_state
from paddle_tpu.amp.auto_cast import amp_target_dtype as jamp_target
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import folded_attention as jfo

from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import set_flags
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops.kernels import attention as tat
from paddle_tpu_torch.ops.kernels import optimizer_update as OU
from paddle_tpu_torch.optimizer import SGD, AdamW

U = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}
TORCH = {"bfloat16": torch.bfloat16, "float16": torch.float16}
CONFIGS = {"default": {}, "chunked": dict(loss_chunk_size=8),
           "remat": dict(remat=True),
           "remat_save_attention": dict(remat=True,
                                        remat_save_attention=True,
                                        loss_chunk_size=8)}


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


def _models(**cfg):
    pt.seed(0)
    jm = jgpt.GPTForCausalLM(jgpt.gpt_tiny(**cfg))
    tm = tgpt.GPTForCausalLM(tgpt.gpt_tiny(**cfg), device="cpu")
    tgpt.load_jax_state(tm, jgpt.checkpoint_state(jm))
    return jm, tm


def _ids(b=2, s=16, seed=0):
    return np.random.default_rng(seed).integers(0, 1024, (b, s)).astype(
        np.int32)


def _name(dtype):
    """A JAX or torch dtype as 'float32' / 'bfloat16' / 'float16'."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


@pytest.fixture
def jax_casts(monkeypatch):
    """The (op name, target dtype) of every op the JAX dispatch layer
    runs under ``auto_cast``, as ``call_fn`` sees it."""
    seen = []
    orig = dispatch.call_fn

    def spy(fn, name, *args, **kw):
        if jamp_state() is not None:
            seen.append((name, _name(jamp_target(name))))
        return orig(fn, name, *args, **kw)

    monkeypatch.setattr(dispatch, "call_fn", spy)
    return seen


def _listed(pairs):
    return collections.Counter((n, d) for n, d in pairs if d is not None)


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_cast_multiset_matches_jax_call_fn(jax_casts, config, dtype,
                                           level):
    """Forward and loss: the same ops cast, to the same dtypes, as many
    times, except that the JAX chunked loss traces its scan body once
    (one ``cross_entropy``) where the port runs it once a chunk."""
    jm, tm = _models(**CONFIGS[config])
    ids = _ids()
    ti = torch.from_numpy(ids).long()
    for labels in (False, True):
        jax_casts.clear()
        with jamp.auto_cast(dtype=dtype, level=level):
            jm(pt.Tensor(ids), labels=pt.Tensor(ids) if labels else None)
        with tamp.record_casts() as got, tamp.auto_cast(dtype=dtype,
                                                        level=level):
            tm(ti, labels=ti if labels else None)
        want = _listed(jax_casts)
        have = _listed((n, _name(d)) for n, d in got)
        chunks = -(-(ids.shape[1] - 1) // 8)
        if labels and "loss_chunk_size" in CONFIGS[config] and \
                level == "O1":
            assert want.pop(("cross_entropy", "float32")) == 1
            assert have.pop(("cross_entropy", "float32")) == chunks
        assert have == want
        assert sum(want.values()) > 0
        # O2 keeps the black list's ops in their own dtype
        assert all(d == dtype for _, d in want) == (level == "O2")


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_logits_loss_and_grads_under_auto_cast_match_jax(dtype):
    jm, tm = _models()
    u = U[dtype]
    ids = _ids(s=32)
    ti = torch.from_numpy(ids).long()
    with jamp.auto_cast(dtype=dtype):
        jlog = np.asarray(jm(pt.Tensor(ids)).numpy(), np.float32)
        jl = jm(pt.Tensor(ids), labels=pt.Tensor(ids))
    jl.backward()
    with tamp.auto_cast(dtype=dtype):
        tlog = tm(ti)
        tl = tm(ti, labels=ti)
    tl.backward()
    assert tlog.dtype == TORCH[dtype] and tl.dtype == torch.float32
    np.testing.assert_allclose(tlog.detach().float().numpy(), jlog,
                               atol=4 * u * np.abs(jlog).max(), rtol=0)
    np.testing.assert_allclose(float(tl.detach()), float(jl.numpy()),
                               rtol=4 * u)
    jg = {n: np.asarray(p.grad.numpy(), np.float32)
          for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, n
        np.testing.assert_allclose(p.grad.numpy(), jg[n],
                                   atol=16 * u * np.abs(jg[n]).max(),
                                   rtol=0, err_msg=n)


def _grads(tm, ids, dtype):
    tm.zero_grad(set_to_none=True)
    with tamp.auto_cast(dtype=dtype):
        loss = tm(ids, labels=ids)
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in tm.named_parameters()}


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_remat_paths_cast_where_the_plain_path_does(dtype):
    """remat and remat_save_attention recompute each block under the
    forward's ``auto_cast`` state (on the backward's thread, after the
    context has closed): loss and gradients bitwise the plain path's."""
    ids = torch.from_numpy(_ids()).long()
    _, tm = _models()
    want = _grads(tm, ids, dtype)
    for cfg in (dict(remat=True),
                dict(remat=True, remat_save_attention=True)):
        _, rm = _models(**cfg)
        loss, grads = _grads(rm, ids, dtype)
        assert torch.equal(loss, want[0])
        for n, g in grads.items():
            assert torch.equal(g, want[1][n]), (cfg, n)


def _train_fn(dtype):
    def fn(m, x):
        with tamp.auto_cast(dtype=dtype):
            return m(x, labels=x)
    return fn


def _jax_train_fn(dtype):
    def fn(m, x):
        with jamp.auto_cast(dtype=dtype):
            return m(x, labels=x)
    return fn


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_train_step_under_auto_cast_matches_jax(dtype):
    """``TrainStep`` whose ``train_fn`` enters ``auto_cast`` against the
    JAX ``TrainStep`` (which traces the casts into its step): losses,
    and parameters after the steps (fp32 master weights) within what
    AdamW makes of gradients 16u apart (2 lr a step)."""
    jm, tm = _models()
    batches = np.stack([_ids(s=32, seed=i) for i in range(2)])
    js = JTrainStep(jm, jopt.AdamW(learning_rate=1e-3), _jax_train_fn(dtype))
    want = np.asarray(js.multi_step(jnp.asarray(batches)))
    js.sync_to_model()
    ts = TrainStep(tm, AdamW(learning_rate=1e-3), _train_fn(dtype),
                   device="cpu")
    got = ts.multi_step(torch.from_numpy(batches).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=4 * U[dtype])
    jstate = jgpt.checkpoint_state(jm)
    for n, p in tm.named_parameters():
        assert p.dtype == torch.float32
        np.testing.assert_allclose(p.detach().numpy(), jstate[n],
                                   atol=2 * 1e-3 * 2, rtol=0, err_msg=n)


def test_fused_optimizer_step_under_auto_cast_is_bitwise_unfused():
    ids = torch.from_numpy(np.stack([_ids(s=32, seed=i)
                                     for i in range(2)])).long()
    states = []
    for fuse in (False, True):
        _, tm = _models()
        set_flags({"fuse_optimizer": fuse})
        try:
            TrainStep(tm, AdamW(learning_rate=1e-3), _train_fn("bfloat16"),
                      device="cpu").multi_step(ids)
        finally:
            set_flags({"fuse_optimizer": False})
        states.append({n: p.detach().clone()
                       for n, p in tm.named_parameters()})
    for n, t in states[0].items():
        assert torch.equal(t, states[1][n]), n


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_decorate_casts_the_model_like_jax(dtype):
    jm, tm = _models()
    assert tamp.decorate(tm, level="O2", dtype=dtype) is tm
    jamp.decorate(jm, level="O2", dtype=dtype)
    jd = {n: _name(p.dtype) for n, p in jm.named_parameters()}
    assert {n: _name(p.dtype) for n, p in tm.named_parameters()} == jd
    assert set(jd.values()) == {dtype}
    opt = AdamW(learning_rate=1e-3)
    assert tamp.decorate(tm, opt, level="O1") == (tm, opt)
    ids = torch.from_numpy(_ids()).long()
    with tamp.auto_cast(level="O2", dtype=dtype):
        loss = tm(ids, labels=ids)
    assert loss.dtype == TORCH[dtype]


def test_auto_cast_state_is_thread_local_and_nests():
    import threading
    seen = {}
    with tamp.auto_cast(dtype="float16", custom_black_list={"linear"}):
        assert tamp.amp_target_dtype("linear") == torch.float32
        with tamp.auto_cast(enable=False):
            assert tamp.amp_state() is None
        assert tamp.amp_target_dtype("matmul") == torch.float16
        t = threading.Thread(
            target=lambda: seen.setdefault("other", tamp.amp_state()))
        t.start()
        t.join()
    assert seen["other"] is None and tamp.amp_state() is None
    x = torch.ones(2)
    assert tamp.amp_cast("linear", x, None)[0] is x
    assert tamp.AMP_WHITE_LIST == jamp.AMP_WHITE_LIST
    assert tamp.AMP_BLACK_LIST == jamp.AMP_BLACK_LIST


# -- GradScaler ---------------------------------------------------------------

# steps whose gradient carries a planted inf (0-based)
INF_STEPS = (2, 3, 4, 8)


def _scaler_run(side, n_steps=12, **kw):
    """``n_steps`` of the reference loop on a two-layer tanh model with
    SGD, an inf planted in a gradient at ``INF_STEPS`` unless the scaler
    is disabled (it would pass it on): returns the scale, good and bad
    counters and parameters after every step."""
    rng = np.random.default_rng(5)
    w1 = (0.5 * rng.standard_normal((6, 8))).astype(np.float32)
    w2 = (0.5 * rng.standard_normal((8, 3))).astype(np.float32)
    xs = rng.standard_normal((n_steps, 4, 6)).astype(np.float32)
    ys = rng.standard_normal((n_steps, 4, 3)).astype(np.float32)
    out = []
    if side == "jax":
        from paddle_tpu.amp import GradScaler as JScaler
        ps = [pt.Parameter(w) for w in (w1, w2)]
        opt = jopt.SGD(learning_rate=0.1, parameters=ps)
        sc = JScaler(**kw)
    else:
        ps = [torch.from_numpy(w.copy()).requires_grad_(True)
              for w in (w1, w2)]
        opt = SGD(learning_rate=0.1, parameters=ps)
        sc = tamp.GradScaler(**kw)
    for i in range(n_steps):
        if side == "jax":
            x, y = pt.Tensor(xs[i]), pt.Tensor(ys[i])
            loss = (((x @ ps[0]).tanh() @ ps[1] - y) ** 2).mean()
        else:
            x, y = torch.from_numpy(xs[i]), torch.from_numpy(ys[i])
            loss = (((x @ ps[0]).tanh() @ ps[1] - y) ** 2).mean()
        sc.scale(loss).backward()
        if i in INF_STEPS and kw.get("enable", True):
            if side == "jax":
                g = ps[1].grad
                g.value = g.value.at[1, 2].set(jnp.inf)
            else:
                ps[1].grad[1, 2] = float("inf")
        sc.step(opt)
        sc.update()
        opt.clear_grad()
        out.append((sc.get_loss_scaling(), sc._good_steps, sc._bad_steps,
                    [np.asarray(p.numpy() if side == "jax"
                                else p.detach().numpy()).copy()
                     for p in ps]))
    return out, sc


@pytest.mark.parametrize("kw", [
    dict(),
    dict(init_loss_scaling=8.0, incr_every_n_steps=2,
         decr_every_n_nan_or_inf=1),
    dict(init_loss_scaling=4.0, incr_every_n_steps=3,
         decr_every_n_nan_or_inf=2, decr_ratio=0.25),
    dict(init_loss_scaling=1.0, decr_every_n_nan_or_inf=1),
    dict(init_loss_scaling=16.0, use_dynamic_loss_scaling=False),
    dict(enable=False)], ids=["defaults", "fast", "quarter", "floor",
                              "static", "disabled"])
def test_grad_scaler_path_matches_jax(kw):
    want, jsc = _scaler_run("jax", **kw)
    got, tsc = _scaler_run("torch", **kw)
    for step, ((js, jg, jb, jp), (ts, tg, tb, tp)) in enumerate(
            zip(want, got)):
        assert (ts, tg, tb) == (js, jg, jb), step
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    assert tsc.state_dict() == jsc.state_dict()
    if kw.get("enable", True):
        # a planted inf leaves the parameters as they were
        for i in INF_STEPS:
            for a, b in zip(got[i][3], got[i - 1][3]):
                np.testing.assert_array_equal(a, b)
    if kw == dict(init_loss_scaling=8.0, incr_every_n_steps=2,
                  decr_every_n_nan_or_inf=1):
        # step() updates, then the loop's update() counts a good step:
        # two updates a step move the scale every step
        assert [s for s, _, _, _ in got][:3] == [16.0, 32.0, 16.0]


def test_grad_scaler_unscales_in_place_and_flags_once():
    w = torch.tensor([1.0, 2.0], requires_grad=True)
    opt = SGD(learning_rate=0.1, parameters=[w])
    sc = tamp.AmpScaler(init_loss_scaling=4.0)
    (w * torch.tensor([1.0, 3.0])).sum().mul(4.0).backward()
    g = w.grad
    w.grad[1] = float("nan")
    sc.unscale_(opt)
    assert w.grad is g and sc._found_inf
    assert g[0] == 1.0 and torch.isnan(g[1])
    sc.update()
    assert sc._bad_steps == 1 and not sc._found_inf
    state = sc.state_dict()
    fresh = tamp.GradScaler()
    fresh.load_state_dict(state)
    assert fresh.get_loss_scaling() == 4.0 and fresh._bad_steps == 1
    x = torch.ones(())
    assert tamp.GradScaler(enable=False).scale(x) is x
    m = tamp.GradScaler(init_loss_scaling=2.0)
    v = torch.tensor([3.0], requires_grad=True)
    o = SGD(learning_rate=0.5, parameters=[v])
    m.minimize(o, m.scale((v * 2.0).sum()))
    np.testing.assert_allclose(v.detach().numpy(), [2.0])
    assert m.get_loss_scaling() == 2.0 and m._good_steps == 1


# -- fp16 storage: the plain versions against the JAX functions ------------

@pytest.fixture
def _interpret(monkeypatch):
    for mod in (jfa, jfo):
        monkeypatch.setattr(mod.pl, "pallas_call",
                            functools.partial(mod.pl.pallas_call,
                                              interpret=True))
    yield


def _half_inputs(seed, s, d, h=2):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((1, s, h, d)).astype(np.float16)
               for _ in range(3))
    do = (0.1 * rng.standard_normal((1, s, h, d))).astype(np.float16)
    return q, k, v, do


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _assert_rel(got, want, k, u, name=""):
    """Within ``k`` u of ``want``'s largest magnitude."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=k * u * np.abs(want).max(),
                               err_msg=name)


# The JAX kernels keep fp16 operands with fp32 accumulators and take
# P as fp16 into P.V; the plain versions compute in fp32 and round the
# outputs. Outputs within 4u of their largest magnitude (the rounding
# of P and of the output), lse within 1e-5 (fp32 scores of the same fp16
# inputs on both sides).
@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_fp16_flash_plain_versions_match_jax(_interpret, s, causal):
    q, k, v, do = _half_inputs(900 + s + causal, s, 64)
    u = U["float16"]

    def f(qq, kk, vv):
        return jfa.flash_attention_lse(qq, kk, vv, causal=causal,
                                       block_q=128, block_k=128)
    with jfa.force_flash_for_aot():
        (jo, jl), vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
        jg = vjp((jnp.asarray(do), jnp.zeros(jl.shape, jl.dtype)))
    tq, tk, tv, tdo = (_t(x) for x in (q, k, v, do))
    out, lse = tat.attention_reference(tq, tk, tv, causal=causal)
    assert out.dtype == torch.float16 and lse.dtype == torch.float32
    _assert_rel(out, jo, 4, u)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=1e-5)
    delta = (tdo.float() * out.float()).sum(-1)
    got = tat.attention_bwd_reference(tq, tk, tv, tdo, lse, delta,
                                      causal=causal)
    for name, g, w in zip("qkv", got, jg):
        assert g.dtype == torch.float16
        _assert_rel(g, w, 8, u, f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_fp16_folded_plain_versions_match_jax(_interpret, causal):
    q, k, v, do = _half_inputs(950 + causal, 128, 64)
    u = U["float16"]
    with jfa.force_flash_for_aot():
        jo, vjp = jax.vjp(functools.partial(jfo.folded_attention,
                                            causal=causal),
                          *(jnp.asarray(x) for x in (q, k, v)))
        jg = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (_t(x) for x in (q, k, v, do))
    out, _ = tat.attention_reference(tq, tk, tv, causal=causal)
    _assert_rel(out, jo, 4, u)
    got = tat.folded_bwd_reference(tq, tk, tv, tdo, causal=causal)
    for name, g, w in zip("qkv", got, jg):
        assert g.dtype == torch.float16
        _assert_rel(g, w, 8, u, f"d{name}")


def _fp16_adam(decay, eps):
    """3 steps of fp16 parameters with fp16 slots, as the JAX Adam keeps
    them: the JAX ``_apply_flat`` and the plain version on the same
    numpy inputs; returns both sides' parameters and moments."""
    jcls, wd, mode = {"none": (jopt.Adam, 0.0, OU.DECAY_NONE),
                      "L2": (jopt.Adam, 0.05, OU.DECAY_L2),
                      "decoupled": (jopt.AdamW, 0.05,
                                    OU.DECAY_DECOUPLED)}[decay]
    rng = np.random.default_rng(11)
    shapes = ((7, 9), (16,), (1,), (300,))
    params = [rng.standard_normal(s).astype(np.float16) for s in shapes]
    grads = [[(0.1 * rng.standard_normal(s)).astype(np.float16)
              for s in shapes] for _ in range(3)]
    jo = jcls(learning_rate=1e-3, weight_decay=wd, epsilon=eps)
    jv = [jnp.asarray(p) for p in params]
    js = [jo._init_state(x) for x in jv]
    tp = [_t(p) for p in params]
    tm = [torch.zeros_like(p) for p in tp]
    tv = [torch.zeros_like(p) for p in tp]
    for step, gs in enumerate(grads, start=1):
        jv, js = jo._apply_flat(jv, [jnp.asarray(g) for g in gs], js, 1e-3,
                                step)
        OU.adam_update(tp, [_t(g) for g in gs], tm, tv, lr=1e-3,
                       beta1=0.9, beta2=0.999, eps=eps, step=step,
                       weight_decay=wd, decay=mode)
    return (tp, tm, tv), (jv, [s["moment1"] for s in js],
                          [s["moment2"] for s in js])


@pytest.mark.parametrize("decay", ["none", "L2", "decoupled"])
def test_fp16_adam_plain_version_matches_the_jax_rule(decay):
    """The port's moments are fp16 ops with f32 scalars where JAX
    multiplies by the scalars rounded to fp16, and both take the step in
    f32 (JAX's float32 bias corrections promote it): moments within a
    few fp16 ulps (2^-7 relative) or 2^-9 of the largest; each step
    rounds a parameter to fp16 on each side, and a step that differs by
    a rounding can land one ulp apart, so parameters within three ulps
    of their size (2^-8 relative) after three steps. At eps = 1e-4, which
    fp16 holds: where v is subnormal, the step m / (sqrt(v_hat) + 1e-8)
    turns on v's last bit, and that bit differs with the scalars'
    rounding (held below for finiteness alone)."""
    (tp, tm, tv), (jv, jm1, jm2) = _fp16_adam(decay, 1e-4)
    for i in range(len(tp)):
        assert tp[i].dtype == tm[i].dtype == torch.float16
        assert jm1[i].dtype == jnp.float16
        np.testing.assert_allclose(tp[i].float().numpy(),
                                   np.asarray(jv[i], np.float32),
                                   rtol=2.0 ** -8, atol=1e-7)
        for t, w in ((tm[i], jm1[i]), (tv[i], jm2[i])):
            w = np.asarray(w, np.float32)
            np.testing.assert_allclose(
                t.float().numpy(), w, rtol=2.0 ** -7,
                atol=2.0 ** -9 * np.abs(w).max())
    assert (torch.float16, torch.float16) in OU.KERNEL_DTYPES


@pytest.mark.parametrize("decay", ["none", "L2", "decoupled"])
def test_fp16_adam_at_the_default_eps_stays_finite_like_jax(decay):
    """At eps = 1e-8, which rounds to 0 in fp16, a v that underflows
    would divide by zero if the step ran in fp16: both sides take it in
    f32 and every parameter stays finite."""
    (tp, _, _), (jv, _, _) = _fp16_adam(decay, 1e-8)
    for t, j in zip(tp, jv):
        assert torch.isfinite(t).all()
        assert np.isfinite(np.asarray(j, np.float32)).all()
