"""The port's training path against the JAX package's, on the CPU.

``TrainStep`` + ``AdamW`` over ``GPTForCausalLM`` (``gpt_tiny``, the
JAX model's weights loaded with ``load_jax_state``) against the JAX
``TrainStep`` on the same numpy batches; the cross entropy with
``ignore_index``; one ``AdamW`` step with weight decay and
``ClipGradByGlobalNorm`` against the JAX ``apply_gradients``; resuming
from a JAX ``opt_state``; remat and the chunked loss against the full
loss; dropout drawn from the step's generator.

Tolerances, stated: losses within 1e-5 relative (fp32 on both sides,
sums in different orders). Parameters after three AdamW steps within
2e-5 absolute: each step moves a weight by at most ~lr = 1e-3 times
m/sqrt(v), and gradients that differ by ~1e-6 relative move that ratio
by as much for all but the smallest gradients. The one exception is
the key bias, whose gradient is 0 up to rounding (see
``_assert_params_close``).
"""

import _torch_threads

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.ops import nn_functional as JF
from paddle_tpu.tensor import Tensor

from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops import nn_functional as TF
from paddle_tpu_torch.optimizer import (AdamW, ClipGradByGlobalNorm,
                                        load_jax_optimizer_state)

LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5
LR = 1e-3


def _fn(m, x):
    return m(x, labels=x)


def _models(**cfg):
    pt.seed(0)
    jm = jgpt.GPTForCausalLM(jgpt.gpt_tiny(**cfg))
    tm = tgpt.GPTForCausalLM(tgpt.gpt_tiny(**cfg), device="cpu")
    tgpt.load_jax_state(tm, jgpt.checkpoint_state(jm))
    return jm, tm


def _batches(n, b=2, s=32, seed=0):
    return np.random.default_rng(seed).integers(
        0, 1024, (n, b, s)).astype(np.int32)


def _assert_params_close(jm, tm, atol, steps):
    """Every parameter within ``atol``, except the key third of each
    ``qkv_proj.bias``: softmax is invariant to it, so its gradient is 0
    up to rounding, and Adam scales that noise to steps of ~lr whose
    sign differs between the frameworks. It is held to the 2 * lr *
    steps two Adam trajectories can drift apart, and its gradient to
    rounding size."""
    want = jgpt.checkpoint_state(jm)
    got = tgpt.checkpoint_state(tm)
    e = tm.config.hidden_size
    for name, arr in want.items():
        g = got[name]
        if name.endswith("qkv_proj.bias"):
            np.testing.assert_allclose(g[e:2 * e], arr[e:2 * e],
                                       atol=2 * LR * steps, rtol=0)
            g, arr = np.delete(g, np.s_[e:2 * e]), np.delete(
                arr, np.s_[e:2 * e])
        np.testing.assert_allclose(g, arr, atol=atol, rtol=0, err_msg=name)
    for blk in tm.gpt.h:
        kb = blk.attn.qkv_proj.bias.grad[e:2 * e]
        assert float(kb.abs().max()) < 1e-6


def test_train_step_matches_jax_train_step():
    jm, tm = _models()
    batches = _batches(3)
    jstep = JTrainStep(jm, jopt.AdamW(learning_rate=LR), _fn)
    want = np.asarray(jstep.multi_step(jnp.asarray(batches)))
    jstep.sync_to_model()
    tstep = TrainStep(tm, AdamW(learning_rate=LR), _fn, device="cpu")
    # the sums of torch's default thread count (tests/_torch_threads.py)
    with _torch_threads.default_threads():
        got = tstep.multi_step(torch.from_numpy(batches).long())
    assert got.shape == (3,) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=LOSS_RTOL)
    assert want[-1] < want[0]
    _assert_params_close(jm, tm, PARAM_ATOL, steps=3)


def test_train_step_call_equals_multi_step_bitwise():
    """One call per batch and ``multi_step`` over the stack are the same
    steps, to the bit."""
    batches = torch.from_numpy(_batches(2, seed=1)).long()
    _, a = _models()
    _, b = _models()
    sa = TrainStep(a, AdamW(learning_rate=LR), _fn, device="cpu")
    sb = TrainStep(b, AdamW(learning_rate=LR), _fn, device="cpu")
    la = torch.stack([sa(x) for x in batches])
    lb = sb.multi_step(batches)
    assert torch.equal(la, lb) and la.dim() == 1
    assert all(torch.equal(p, q) for p, q in
               zip(a.parameters(), b.parameters()))
    assert a.gpt.h[0].attn.qkv_proj.weight.grad.abs().sum() > 0


@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
def test_cross_entropy_ignore_index_matches_jax(reduction):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 7)).astype(np.int32)
    labels[0, 2] = labels[1, 5] = labels[1, 6] = -100
    want = JF.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            reduction=reduction)
    got = TF.cross_entropy(torch.from_numpy(logits),
                           torch.from_numpy(labels), reduction=reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    if reduction == "none":
        assert got[0, 2] == 0 and got[1, 5] == 0


def test_lm_loss_with_ignored_labels_is_a_mean_over_all_positions():
    """The JAX loss divides by every position, ignored ones included
    (``F["mean"]`` over ``reduction="none"``), unlike
    ``torch.nn.functional.cross_entropy(reduction="mean")``."""
    jm, tm = _models()
    ids = _batches(1, seed=2)[0]
    labels = ids.copy()
    labels[:, 5:11] = -100
    want = float(jm(Tensor(ids), labels=Tensor(labels)))
    with torch.no_grad():
        got = float(tm(torch.from_numpy(ids).long(),
                       labels=torch.from_numpy(labels).long()))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    with torch.no_grad():
        logits = tm(torch.from_numpy(ids).long())[:, :-1]
    torch_mean = float(torch.nn.functional.cross_entropy(
        logits.reshape(-1, 1024), torch.from_numpy(labels[:, 1:]).long()
        .reshape(-1), ignore_index=-100))
    assert abs(torch_mean - got) > 1e-3


@pytest.mark.parametrize("name", ["AdamW", "Adam"])
def test_adam_with_global_norm_clip_matches_jax_apply_gradients(name):
    """Two updates of a weight, a LayerNorm scale and a bias (all
    decayed: decoupled in AdamW, as the JAX AdamW decays every
    parameter, and as an L2 term of the gradient in Adam) with the
    gradient clipped by its global norm."""
    from paddle_tpu_torch import optimizer as topt
    rng = np.random.default_rng(3)
    shapes = {"w": (8, 16), "ln.weight": (16,), "b": (16,)}
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()}
    grads = [{n: (3.0 * rng.standard_normal(s)).astype(np.float32)
              for n, s in shapes.items()} for _ in range(2)]
    jo = getattr(jopt, name)(learning_rate=0.01, weight_decay=0.01,
                             grad_clip=jopt.ClipGradByGlobalNorm(1.0))
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    js = jo.init(jp)
    for g in grads:
        jp, js = jo.apply_gradients(
            jp, {n: jnp.asarray(v) for n, v in g.items()}, js,
            lr=jnp.asarray(0.01, jnp.float32))
    tp = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for n, v in params.items()}
    to = getattr(topt, name)(learning_rate=0.01, weight_decay=0.01,
                             grad_clip=ClipGradByGlobalNorm(1.0),
                             parameters=list(tp.items()))
    for g in grads:
        for n, p in tp.items():
            p.grad = torch.from_numpy(g[n].copy())
        to.step()
    state = to.state_dict()
    assert state["global_step"] == 2
    for n in shapes:
        np.testing.assert_allclose(tp[n].detach().numpy(),
                                   np.asarray(jp[n]), rtol=1e-6, atol=1e-7)
        for slot in ("moment1", "moment2"):
            np.testing.assert_allclose(
                state[f"{n}.{slot}"].numpy(),
                np.asarray(js["slots"][n][slot]), rtol=1e-6, atol=1e-9)


def test_load_jax_optimizer_state_resumes_a_jax_run():
    jm, tm = _models()
    batches = _batches(3, seed=4)
    jstep = JTrainStep(jm, jopt.AdamW(learning_rate=LR), _fn)
    jstep.multi_step(jnp.asarray(batches[:2]))
    jstep.sync_to_model()
    opt_state = jax.tree_util.tree_map(np.asarray, jstep.opt_state)
    tgpt.load_jax_state(tm, jgpt.checkpoint_state(jm))
    topt = AdamW(learning_rate=LR, parameters=tm.named_parameters())
    load_jax_optimizer_state(topt, opt_state)
    assert topt.state_dict()["global_step"] == 2
    want = float(jstep(jnp.asarray(batches[2])))
    jstep.sync_to_model()
    tstep = TrainStep(tm, topt, _fn, device="cpu")
    got = float(tstep(torch.from_numpy(batches[2]).long()))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    _assert_params_close(jm, tm, PARAM_ATOL, steps=3)
    bad = dict(opt_state["slots"])
    bad.pop("gpt.ln_f.bias")
    with pytest.raises(KeyError):
        load_jax_optimizer_state(topt, {"slots": bad, "step": 2})


@pytest.mark.parametrize("ignore", [False, True])
def test_remat_and_chunked_loss_match_the_full_loss(ignore):
    """``loss_chunk_size`` + ``remat`` give the full-logits loss and its
    gradients (``tests/test_end_to_end.py:190-245``), and the port's
    chunked loss equals the JAX one."""
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 211, (2, 33)).astype(np.int32)
    labels = ids.copy()
    if ignore:
        labels[:, 5:11] = -100
    cfg = dict(vocab_size=211, hidden_size=16, num_layers=2, num_heads=2,
               max_seq_len=33, dropout=0.0, attn_dropout=0.0)

    def build(**kw):
        pt.seed(0)
        jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**cfg, **kw))
        tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**cfg, **kw), device="cpu")
        tgpt.load_jax_state(tm, jgpt.checkpoint_state(jm))
        return jm, tm

    (_, full), (jchunk, chunk) = build(), build(loss_chunk_size=8,
                                                remat=True)
    t_ids = torch.from_numpy(ids).long()
    t_lab = torch.from_numpy(labels).long()
    l_full = full(t_ids, labels=t_lab)
    l_chunk = chunk(t_ids, labels=t_lab)
    want = float(jchunk(Tensor(ids), labels=Tensor(labels)))
    np.testing.assert_allclose(float(l_chunk.detach()), want,
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(l_chunk.detach()), float(l_full.detach()),
                               rtol=LOSS_RTOL)
    l_full.backward()
    l_chunk.backward()
    g_full = dict(full.named_parameters())
    for n, p in chunk.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   g_full[n].grad.numpy(), rtol=2e-3,
                                   atol=2e-5, err_msg=n)


def test_dropout_draws_from_the_step_generator_and_survives_remat():
    """Dropout inside a ``key_scope`` draws from its generator and never
    from torch's global one; remat replays the same masks, so remat with
    dropout gives the loss and gradients of no remat."""
    def build(**kw):
        cfg = tgpt.gpt_tiny()
        cfg.dropout = cfg.attn_dropout = 0.1
        cfg.remat = kw.get("remat", False)
        return tgpt.GPTForCausalLM(cfg, device="cpu",
                                   generator=torch.Generator().manual_seed(0))

    plain, remat = build(), build(remat=True)
    ids = torch.from_numpy(_batches(1, seed=6)[0]).long()
    out = {}
    for tag, m in (("plain", plain), ("remat", remat)):
        m.train()
        before = torch.get_rng_state()
        with trng.key_scope(torch.Generator().manual_seed(7)):
            loss = m(ids, labels=ids)
            loss.backward()
        assert torch.equal(torch.get_rng_state(), before)
        out[tag] = (loss, {n: p.grad for n, p in m.named_parameters()})
    assert torch.equal(out["plain"][0], out["remat"][0])
    for n, g in out["plain"][1].items():
        np.testing.assert_allclose(out["remat"][1][n].numpy(), g.numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=n)
    with trng.key_scope(torch.Generator().manual_seed(8)), \
            torch.no_grad():
        other = plain(ids, labels=ids)
    assert float(other) != float(out["plain"][0].detach())


def test_dropout_keeps_the_jax_semantics():
    x = torch.ones(4, 1000)
    with trng.key_scope(torch.Generator().manual_seed(0)):
        y = TF.dropout(x, p=0.25)
        z = TF.dropout(x, p=0.25, axis=1)
    assert set(torch.unique(y).tolist()) <= {0.0,
                                             float(torch.tensor(1 / 0.75))}
    assert abs(float((y == 0).float().mean()) - 0.25) < 0.03
    assert torch.equal(z[0], z[1])  # one mask per slice along axis 1
    assert torch.equal(TF.dropout(x, p=0.25, training=False), x)
    assert torch.equal(TF.dropout(x, p=0.25, training=False,
                                  mode="downscale_in_infer"), x * 0.75)


@pytest.mark.parametrize("field", ["moe_experts", "seq_parallel_mode"])
def test_unported_training_options_raise(field):
    value = {"moe_experts": 4, "seq_parallel_mode": "ring"}[field]
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tgpt.gpt_tiny(**{field: value})


def test_optimizer_state_round_trip_and_multi_precision():
    p = torch.nn.Parameter(torch.ones(4, dtype=torch.bfloat16))
    opt = AdamW(learning_rate=0.1, parameters=[("p", p)],
                multi_precision=True)
    p.grad = torch.full((4,), 0.5, dtype=torch.bfloat16)
    opt.step()
    state = opt.state_dict()
    assert state["p.moment1"].dtype == torch.float32
    assert p.dtype == torch.bfloat16
    again = AdamW(learning_rate=0.1, parameters=[("p", p)],
                  multi_precision=True)
    again.set_state_dict({k: v.clone() if torch.is_tensor(v) else v
                          for k, v in state.items()})
    assert again.state_dict()["global_step"] == 1
    opt.clear_grad()
    assert p.grad is None
    unbound = AdamW(learning_rate=0.1)
    with pytest.raises(ValueError, match="without parameters"):
        unbound.step()
