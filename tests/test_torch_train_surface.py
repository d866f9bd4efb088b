"""The rest of the port's single-card training surface against the JAX
package, on the CPU: ``remat_save_attention``, the bf16 recipe of the
headline step, the mixed-dtype layer norm it needs, and how
``TrainStep`` reads the learning rate.

Tolerances, stated. fp32 steps: as ``test_torch_train.py`` (losses
within 1e-5 relative, parameters within 2e-5 after three AdamW steps).
bf16 recipe at ``gpt_tiny``: u = 2^-8 is bf16's unit roundoff. Both
losses are bf16 values whose unrounded values lie within a few u of
each other, so they round at most one ulp apart: 2u relative. The JAX
layer norm rounds its mean, variance and normalised values to bf16 where
the port keeps them in fp32, a rounding of up to u at each of the five
norms the gradients pass; the gradients over all parameters lie within
4u in L2 (measured 2u), each parameter's within 8u (measured 3.8u: a
bias's gradient sums terms of both signs over the positions and loses
digits to the cancellation).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from bench_all import _to_bf16_except_norms
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.ops import nn_functional as JF
from paddle_tpu.tensor import Tensor

import jax.numpy as jnp
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.nn.layers import LayerNorm
from paddle_tpu_torch.ops import nn_functional as tnf
from paddle_tpu_torch.ops.kernels import attention as tat
from paddle_tpu_torch.optimizer import AdamW, lr as tlr
from test_torch_attention_fwd import _chip_smoke
from test_torch_train import (LOSS_RTOL, LR, PARAM_ATOL, _assert_params_close,
                              _batches, _fn, _models)

U = 2.0 ** -8
BF16_LOSS_RTOL = 2 * U
BF16_GRAD_ALL = 4 * U
BF16_GRAD_PARAM = 8 * U


def test_remat_save_attention_step_matches_jax():
    """Three ``remat=True, remat_save_attention=True`` AdamW steps at
    ``gpt_tiny`` against the JAX ``TrainStep`` with the same options."""
    jm, tm = _models(remat=True, remat_save_attention=True)
    assert tm.config.remat_save_attention
    batches = _batches(3, seed=7)
    jstep = JTrainStep(jm, jopt.AdamW(learning_rate=LR), _fn)
    want = np.asarray(jstep.multi_step(jnp.asarray(batches)))
    jstep.sync_to_model()
    tstep = TrainStep(tm, AdamW(learning_rate=LR), _fn, device="cpu")
    got = tstep.multi_step(torch.from_numpy(batches).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=LOSS_RTOL)
    _assert_params_close(jm, tm, PARAM_ATOL, steps=3)


@pytest.fixture
def _through_kernels(monkeypatch):
    """Route CPU tensors through the attention Functions (their plain
    versions run inside) and count the forward's calls."""
    calls = []
    real = tat.attention_fwd

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tnf, "_on_card", lambda t: True)
    monkeypatch.setattr(tat, "attention_fwd", counted)
    return calls


@pytest.mark.parametrize("hidden,seq,entry", [(128, 128, "folded"),
                                              (256, 512, "flash"),
                                              (256, 1024, "flash")])
def test_remat_save_attention_keeps_the_kernel_outputs(_through_kernels,
                                                       hidden, seq, entry):
    """With the attention Functions on the path (D=64: the folded entry;
    D=128: the flash entry, one and two Q blocks), saved attention gives
    remat's loss and gradients bit for bit and runs the forward kernel
    once a layer where remat runs it twice; the saved outputs live until
    the recompute takes them."""
    calls = _through_kernels
    held = []
    real_init = tat.SavedAttention.__init__

    def track(self):
        real_init(self)
        held.append(self)

    ids = torch.randint(0, 97, (2, seq),
                        generator=torch.Generator().manual_seed(1))
    runs = {}
    for tag, kw in (("remat", {}), ("saved", dict(remat_save_attention=True))):
        cfg = tgpt.GPTConfig(vocab_size=97, hidden_size=hidden, num_layers=3,
                             num_heads=2, max_seq_len=seq, dropout=0.0,
                             attn_dropout=0.0, remat=True, **kw)
        m = tgpt.GPTForCausalLM(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(0))
        calls.clear()
        held.clear()
        tat.SavedAttention.__init__ = track
        try:
            loss = m(ids, labels=ids)
            kept = [len(h.items) for h in held]
            loss.backward()
        finally:
            tat.SavedAttention.__init__ = real_init
        runs[tag] = (loss.detach(), {n: p.grad for n, p in
                                     m.named_parameters()}, len(calls),
                     kept, [len(h.items) for h in held])
    (l_r, g_r, n_r, _, _), (l_s, g_s, n_s, kept, left) = (runs["remat"],
                                                          runs["saved"])
    assert torch.equal(l_r, l_s)
    assert all(torch.equal(g, g_s[n]) for n, g in g_r.items())
    assert (n_r, n_s) == (6, 3)
    assert kept == [1, 1, 1] and left == [0, 0, 0]
    assert runs["remat"][3] == []


def test_remat_save_attention_is_ported_and_other_options_still_raise():
    cfg = tgpt.gpt_tiny(remat=True, remat_save_attention=True)
    assert cfg.remat_save_attention and cfg.remat
    with pytest.raises(NotImplementedError, match="MoE"):
        tgpt.gpt_tiny(remat_save_attention=True, moe_experts=2)


@pytest.mark.parametrize("chunk", [0, 16])
def test_bf16_recipe_loss_and_gradients_match_jax(chunk):
    """The headline step's recipe at ``gpt_tiny``: bf16 weights, fp32
    norms (``bench_all._to_bf16_except_norms`` on the JAX side,
    ``chip_smoke.to_bf16_except_norms`` on the port's), the tied bf16
    head, against the JAX eager forward and backward on the same weights
    and batch. The full-logits loss is a bf16 value on both sides; the
    chunked loss sums its chunks into a float32 total on both."""
    cs = _chip_smoke()
    pt.seed(0)
    jm = jgpt.GPTForCausalLM(jgpt.gpt_tiny(dtype="bfloat16",
                                           loss_chunk_size=chunk))
    _to_bf16_except_norms(jm)
    tm = cs.to_bf16_except_norms(torch, tgpt.GPTForCausalLM(
        tgpt.gpt_tiny(dtype="bfloat16", loss_chunk_size=chunk),
        device="cpu"))
    tgpt.load_jax_state(tm, {k: np.asarray(v).astype(np.float32)
                             for k, v in jgpt.checkpoint_state(jm).items()})
    for n, p in tm.named_parameters():
        want = torch.float32 if any(t in n for t in cs.BF16_KEEP_TOKENS) \
            else torch.bfloat16
        assert p.dtype == want, n
    ids = _batches(1, s=64, seed=8)[0]
    jl = jm(Tensor(ids), labels=Tensor(ids))
    jl.backward()
    want = {n: np.asarray(p.grad.value).astype(np.float32)
            for n, p in jm.named_parameters()}
    tl = tm(torch.from_numpy(ids).long(), labels=torch.from_numpy(ids).long())
    tl.backward()
    tl = tl.detach()
    assert tl.dtype == (torch.float32 if chunk else torch.bfloat16)
    assert str(jl.dtype).endswith("float32" if chunk else "bfloat16")
    got = {n: p.grad.float().numpy() for n, p in tm.named_parameters()}
    assert abs(float(tl) - float(jl)) <= BF16_LOSS_RTOL * abs(float(jl))
    num = sum(np.linalg.norm(got[n] - w) ** 2 for n, w in want.items())
    den = sum(np.linalg.norm(w) ** 2 for w in want.values())
    assert np.sqrt(num / den) <= BF16_GRAD_ALL
    for n, w in want.items():
        rel = np.linalg.norm(got[n] - w) / np.linalg.norm(w)
        assert rel <= BF16_GRAD_PARAM, (n, rel)


def test_layer_norm_of_bf16_activations_with_fp32_parameters():
    """bf16 input, fp32 weight and bias: a bf16 output within one bf16
    rounding of the JAX function's, and the fp32 computation rounded
    once."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    b = (0.1 * rng.standard_normal(64)).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    ln = LayerNorm(64)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(w))
        ln.bias.copy_(torch.from_numpy(b))
    with torch.no_grad():
        got = ln(xb)
    assert got.dtype == torch.bfloat16
    with torch.no_grad():
        exact = torch.nn.functional.layer_norm(xb.float(), (64,),
                                               ln.weight, ln.bias, 1e-5)
    assert torch.equal(got, exact.bfloat16())
    want = np.asarray(JF.layer_norm(jnp.asarray(xb.float().numpy(),
                                                jnp.bfloat16), 64,
                                    jnp.asarray(w), jnp.asarray(b)),
                      np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=4 * U,
                               atol=4 * U)


def test_train_step_reads_the_learning_rate_once_a_call():
    """``__call__`` and ``multi_step`` each read the rate once, on the
    host (the JAX step passes one rate to its whole scan), so a scheduler
    stepped between calls changes the next call's rate and no step of a
    ``multi_step`` sees another."""
    _, tm = _models()
    sched = tlr.StepDecay(LR, 1, gamma=0.5)
    opt = AdamW(learning_rate=sched)
    reads = []
    real = opt.get_lr

    def counted():
        reads.append(real())
        return reads[-1]

    opt.get_lr = counted
    seen = []
    real_step = opt._step
    opt._step = lambda lr: (seen.append(lr), real_step(lr))
    step = TrainStep(tm, opt, _fn, device="cpu")
    batches = torch.from_numpy(_batches(3, seed=9)).long()
    step.multi_step(batches)
    sched.step()
    step(batches[0])
    assert reads == [LR, LR / 2]
    assert seen == [LR, LR, LR, LR / 2]
