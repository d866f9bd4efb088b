"""Activation offload and the remat selection (``core/offload.py``)
against the JAX package's, on the CPU (``tests/test_offload.py``, its
single-device tests).

- Offload moves storage only: ``gpt_tiny(remat=True)`` SGD steps with it
  on give the losses and parameters of the steps with it off, bitwise,
  and both are the JAX remat steps' within 1e-5 relative (the JAX
  package's own offload tolerance, ``tests/test_offload.py:73``).
- It is no silent no-op: with offload on, each rematerialised block
  hands its input, ``[B, S, E]``, to the offload hooks once in forward
  (a host copy; pinned memory when it comes from the card) and takes it
  back once in backward; off, nothing goes there.
- Building a model never touches the process-wide selection; a model
  with ``remat_save_attention`` scopes its choice to its own forward,
  and a direct ``set_remat_saved_names`` stays in force for the others.
"""

import _torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.core.offload as joff
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import gpt as jgpt

import paddle_tpu_torch.core.offload as toff
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops import nn_functional as tnf
from paddle_tpu_torch.ops.kernels import attention as tat
from paddle_tpu_torch.optimizer import SGD

IDS = (np.arange(4 * 32).reshape(4, 32) % 1000).astype(np.int32)
SIDES = {"jax": (joff, jgpt), "port": (toff, tgpt)}


@pytest.fixture(autouse=True)
def _clean():
    """One device for the JAX models, whatever ran before in the
    worker (``tests/test_torch_hot_swap.py``'s guard), and the offload
    switch and selection reset around every test."""
    from paddle_tpu.distributed.topology import (
        get_hybrid_communicate_group, set_hybrid_communicate_group)
    prev = get_hybrid_communicate_group()
    set_hybrid_communicate_group(None)
    try:
        yield
    finally:
        set_hybrid_communicate_group(prev)
        for off, _ in SIDES.values():
            off.set_activation_offload(False)
            off.set_remat_saved_names(())
        toff.reset_offload_stats()


def _port_steps(offload, steps=3, **cfg):
    toff.set_activation_offload(offload)
    try:
        pt.seed(0)
        jm = jgpt.GPTForCausalLM(jgpt.gpt_tiny(remat=True, **cfg))
        tm = tgpt.GPTForCausalLM(tgpt.gpt_tiny(remat=True, **cfg),
                                 device="cpu")
        tgpt.load_jax_state(tm, jgpt.checkpoint_state(jm))
        step = TrainStep(tm, SGD(learning_rate=0.1),
                         lambda m, b: m(b[0], labels=b[1]), device="cpu")
        ids = torch.from_numpy(IDS).long()
        losses = [step((ids, ids)).item() for _ in range(steps)]
        return losses, tgpt.checkpoint_state(tm)
    finally:
        toff.set_activation_offload(False)


def test_offload_steps_are_bitwise_the_plain_remat_steps_and_jax():
    off, off_state = _port_steps(True)
    plain, plain_state = _port_steps(False)
    assert off == plain
    assert all(np.array_equal(off_state[k], plain_state[k])
               for k in plain_state)
    pt.seed(0)
    jm = jgpt.GPTForCausalLM(jgpt.gpt_tiny(remat=True))
    jstep = JTrainStep(jm, jopt.SGD(learning_rate=0.1),
                       lambda mm, b: mm(b[0], labels=b[1]))
    want = [float(jstep((IDS, IDS))) for _ in range(3)]
    np.testing.assert_allclose(off, want, rtol=1e-5)


@pytest.mark.parametrize("offload", [True, False])
def test_block_inputs_go_to_the_host_only_with_offload(offload):
    """Structural guard: the checkpoint's saved block input really
    passes the offload hooks (a host copy a block, one copy back each in
    backward), so offload cannot degrade to a silent no-op."""
    cfg = tgpt.gpt_tiny(remat=True)
    m = tgpt.GPTForCausalLM(cfg, device="cpu")
    ids = torch.from_numpy(IDS[:2]).long()
    toff.set_activation_offload(offload)
    toff.reset_offload_stats()
    loss = m(ids, labels=ids)
    fwd = toff.offload_stats()
    loss.backward()
    bwd = toff.offload_stats()
    block = 2 * 32 * cfg.hidden_size * 4  # [B, S, E] fp32
    n = cfg.num_layers if offload else 0
    assert fwd == {"packed": n, "bytes": n * block, "unpacked": 0}
    assert bwd == {"packed": n, "bytes": n * block, "unpacked": n}
    # without grad no block is rematerialised, so nothing is saved
    toff.reset_offload_stats()
    with torch.no_grad():
        m(ids)
    assert toff.offload_stats()["packed"] == 0


@pytest.mark.parametrize("side", ["jax", "port"])
def test_model_build_leaves_external_remat_selection_alone(side):
    off, gpt = SIDES[side]
    kw = {} if side == "jax" else {"device": "cpu"}
    off.set_remat_saved_names((off.ATTN_OUT_NAME,))
    gpt.GPTForCausalLM(gpt.gpt_tiny(remat=True, remat_save_attention=False),
                       **kw)
    assert off.remat_saved_names() == (off.ATTN_OUT_NAME,)
    m = gpt.GPTForCausalLM(gpt.gpt_tiny(remat=True,
                                        remat_save_attention=True), **kw)
    assert off.remat_saved_names() == (off.ATTN_OUT_NAME,)
    assert m.gpt._remat_names == (off.ATTN_OUT_NAME,)
    off.set_remat_saved_names(())
    gpt.GPTForCausalLM(gpt.gpt_tiny(remat=True, remat_save_attention=True),
                       **kw)
    assert off.remat_saved_names() == ()


@pytest.mark.parametrize("side", ["jax", "port"])
def test_policy_and_scoped_selection(side):
    off, _ = SIDES[side]
    assert off.remat_policy() is None
    with off.override_remat_saved_names((off.ATTN_OUT_NAME,)):
        assert off.remat_saved_names() == (off.ATTN_OUT_NAME,)
        assert off.remat_policy() is not None
        with off.override_remat_saved_names(()):
            assert off.remat_saved_names() == ()
        assert off.remat_saved_names() == (off.ATTN_OUT_NAME,)
    assert off.remat_saved_names() == () and off.remat_policy() is None
    off.set_activation_offload(True)
    assert off.activation_offload_enabled()
    assert off.remat_policy() is not None
    x = object()
    assert off.name_activation(x, "other") is x
    if side == "port":
        assert off.remat_policy() == toff.RematPolicy(
            (), (toff.BLOCK_INPUT_NAME,))
        assert off.name_block_input(x) is x


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


@pytest.mark.parametrize("how", ["none", "config", "global", "offload"])
def test_selection_decides_what_the_recompute_runs(_through_kernels, how):
    """The attention forward runs twice a layer under plain remat (the
    recompute runs it again) and once when ``ATTN_OUT_NAME`` is selected,
    by the model's config (scoped to its forward) or by a direct
    ``set_remat_saved_names``; the selection leaves the loss and the
    gradients bitwise, and offload on top of the config's choice too."""
    calls = _through_kernels
    ids = torch.randint(0, 97, (1, 128),
                        generator=torch.Generator().manual_seed(1))
    runs = {}
    for tag in ("plain", how):
        cfg = tgpt.GPTConfig(vocab_size=97, hidden_size=128, num_layers=2,
                             num_heads=2, max_seq_len=128, dropout=0.0,
                             attn_dropout=0.0, remat=True,
                             remat_save_attention=tag in ("config",
                                                          "offload"))
        m = tgpt.GPTForCausalLM(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(0))
        toff.set_remat_saved_names((toff.ATTN_OUT_NAME,) if tag == "global"
                                   else ())
        toff.set_activation_offload(tag == "offload")
        calls.clear()
        loss = m(ids, labels=ids)
        assert toff.remat_saved_names() == (
            (toff.ATTN_OUT_NAME,) if tag == "global" else ())
        loss.backward()
        runs[tag] = (loss.detach(), {n: p.grad for n, p in
                                     m.named_parameters()}, len(calls))
    (l0, g0, n0), (l1, g1, n1) = runs["plain"], runs[how]
    assert torch.equal(l0, l1)
    assert all(torch.equal(g, g1[n]) for n, g in g0.items())
    assert n0 == 4 and n1 == (4 if how == "none" else 2)
