"""The port's ``models/bert.py`` against the JAX package's, on the CPU.

``bert_tiny`` from seed 0 in the JAX package, its ``state_dict`` loaded
into the port's model with ``load_jax_state``, the same numpy batches
through both: the pretraining logits, the masked-position loss (labels
gathered or full, and the K == S rule that takes full-shaped labels as
already gathered), gradients, the classifier with a padding mask, and
two ``TrainStep`` steps with ``AdamW`` in fp32 and under the bf16
recipe against the JAX ``TrainStep``.

Tolerances, stated. fp32: the MLM logits are sums of 128 products of
O(1) embeddings (|logit| up to ~40), held within 1e-5 relative to the
largest logit; losses within 1e-5 relative; each parameter's gradient
within 1e-4 relative in L2 (measured below 2e-6), the attention key
biases', which softmax cancels, within rounding size (1e-6 absolute).
After two AdamW steps (lr 1e-3) every element lies within the 2 * lr
* steps that any two Adam trajectories can drift apart (Adam moves an
element by at most ~lr a step, whatever its gradient's rounding), and
all but 0.1% of a parameter's elements within 2e-5 absolute, as
``tests/test_torch_train.py`` holds GPT (the few others have gradients
near zero, whose m / sqrt(v) the rounding moves; measured: 1 element of
32768 at 2.5e-5); the key biases, whose gradients are rounding noise,
to the first bound only. bf16 recipe: u = 2^-8, losses within 2u
relative (``tests/test_torch_train_surface.py``), parameters as in
fp32 plus one bf16 rounding (2u relative) in each bound.
"""

import _torch_threads

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from bench_all import _to_bf16_except_norms
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import bert as jb
from paddle_tpu.ops import nn_functional as JF
from paddle_tpu.tensor import Tensor

from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import bert as tb
from paddle_tpu_torch.nn.layer import load_jax_state
from paddle_tpu_torch.nn.layers import gelu as gpt_gelu
from paddle_tpu_torch.ops import nn_functional as tnf
from paddle_tpu_torch.optimizer import AdamW
from test_torch_attention_fwd import _chip_smoke
from test_torch_transformer import jax_state

LOGIT_TOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
KEY_BIAS_ATOL = 1e-6
LR = 1e-3
PARAM_ATOL = 2e-5
STRAY_SHARE = 1e-3
U = 2.0 ** -8
B, S, K = 2, 32, 5


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


def _models(cls=("BertForPretraining",), bf16=False, **kw):
    pt.seed(0)
    jm = getattr(jb, cls[0])(jb.bert_tiny(), **kw)
    tm = getattr(tb, cls[0])(tb.bert_tiny(), device="cpu", **kw)
    if bf16:
        _to_bf16_except_norms(jm)
        _chip_smoke().to_bf16_except_norms(torch, tm)
    load_jax_state(tm, jax_state(jm))
    return jm, tm


def _batch(seed=0, k=K):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1024, (B, S)).astype(np.int32)
    pos = np.stack([rng.choice(S, k, replace=False)
                    for _ in range(B)]).astype(np.int32)
    labels = np.take_along_axis(ids, pos, 1).astype(np.int64)
    nsp = rng.integers(0, 2, (B,)).astype(np.int64)
    return ids, pos, labels, nsp


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x.value).astype(np.float32)


def test_configs_and_state_keys_equal_jax():
    for name in ("bert_tiny", "bert_base", "bert_large"):
        assert dataclasses.asdict(getattr(tb, name)(type_vocab_size=3)) == \
            dataclasses.asdict(getattr(jb, name)(type_vocab_size=3))
    jm, tm = _models()
    want = {k: tuple(v.shape) for k, v in jm.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == want


def test_hidden_act_gelu_is_the_exact_form():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    got = tnf.gelu(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(JF.gelu(jnp.asarray(x))),
                               atol=1e-6, rtol=1e-6)
    # GPT's tanh form differs by up to ~5e-4 here
    assert np.abs(got - gpt_gelu(_t(x)).numpy()).max() > 1e-4


def test_embedding_with_padding_idx_matches_jax():
    from paddle_tpu import nn as jnn
    from paddle_tpu_torch.nn.common import Embedding
    pt.seed(0)
    j = jnn.Embedding(11, 4, padding_idx=3)
    t = Embedding(11, 4, padding_idx=3, device="cpu")
    load_jax_state(t, jax_state(j))
    ids = np.array([[3, 1, 10], [0, 3, 3]], np.int64)
    got = t(_t(ids)).detach().numpy()
    np.testing.assert_array_equal(got, _np(j(Tensor(ids))))
    assert not got[0, 0].any() and got[0, 1].any()


def test_pretraining_logits_match_jax():
    jm, tm = _models()
    ids, *_ = _batch()
    jl, jn = jm(Tensor(ids))
    with torch.no_grad():
        tl, tn = tm(_t(ids))
    scale = np.abs(_np(jl)).max()
    np.testing.assert_allclose(_np(tl), _np(jl), atol=LOGIT_TOL * scale,
                               rtol=0)
    np.testing.assert_allclose(_np(tn), _np(jn), atol=LOGIT_TOL * scale,
                               rtol=0)
    assert tuple(tl.shape) == (B, S, 1024)


@pytest.mark.parametrize("form", ["gathered", "full", "k_equals_s",
                                  "no_positions"])
def test_masked_lm_losses_match_jax(form):
    """Gathered [B, K] labels, full [B, S] labels gathered by the model,
    K == S with full-shaped labels taken as already gathered (never
    gathered twice), and no positions (the head on every position with
    -100 where unlabelled); each with the NSP term."""
    jm, tm = _models()
    ids, pos, labels, nsp = _batch(1, k=S if form == "k_equals_s" else K)
    if form == "full":
        full = np.full((B, S), -100, np.int64)
        np.put_along_axis(full, pos, labels, 1)
        labels = full
    if form == "k_equals_s":
        # a permutation of every slot; its labels in slot order
        assert labels.shape == ids.shape
    kw = {} if form == "no_positions" else {"masked_positions": pos}
    if form == "no_positions":
        labels = np.where(np.random.default_rng(2).random((B, S)) < 0.15,
                          ids, -100).astype(np.int64)
    want = jm(Tensor(ids), labels=Tensor(labels),
              next_sentence_labels=Tensor(nsp),
              **{k: Tensor(v) for k, v in kw.items()})
    with torch.no_grad():
        got = tm(_t(ids), labels=_t(labels), next_sentence_labels=_t(nsp),
                 **{k: _t(v) for k, v in kw.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


def _assert_grads_close(jm, tm):
    want = {n: _np(p.grad) for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        got = _np(p.grad)
        if n.endswith("k_proj.bias"):
            assert np.abs(got).max() <= KEY_BIAS_ATOL, n
            continue
        rel = np.linalg.norm(got - want[n]) / np.linalg.norm(want[n])
        assert rel <= GRAD_REL, (n, rel)


def test_pretraining_gradients_match_jax():
    jm, tm = _models()
    ids, pos, labels, nsp = _batch(3)
    jm(Tensor(ids), masked_positions=Tensor(pos), labels=Tensor(labels),
       next_sentence_labels=Tensor(nsp)).backward()
    tm(_t(ids), masked_positions=_t(pos), labels=_t(labels),
       next_sentence_labels=_t(nsp)).backward()
    _assert_grads_close(jm, tm)


def test_sequence_classification_with_padding_mask_matches_jax():
    jm, tm = _models(("BertForSequenceClassification",), num_classes=3)
    jm.eval()
    tm.eval()
    ids, *_ = _batch(4)
    mask = np.ones((B, S), np.int32)
    mask[0, 20:] = 0
    want = jm(Tensor(ids), attention_mask=Tensor(mask))
    with torch.no_grad():
        got = tm(_t(ids), attention_mask=_t(mask))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    # the padded positions change nothing that the mask hides
    ids2 = ids.copy()
    ids2[0, 20:] = 7
    with torch.no_grad():
        again = tm(_t(ids2), attention_mask=_t(mask))
    np.testing.assert_allclose(again.numpy(), got.numpy(), atol=1e-6)
    y = np.array([2, 0], np.int64)
    with torch.no_grad():
        loss = tm(_t(ids), attention_mask=_t(mask), labels=_t(y))
    np.testing.assert_allclose(
        float(loss),
        float(jm(Tensor(ids), attention_mask=Tensor(mask), labels=Tensor(y))),
        rtol=LOSS_RTOL)


def _fn(m, b):
    return m(b[0], masked_positions=b[1], labels=b[2])


@pytest.mark.parametrize("bf16", [False, True])
def test_train_steps_match_jax_train_step(bf16):
    """Two AdamW steps over the masked-position batches (the benchmark's
    train function) against the JAX ``TrainStep``."""
    jm, tm = _models(bf16=bf16)
    batches = [_batch(10 + i) for i in range(2)]
    staged = tuple(np.stack([b[i] for b in batches]) for i in range(3))
    jstep = JTrainStep(jm, jopt.AdamW(learning_rate=LR), _fn)
    want = np.asarray(jstep.multi_step(tuple(map(jnp.asarray, staged))),
                      np.float32)
    jstep.sync_to_model()
    tstep = TrainStep(tm, AdamW(learning_rate=LR), _fn, device="cpu")
    with _torch_threads.default_threads():
        got = tstep.multi_step(tuple(map(_t, staged))).float().numpy()
    if bf16:
        assert tm.bert.pooler.weight.dtype == torch.bfloat16
        assert tm.mlm_norm.weight.dtype == torch.float32
        np.testing.assert_allclose(got, want, rtol=2 * U)
        atol, rtol = 2 * LR * 2, 2 * U
    else:
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
        atol, rtol = PARAM_ATOL, 0
    ws = jax_state(jm)
    for n, p in tm.state_dict().items():
        got = p.float().numpy()
        # Adam keeps any two trajectories within 2 * lr a step
        np.testing.assert_allclose(got, ws[n], atol=2 * LR * 2, rtol=rtol,
                                   err_msg=n)
        if n.endswith("k_proj.bias"):
            continue  # a gradient of rounding noise (see the docstring)
        off = np.abs(got - ws[n]) > atol + rtol * np.abs(ws[n])
        assert off.mean() <= STRAY_SHARE, (n, int(off.sum()), off.size)


def test_constructors_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.BertModel(tb.bert_tiny())
