"""The rest of ``ops/loss_extra.py``, ``ops/metric_extra.py`` and
``ops/nlp_ctr_extra.py`` of the port against the JAX package.

Every non-random op through both packages' public wrappers on the sweep's
seeded inputs (``tools/eager_sweep.py``): values, dtypes and gradients
within 1e-6 relative (log1p / exp round differently in XLA and torch by
an ulp) except where ``_torch_tail_parity.LOOSE`` states another limit;
the host-side ops (``chunk_eval``, ``detection_map``,
``positive_negative_pair``, ``filter_by_instag``, ``tdm_sampler``,
``similarity_focus``) equal as numpy.

The random ops (``sample_logits``, ``nce``, ``sampling_id``,
``random_crop``) cannot match JAX's PRNG bits, so they are held to
statistics (ROADMAP.md "Decided"): their deterministic parts equal
JAX's (``sample_logits``' true-class columns, ``nce`` recomputed from the
drawn negatives), an explicit generator repeats a draw, and the sampler's
frequencies over 20000 draws lie within 5 standard errors of the
log-uniform (or the given categorical) probabilities.
"""

import _torch_threads  # noqa: F401

import math

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from _torch_eager_parity import covered, on_cpu, registry_names
from _torch_tail_parity import tail_parity
from paddle_tpu_torch.ops import loss_extra as TL
from paddle_tpu_torch.ops import nlp_ctr_extra as TN
from paddle_tpu_torch.tools.eager_sweep import (loss_extra_cases,
                                                metric_extra_cases,
                                                nlp_ctr_cases)

_cpu = pytest.fixture(autouse=True, scope="module")(on_cpu)

LOSS, METRIC, CTR = loss_extra_cases(), metric_extra_cases(), nlp_ctr_cases()


@pytest.mark.parametrize("case", LOSS, ids=[c[0] for c in LOSS])
def test_loss_extra_op_matches_jax(case):
    tail_parity(case, default_tol=1e-6)


@pytest.mark.parametrize("case", METRIC, ids=[c[0] for c in METRIC])
def test_metric_extra_op_matches_jax(case):
    tail_parity(case, default_tol=1e-6)


@pytest.mark.parametrize("case", CTR, ids=[c[0] for c in CTR])
def test_nlp_ctr_extra_op_matches_jax(case):
    tail_parity(case, default_tol=1e-6)


def test_every_op_is_covered_and_registered_as_in_jax():
    for module, cases, rand in (
            ("loss_extra", LOSS, {"sample_logits", "nce", "ctc_loss",
                                  "warpctc", "hsigmoid_loss"}),
            ("metric_extra", METRIC, set()),
            ("nlp_ctr_extra", CTR, {"sampling_id", "random_crop"})):
        jnames, tnames = registry_names(module)
        assert tnames == jnames
        assert covered(cases) | rand == set(jnames), module


def _log_uniform_p(ids, c):
    return np.log1p(1.0 / (ids + 1.0)) / math.log(c + 1.0)


def test_sample_logits_deterministic_part_and_sampler_statistics():
    from paddle_tpu.ops.loss_extra import sample_logits as jsl
    import jax
    r = np.random.default_rng(1)
    logits = r.standard_normal((4, 30)).astype(np.float32)
    label = r.integers(0, 30, (4, 2)).astype(np.int32)
    g = torch.Generator().manual_seed(5)
    tout = TL.sample_logits(torch.from_numpy(logits), torch.from_numpy(label),
                            6, g)
    jout = jsl(logits, label, 6, jax.random.PRNGKey(0))
    # the true-class columns do not depend on the draw
    np.testing.assert_allclose(tout[0][:, :2].numpy(),
                               np.asarray(jout[0])[:, :2], rtol=1e-6)
    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
    assert tout[2].shape == jout[2].shape and tout[0].shape == jout[0].shape
    # the sampled columns are the logits of the drawn ids less their log
    # expected count, accidental hits removed
    neg = tout[2][0, 2:].numpy()
    p = _log_uniform_p(neg, 30)
    want = logits[:, neg] - np.log(np.maximum(-np.expm1(
        6 * np.log1p(-p)), 1e-20))
    hit = (neg[None, None] == label[:, :, None]).any(1)
    want = np.where(hit, -1e20, want)
    np.testing.assert_allclose(tout[0][:, 2:].numpy(), want, rtol=1e-5)
    again = TL.sample_logits(torch.from_numpy(logits),
                             torch.from_numpy(label), 6,
                             torch.Generator().manual_seed(5))
    assert torch.equal(again[2], tout[2])
    # the sampler: frequencies against the log-uniform law
    from paddle_tpu_torch.ops.loss_extra import _log_uniform_sample
    ids = _log_uniform_sample(torch.Generator().manual_seed(2), 20000, 30,
                              torch.device("cpu")).numpy()
    freq = np.bincount(ids, minlength=30) / ids.size
    p = _log_uniform_p(np.arange(30), 30)
    p[-1] += 1.0 - p.sum()   # the clip puts the tail on the last id
    se = np.sqrt(p * (1 - p) / ids.size)
    assert np.all(np.abs(freq - p) < 5 * se + 1e-12)


def test_nce_matches_jax_given_the_same_negatives():
    from paddle_tpu.ops import loss_extra as JL
    import jax
    import jax.numpy as jnp
    r = np.random.default_rng(2)
    x = r.standard_normal((5, 4)).astype(np.float32)
    w = r.standard_normal((12, 4)).astype(np.float32)
    b = r.standard_normal(12).astype(np.float32)
    label = r.integers(0, 12, (5, 1)).astype(np.int32)
    g = torch.Generator().manual_seed(7)
    neg = TL._log_uniform_sample(torch.Generator().manual_seed(7), 3, 12,
                                 torch.device("cpu")).numpy()
    tout = TL.nce(torch.from_numpy(x), torch.from_numpy(label),
                  torch.from_numpy(w), torch.from_numpy(b), 3, g)
    # the JAX function with its sampler returning the same negatives
    orig = JL._log_uniform_sample
    JL._log_uniform_sample = lambda key, n, c: jnp.asarray(neg, jnp.int32)
    try:
        jout = JL.nce(x, label, w, b, 3, jax.random.PRNGKey(0))
    finally:
        JL._log_uniform_sample = orig
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5)


def test_sampling_id_and_random_crop_statistics():
    probs = np.array([[0.1, 0.6, 0.3]] * 20000, np.float32)
    ids = TN.sampling_id(torch.from_numpy(probs),
                         key=torch.Generator().manual_seed(3)).numpy()
    assert ids.dtype == np.int32 and ids.shape == (20000,)
    freq = np.bincount(ids, minlength=3) / ids.size
    se = np.sqrt(probs[0] * (1 - probs[0]) / ids.size)
    assert np.all(np.abs(freq - probs[0]) < 5 * se)
    x = torch.arange(2 * 6 * 5, dtype=torch.float32).reshape(2, 6, 5)
    a = TN.random_crop(x, [3, 2], seed=4)
    b = TN.random_crop(x, [3, 2], seed=4)
    assert tuple(a.shape) == (2, 3, 2) and torch.equal(a, b)
    starts = []
    for s in range(1, 401):
        c = TN.random_crop(x, [3, 2], seed=s)
        starts.append(int(c[0, 0, 0]) // 5)
    # the row start is uniform over 0..3
    freq = np.bincount(starts, minlength=4) / len(starts)
    assert np.all(np.abs(freq - 0.25) < 5 * np.sqrt(0.25 * 0.75 / 400))


def test_jax_package_loss_cases():
    """Cases of ``tests/test_loss_ops.py``: hinge at the kink splits the
    gradient, center loss moves the centers, dice of a perfect match."""
    x = paddle.to_tensor(np.array([[1.0], [0.5]], np.float32),
                         stop_gradient=False)
    y = paddle.to_tensor(np.array([[1.0], [1.0]], np.float32))
    loss = paddle.hinge_loss(x, y).sum()
    loss.backward()
    jx = pt.to_tensor(np.array([[1.0], [0.5]], np.float32),
                      stop_gradient=False)
    jl = pt.hinge_loss(jx, pt.to_tensor(np.array([[1.0], [1.0]],
                                                 np.float32))).sum()
    jl.backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jx.grad.numpy()))
    probs = np.eye(3, dtype=np.float32)
    d = paddle.dice_loss(paddle.to_tensor(probs), paddle.to_tensor(
        np.arange(3, dtype=np.int32).reshape(3, 1)))
    assert abs(float(d)) < 1e-6
