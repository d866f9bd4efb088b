"""The port's losses against the JAX package's, on the CPU.

- ``cross_entropy`` with the JAX signature in its order: positional and
  keyword calls, class weights (``"mean"`` divides by the picked weights
  of the positions not ignored), soft labels, ``use_softmax=False``,
  label smoothing, every reduction, ``axis=1``; its gradient under
  weights. The exact ``gelu`` at +-inf on a 16-element tensor.
- Every loss functional of ``ops/nn_functional.py`` (``softmax_with_
  cross_entropy``, ``nll_loss`` to ``sigmoid_focal_loss``,
  ``soft_margin_loss`` to ``gaussian_nll_loss``), forward and the vjp
  of a seeded cotangent; ``ctc_loss`` and ``hsigmoid_loss`` of
  ``ops/loss_extra.py`` with their gradients; the 18 layers of
  ``nn/loss.py`` on the JAX layers' inputs (``HSigmoidLoss`` on the
  JAX layer's weights through ``load_jax_state``).
- Under ``auto_cast``, the new losses on the black list take fp32 as
  JAX's dispatch casts them.

Tolerances, stated: outputs within 1e-5 absolute and relative, and
gradients within 1e-5 relative in L2 (``test_torch_conv.parity``);
``ctc_loss`` outputs within 1e-4 relative (a 30-step log-space
recursion) and its gradient within 1e-4; the fixed
``cross_entropy`` cases within 1e-6 of JAX's.
"""

import _torch_threads  # noqa: F401

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import amp as jamp
from paddle_tpu.nn import loss as jloss
from paddle_tpu.ops import loss_extra as jle
from paddle_tpu.ops import nn_functional as jnf
from paddle_tpu.tensor import Tensor

from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.nn import loss as tloss
from paddle_tpu_torch.nn.layer import load_jax_state
from paddle_tpu_torch.ops import loss_extra as tle
from paddle_tpu_torch.ops import nn_functional as tnf
from test_torch_conv import TOL, parity
from test_torch_transformer import jax_state


@pytest.fixture(scope="module", autouse=True)
def _single_device_jax():
    """The JAX layers of this file on one device, whatever ran before in
    the worker (``tests/test_torch_hot_swap.py``'s guard)."""
    from paddle_tpu.distributed.topology import (
        get_hybrid_communicate_group, set_hybrid_communicate_group)
    prev = get_hybrid_communicate_group()
    set_hybrid_communicate_group(None)
    try:
        yield
    finally:
        set_hybrid_communicate_group(prev)


def _rng(seed):
    return np.random.default_rng(seed)


def _f(shape, seed, lo=-2.0, hi=2.0):
    return _rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _probs(shape, seed):
    x = _rng(seed).uniform(0.05, 1.0, shape).astype(np.float32)
    return (x / x.sum(-1, keepdims=True)).astype(np.float32)


def _both(arr):
    return jnp.asarray(arr), torch.from_numpy(np.asarray(arr))


# -- cross_entropy and gelu ----------------------------------------------------

def _seed0_case():
    torch.manual_seed(0)
    x = torch.randn(4, 4).numpy()
    return x, np.array([0, 1, 2, 3]), np.array([1., 2., 3., 0.], np.float32)


def test_cross_entropy_weight_positional_matches_jax():
    x, y, w = _seed0_case()
    want = float(jnf.cross_entropy(*(jnp.asarray(a) for a in (x, y, w))))
    np.testing.assert_allclose(want, 1.197144, atol=1e-6)
    got = tnf.cross_entropy(*(torch.from_numpy(a) for a in (x, y, w)))
    np.testing.assert_allclose(float(got), want, atol=1e-6)
    got_kw = tnf.cross_entropy(torch.from_numpy(x), torch.from_numpy(y),
                               weight=torch.from_numpy(w))
    np.testing.assert_allclose(float(got_kw), want, atol=1e-6)


def test_cross_entropy_ignore_index_positional_matches_jax():
    x, y, _ = _seed0_case()
    want = float(jnf.cross_entropy(jnp.asarray(x), jnp.asarray(y), None, 1))
    np.testing.assert_allclose(want, 1.789955, atol=1e-6)
    got = tnf.cross_entropy(torch.from_numpy(x), torch.from_numpy(y), None,
                            1)
    np.testing.assert_allclose(float(got), want, atol=1e-6)
    # the rest of JAX's positional order
    for args in ((None, -100, "sum"), (None, 2, "none", False, -1),
                 (None, -100, "mean", False, -1, False),
                 (None, -100, "mean", False, -1, True, 0.2)):
        xx = np.abs(x) if len(args) == 6 else x
        want = jnf.cross_entropy(jnp.asarray(xx), jnp.asarray(y), *args)
        got = tnf.cross_entropy(torch.from_numpy(xx), torch.from_numpy(y),
                                *args)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=1e-6)


CE_CASES = {
    "plain": dict(),
    "ignore": dict(ignore_index=2),
    "weight": dict(weight=True),
    "weight_ignore": dict(weight=True, ignore_index=1),
    "smooth": dict(label_smoothing=0.1),
    "smooth_weight": dict(label_smoothing=0.2, weight=True, ignore_index=3),
    "no_softmax": dict(use_softmax=False),
    "soft": dict(soft_label=True),
    "soft_smooth": dict(soft_label=True, label_smoothing=0.1),
    "soft_no_softmax": dict(soft_label=True, use_softmax=False),
    "label_2d": dict(label_2d=True),
    "axis1": dict(axis=1),
}


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("case", list(CE_CASES))
def test_cross_entropy_paths_match_jax(case, reduction):
    kw = dict(CE_CASES[case])
    n, c = 6, 5
    soft = kw.get("soft_label", False)
    axis = kw.get("axis", -1)
    shape = (n, c, 3) if axis == 1 else (n, c)
    x = _f(shape, 1)
    if not kw.get("use_softmax", True):
        x = _probs(shape, 1) if axis == -1 else np.abs(x)
    if soft:
        label = _probs(shape, 2)
    else:
        lshape = (n, 3) if axis == 1 else (n,)
        label = _rng(3).integers(0, c, lshape)
        if kw.pop("label_2d", False):
            label = label[:, None]
    w = _f((c,), 4, 0.2, 2.0) if kw.pop("weight", False) else None
    lab_j, lab_t = _both(label)
    kw["reduction"] = reduction
    if w is None:
        parity(lambda x: jnf.cross_entropy(x, lab_j, **kw),
               lambda x: tnf.cross_entropy(x, lab_t, **kw), [x])
    else:
        parity(lambda x, w: jnf.cross_entropy(x, lab_j, w, **kw),
               lambda x, w: tnf.cross_entropy(x, lab_t, w, **kw), [x, w])


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("fn", ["cross_entropy", "nll_loss"])
def test_weight_with_ignore_index_past_the_classes_matches_jax(fn,
                                                               reduction):
    """``ignore_index`` at or above the class count (255 in segmentation)
    under ``weight``: JAX's ``jnp.take`` fills NaN there and the mask
    drops it, so the loss and its gradient stay finite."""
    n, c = 8, 5
    x = _f((n, c), 7) if fn == "cross_entropy" else np.log(_probs((n, c), 7))
    w = _f((c,), 8, 0.2, 2.0)
    label = _rng(9).integers(0, c, (n,))
    label[[1, 4, 6]] = c + 5
    lab_j, lab_t = _both(label)
    parity(lambda x, w: getattr(jnf, fn)(x, lab_j, w, c + 5, reduction),
           lambda x, w: getattr(tnf, fn)(x, lab_t, w, c + 5, reduction),
           [x, w])


def test_cross_entropy_layer_with_label_smoothing_matches_jax():
    x = _f((8, 10), 5)
    y = _rng(6).integers(0, 10, (8,))
    jl = jloss.CrossEntropyLoss(label_smoothing=0.1)
    tl = tloss.CrossEntropyLoss(label_smoothing=0.1)
    want = jl(Tensor(jnp.asarray(x)), Tensor(jnp.asarray(y))).value
    got = tl(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(got), float(want), rtol=TOL, atol=TOL)


def test_gelu_exact_keeps_plus_inf_on_long_tensors():
    x = torch.linspace(-3, 3, 16)
    x[3], x[11] = float("inf"), float("-inf")
    got = tnf.gelu(x)
    want = np.asarray(jnf.gelu(jnp.asarray(x.numpy())))
    assert got[3] == float("inf") and np.isinf(want[3])
    assert torch.isnan(got[11]) and np.isnan(want[11])
    rest = [i for i in range(16) if i not in (3, 11)]
    np.testing.assert_allclose(got.numpy()[rest], want[rest], atol=1e-6)
    tanh = tnf.gelu(x, approximate=True)
    assert tanh[3] == float("inf") and torch.isnan(tanh[11])


# -- the loss functionals ------------------------------------------------------

def _labels(shape, k, seed):
    return _rng(seed).integers(0, k, shape)


def _signs(shape, seed):
    return np.where(_rng(seed).random(shape) < 0.5, -1.0, 1.0).astype(
        np.float32)


def _binary(shape, seed):
    return (_rng(seed).random(shape) < 0.5).astype(np.float32)


# case -> (function name in both modules, or a function of the module
# and the arrays; float arrays; constants (numpy, passed after the
# arrays); keywords)
LOSSES = {
    "nll_loss": ("nll_loss", [np.log(_probs((6, 5), 1))],
                 [_labels((6,), 5, 2)], {}),
    "nll_loss_weight": ("nll_loss", [np.log(_probs((6, 5), 1)),
                                     _f((5,), 3, 0.5, 2.0)],
                        [], {"_label": _labels((6,), 5, 2),
                             "ignore_index": 1}),
    "nll_loss_sum": ("nll_loss", [np.log(_probs((6, 5), 1))],
                     [_labels((6,), 5, 2)], {"reduction": "sum"}),
    "mse_loss": ("mse_loss", [_f((4, 5), 1), _f((4, 5), 2)], [], {}),
    "l1_loss": ("l1_loss", [_f((4, 5), 1), _f((4, 5), 2)], [],
                {"reduction": "sum"}),
    "smooth_l1_loss": ("smooth_l1_loss", [_f((4, 5), 1), _f((4, 5), 2)],
                       [], {"delta": 0.7}),
    "binary_cross_entropy": ("binary_cross_entropy",
                             [_f((4, 5), 1, 0.02, 0.98), _binary((4, 5), 2),
                              _f((4, 5), 3, 0.5, 1.5)], [], {}),
    "bce_with_logits": ("binary_cross_entropy_with_logits",
                        [_f((4, 5), 1, -4, 4), _binary((4, 5), 2)], [], {}),
    "bce_with_logits_pos_weight": (
        lambda m, z, y, w, pw: m.binary_cross_entropy_with_logits(
            z, y, w, "sum", pw),
        [_f((4, 5), 1, -4, 4), _binary((4, 5), 2), _f((4, 5), 3, 0.5, 1.5),
         _f((5,), 4, 0.5, 3.0)], [], {}),
    "kl_div": ("kl_div", [np.log(_probs((4, 5), 1)), _probs((4, 5), 2)], [],
               {}),
    "kl_div_batchmean": ("kl_div", [np.log(_probs((4, 5), 1)),
                                    _probs((4, 5), 2)], [],
                         {"reduction": "batchmean"}),
    "margin_ranking_loss": ("margin_ranking_loss",
                            [_f((8,), 1), _f((8,), 2), _signs((8,), 3)], [],
                            {"margin": 0.3}),
    "hinge_embedding_loss": ("hinge_embedding_loss",
                             [_f((8,), 1)], [_signs((8,), 3)],
                             {"margin": 0.5}),
    "cosine_similarity": ("cosine_similarity", [_f((4, 6), 1), _f((4, 6), 2)],
                          [], {"axis": 1}),
    "cosine_embedding_loss": ("cosine_embedding_loss",
                              [_f((6, 5), 1), _f((6, 5), 2)],
                              [_signs((6,), 3)], {"margin": 0.1}),
    "triplet_margin_loss": ("triplet_margin_loss",
                            [_f((5, 4), 1), _f((5, 4), 2), _f((5, 4), 3)],
                            [], {"swap": True}),
    "triplet_margin_loss_p1": ("triplet_margin_loss",
                               [_f((5, 4), 1), _f((5, 4), 2),
                                _f((5, 4), 3)], [], {"p": 1.0}),
    "square_error_cost": ("square_error_cost", [_f((4, 5), 1),
                                                _f((4, 5), 2)], [], {}),
    "log_loss": ("log_loss", [_f((4, 1), 1, 0.05, 0.95), _binary((4, 1), 2)],
                 [], {}),
    "sigmoid_focal_loss": ("sigmoid_focal_loss",
                           [_f((6, 3), 1, -3, 3), _binary((6, 3), 2)], [],
                           {"normalizer": 2.0}),
    "soft_margin_loss": ("soft_margin_loss", [_f((4, 5), 1, -5, 5),
                                              _signs((4, 5), 2)], [], {}),
    "multi_label_soft_margin_loss": ("multi_label_soft_margin_loss",
                                     [_f((4, 5), 1, -3, 3),
                                      _binary((4, 5), 2),
                                      _f((5,), 3, 0.5, 1.5)], [], {}),
    "poisson_nll_loss": ("poisson_nll_loss",
                         [_f((4, 5), 1, -1, 1), _f((4, 5), 2, 0, 4)], [],
                         {"full": True}),
    "poisson_nll_loss_linear": ("poisson_nll_loss",
                                [_f((4, 5), 1, 0.1, 2),
                                 _f((4, 5), 2, 0, 4)], [],
                                {"log_input": False, "reduction": "sum"}),
    "gaussian_nll_loss": ("gaussian_nll_loss",
                          [_f((4, 5), 1), _f((4, 5), 2),
                           _f((4, 5), 3, 0.1, 2.0)], [], {"full": True}),
}


@pytest.mark.parametrize("case", list(LOSSES))
def test_loss_functionals_match_jax(case):
    name, arrays, consts, kw = LOSSES[case]
    kw = dict(kw)
    label = kw.pop("_label", None)
    jc = [jnp.asarray(c) for c in consts]
    tc = [torch.from_numpy(c) for c in consts]
    if label is not None:
        # a weighted nll_loss: label second, weight third
        lj, lt = _both(label)
        parity(lambda x, w: jnf.nll_loss(x, lj, w, **kw),
               lambda x, w: tnf.nll_loss(x, lt, w, **kw), arrays)
        return
    if name == "nll_loss":
        parity(lambda x: jnf.nll_loss(x, *jc, **kw),
               lambda x: tnf.nll_loss(x, *tc, **kw), arrays)
        return
    if callable(name):
        parity(lambda *a: name(jnf, *a), lambda *a: name(tnf, *a), arrays)
        return
    parity(lambda *a: getattr(jnf, name)(*a, *jc, **kw),
           lambda *a: getattr(tnf, name)(*a, *tc, **kw), arrays)


@pytest.mark.parametrize("soft", [False, True])
def test_softmax_with_cross_entropy_matches_jax(soft):
    x = _f((5, 7), 1)
    label = _probs((5, 7), 2) if soft else _labels((5, 1), 7, 3)
    lj, lt = _both(label)
    parity(lambda x: jnf.softmax_with_cross_entropy(x, lj, soft),
           lambda x: tnf.softmax_with_cross_entropy(x, lt, soft), [x])
    jl, jsm = jnf.softmax_with_cross_entropy(jnp.asarray(x), lj, soft,
                                             return_softmax=True)
    tl_, tsm = tnf.softmax_with_cross_entropy(torch.from_numpy(x), lt, soft,
                                              return_softmax=True)
    np.testing.assert_allclose(tsm.numpy(), np.asarray(jsm), atol=TOL)
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl), atol=TOL)


# -- ctc and hsigmoid --------------------------------------------------------

CTC_TOL = 1e-4


@pytest.mark.parametrize("reduction,norm", [("mean", False), ("sum", True),
                                            ("none", False)])
def test_ctc_loss_and_its_gradient_match_jax(reduction, norm):
    T, N, C, S = 30, 4, 6, 5
    logits = _f((T, N, C), 7, -3, 3)
    labels = _rng(8).integers(1, C, (N, S))
    labels[1, 2] = labels[1, 1]             # a repeat: no skip there
    in_len = np.array([30, 25, 18, 30])
    lab_len = np.array([5, 3, 0, 2])
    consts = [labels, in_len, lab_len]
    parity(lambda x: jle.ctc_loss(x, *(jnp.asarray(c) for c in consts),
                                  reduction=reduction, norm_by_times=norm),
           lambda x: tle.ctc_loss(x, *(torch.from_numpy(c) for c in consts),
                                  reduction=reduction, norm_by_times=norm),
           [logits], tol=CTC_TOL, grad_rel=CTC_TOL)


def test_ctc_layer_and_blank_match_jax():
    T, N, C, S = 12, 2, 5, 3
    logits = _f((T, N, C), 9, -2, 2)
    labels = _rng(10).integers(0, C - 1, (N, S))
    consts = (labels, np.array([12, 10]), np.array([3, 2]))
    want = jloss.CTCLoss(blank=C - 1)(*(Tensor(jnp.asarray(a)) for a in
                                        (logits,) + consts)).value
    got = tloss.CTCLoss(blank=C - 1)(*(torch.from_numpy(a) for a in
                                       (logits,) + consts))
    np.testing.assert_allclose(float(got), float(want), rtol=CTC_TOL)


def test_hsigmoid_simple_code_table_matches_jax():
    for k in (2, 5, 8, 13):
        for a, b in zip(tle._hsigmoid_simple_code(k),
                        jle._hsigmoid_simple_code(k)):
            np.testing.assert_array_equal(a, b)


def test_hsigmoid_loss_default_and_custom_tree_match_jax():
    n, d, k = 6, 8, 7
    x = _f((n, d), 11)
    w = _f((k - 1, d), 12)
    b = _f((k - 1,), 13)
    label = _rng(14).integers(0, k, (n,))
    lj, lt = _both(label)
    parity(lambda x, w, b: jle.hsigmoid_loss(x, lj, w, b, num_classes=k),
           lambda x, w, b: tle.hsigmoid_loss(x, lt, w, b, num_classes=k),
           [x, w, b])
    table = np.array([[0, 2, -1], [1, -1, -1], [0, 3, 4], [2, 1, -1],
                      [4, -1, -1], [3, 0, 1]])
    code = _binary((n, 3), 15)
    tj, tt = _both(table)
    parity(lambda x, w, c: jle.hsigmoid_loss(x, lj, w, None, k, tj, c),
           lambda x, w, c: tle.hsigmoid_loss(x, lt, w, None, k, tt, c),
           [x, _f((k, d), 16), code])


# -- nn/loss.py --------------------------------------------------------------

def _layer_inputs(name):
    """(constructor keywords, inputs) of each layer."""
    logp = np.log(_probs((6, 5), 1))
    x, y = _f((4, 5), 1), _f((4, 5), 2)
    return {
        "CrossEntropyLoss": (dict(weight=None, ignore_index=1),
                             [_f((6, 5), 1), _labels((6,), 5, 2)]),
        "MSELoss": ({}, [x, y]), "L1Loss": ({"reduction": "sum"}, [x, y]),
        "SmoothL1Loss": ({"delta": 0.5}, [x, y]),
        "NLLLoss": ({}, [logp, _labels((6,), 5, 2)]),
        "BCELoss": ({}, [_f((4, 5), 1, 0.05, 0.95), _binary((4, 5), 2)]),
        "BCEWithLogitsLoss": ({}, [x, _binary((4, 5), 2)]),
        "KLDivLoss": ({"reduction": "batchmean"},
                      [np.log(_probs((4, 5), 1)), _probs((4, 5), 2)]),
        "MarginRankingLoss": ({"margin": 0.2}, [_f((8,), 1), _f((8,), 2),
                                                _signs((8,), 3)]),
        "HingeEmbeddingLoss": ({}, [_f((8,), 1), _signs((8,), 3)]),
        "CosineEmbeddingLoss": ({}, [_f((6, 5), 1), _f((6, 5), 2),
                                     _signs((6,), 3)]),
        "TripletMarginLoss": ({"margin": 0.5}, [_f((5, 4), 1), _f((5, 4), 2),
                                                _f((5, 4), 3)]),
        "CTCLoss": ({}, [_f((10, 2, 4), 4), _labels((2, 3), 3, 5) + 1,
                         np.array([10, 9]), np.array([3, 2])]),
        "SoftMarginLoss": ({}, [x, _signs((4, 5), 3)]),
        "MultiLabelSoftMarginLoss": ({}, [x, _binary((4, 5), 2)]),
        "PoissonNLLLoss": ({"full": True}, [x, _f((4, 5), 2, 0, 4)]),
        "GaussianNLLLoss": ({}, [x, y, _f((4, 5), 3, 0.1, 2)]),
    }[name]


LAYERS = ["CrossEntropyLoss", "MSELoss", "L1Loss", "SmoothL1Loss",
          "NLLLoss", "BCELoss", "BCEWithLogitsLoss", "KLDivLoss",
          "MarginRankingLoss", "HingeEmbeddingLoss", "CosineEmbeddingLoss",
          "TripletMarginLoss", "CTCLoss", "SoftMarginLoss",
          "MultiLabelSoftMarginLoss", "PoissonNLLLoss", "GaussianNLLLoss"]


@pytest.mark.parametrize("name", LAYERS)
def test_loss_layers_match_jax(name):
    kw, inputs = _layer_inputs(name)
    want = getattr(jloss, name)(**kw)(*(Tensor(jnp.asarray(a))
                                        for a in inputs)).value
    got = getattr(tloss, name)(**kw)(*(torch.from_numpy(a) for a in inputs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_hsigmoid_loss_layer_on_jax_weights():
    import paddle_tpu as pt
    pt.seed(0)
    jl = jloss.HSigmoidLoss(8, 6)
    tl = tloss.HSigmoidLoss(8, 6, device="cpu")
    assert tuple(tl.weight.shape) == (5, 8) and tuple(tl.bias.shape) == (5,)
    load_jax_state(tl, jax_state(jl))
    x = _f((4, 8), 17)
    y = _labels((4,), 6, 18)
    want = jl(Tensor(jnp.asarray(x)), Tensor(jnp.asarray(y))).value
    got = tl(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    custom = tloss.HSigmoidLoss(8, 6, is_custom=True, bias_attr=False,
                                device="cpu")
    assert tuple(custom.weight.shape) == (6, 8) and custom.bias is None


@pytest.mark.parametrize("name", ["nll_loss", "binary_cross_entropy",
                                  "mse_loss", "kl_div", "cosine_similarity",
                                  "softmax_with_cross_entropy"])
def test_black_listed_losses_take_fp32_under_auto_cast_as_in_jax(name):
    x = _f((4, 5), 1, 0.05, 0.95)
    other = {"nll_loss": _labels((4,), 5, 2),
             "softmax_with_cross_entropy": _labels((4, 1), 5, 2)}.get(
        name, _f((4, 5), 2, 0.05, 0.95))
    jx = Tensor(jnp.asarray(x, jnp.bfloat16))
    from paddle_tpu import dispatch
    with jamp.auto_cast(dtype="bfloat16"):
        want = dispatch.wrapped_ops[name](jx, Tensor(jnp.asarray(other)))
    with tamp.auto_cast(dtype="bfloat16"), tamp.record_casts() as casts:
        got = getattr(tnf, name)(torch.from_numpy(x).bfloat16(),
                                 torch.from_numpy(other))
    assert casts == [(name, torch.float32)]
    assert str(got.dtype).split(".")[-1] == str(want.value.dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.value, np.float32),
                               rtol=1e-6, atol=1e-6)
