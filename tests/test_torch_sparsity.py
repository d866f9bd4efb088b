"""2:4 sparsity of the port (``paddle_tpu_torch/sparsity.py``) against
the JAX package's ``paddle_tpu/sparsity.py`` on the CPU.

The masks are boolean and held bitwise against the JAX function's on the
same weights, ties included (zeros and repeated magnitudes: the port
sorts all groups in one ``np.argsort`` call, the JAX function one row at
a time, with the same per-row sort). ``decorate`` keeps the masks through
eager steps and through ``jit.TrainStep`` (which ``hapi.Model.fit``
drives); the JAX package's eager test is repeated on the port.
"""

import _torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu import sparsity as jsp

from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch import sparsity as tsp
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.nn.activation import ReLU
from paddle_tpu_torch.nn.common import Linear
from paddle_tpu_torch.nn.container import Sequential
from paddle_tpu_torch.nn.layer import load_jax_state
from paddle_tpu_torch.nn.loss import MSELoss
from test_torch_transformer import jax_state


@pytest.fixture(autouse=True)
def _fresh_masks():
    tsp.reset_masks()
    jsp.reset_masks()
    yield
    tsp.reset_masks()
    jsp.reset_masks()


def _weights():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((6, 18)).astype(np.float32)
    tied = np.round(rng.standard_normal((5, 12)), 1).astype(np.float32)
    tied[0, :4] = 0.0              # all four tie
    tied[1, 4:8] = [0.5, -0.5, 0.5, 0.1]
    return {"plain": w, "ties": tied,
            "3d": rng.standard_normal((2, 3, 8)).astype(np.float32),
            "short": rng.standard_normal((4, 3)).astype(np.float32)}


@pytest.mark.parametrize("name", ["plain", "ties", "3d", "short"])
@pytest.mark.parametrize("n,m", [(2, 4), (1, 4), (2, 8)])
def test_masks_bitwise_jax(name, n, m):
    w = _weights()[name]
    want = jsp.compute_mask_2d_best(w, n, m)
    got = tsp.compute_mask_2d_best(w, n, m)
    assert got.dtype == want.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tsp.compute_mask_2d_best(torch.from_numpy(w), n, m), want)
    for arr in (w, w * want):
        assert tsp.check_sparsity(arr, n, m) == jsp.check_sparsity(arr, n, m)
    assert tsp.check_sparsity(w * got, n, m)


def _pair():
    pt.seed(0)
    j = jnn.Sequential(jnn.Linear(16, 8), jnn.ReLU(), jnn.Linear(8, 4))
    t = Sequential(Linear(16, 8, device="cpu"), ReLU(),
                   Linear(8, 4, device="cpu"))
    load_jax_state(t, jax_state(j))
    return j, t


def test_prune_model_matches_jax():
    j, t = _pair()
    jm = jsp.prune_model(j)
    tm = tsp.prune_model(t)
    assert sorted(tm) == sorted(jm) == ["0.weight", "2.weight"]
    for k in jm:
        np.testing.assert_array_equal(tm[k], jm[k])
    jstate = jax_state(j)
    for k, v in t.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), jstate[k], err_msg=k)
        if k.endswith("weight"):
            assert tsp.check_sparsity(v)


def test_decorate_keeps_masks_eager():
    """The JAX package's own test (``test_quant_sparsity_text.py``) on
    the port."""
    net = Linear(16, 8, device="cpu")
    masks = tsp.prune_model(net)
    assert "weight" in masks
    assert tsp.check_sparsity(net.weight)
    opt = tsp.decorate(toptim.SGD(learning_rate=0.1,
                                  parameters=net.parameters()))
    net(torch.randn(4, 16)).sum().backward()
    opt.step()
    assert tsp.check_sparsity(net.weight)
    # the update moved the kept weights and left the pruned ones at 0
    assert (net.weight[torch.from_numpy(~masks["weight"])] == 0).all()


def test_decorate_keeps_masks_under_hapi_fit():
    _, t = _pair()
    masks = tsp.prune_model(t)
    model = Model(t)
    model.prepare(tsp.decorate(toptim.Adam(learning_rate=0.05)), MSELoss())
    rng = np.random.default_rng(1)
    data = [(rng.standard_normal((4, 16)).astype(np.float32),
             rng.standard_normal((4, 4)).astype(np.float32))
            for _ in range(3)]
    before = {k: v.clone() for k, v in t.state_dict().items()}
    model.fit(data, epochs=2, verbose=0)
    for k, mask in masks.items():
        w = t.state_dict()[k]
        assert tsp.check_sparsity(w), k
        assert (w[torch.from_numpy(~mask)] == 0).all(), k
        assert not torch.equal(w, before[k]), k  # it trained


def test_reset_masks_forgets():
    net = Linear(16, 8, device="cpu")
    tsp.prune_model(net)
    tsp.reset_masks()
    opt = tsp.decorate(toptim.SGD(learning_rate=0.1,
                                  parameters=net.parameters()))
    net(torch.randn(4, 16)).sum().backward()
    opt.step()
    assert not tsp.check_sparsity(net.weight)
