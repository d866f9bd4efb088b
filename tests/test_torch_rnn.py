"""The port's recurrent layers (``nn/rnn.py``, ``ops/rnn.py``) against
the JAX package's, on the CPU.

Each JAX layer or cell is built from seed 0 and its ``state_dict``
loaded into the port's; the same numpy inputs go through both. Checked:
``SimpleRNN`` (tanh and relu), ``LSTM`` and ``GRU`` at two layers, one
and two directions, batch- and time-major, with and without initial
states (outputs and final states, the LSTM's as an ``(h, c)`` tuple);
each cell with and without states; the ``RNN`` wrapper forward and
reversed with ``sequence_length`` (states frozen past each row's length,
outputs zero there); ``BiRNN``; ``RNNCellBase``'s initial states; the
default initializer's range; gradients through a two-layer LSTM.

Tolerance, stated: fp32 on both sides, sums in other orders, values of
O(1) after at most 7 steps: within 1e-5 absolute and relative (measured
below 1e-6); gradients within 1e-4 relative in L2 a parameter.
"""

import _torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu.tensor import Tensor

from paddle_tpu_torch.nn import rnn as tr
from paddle_tpu_torch.nn.layer import load_jax_state
from test_torch_transformer import jax_state

TOL = 1e-5
GRAD_REL = 1e-4
B, T, I, H = 3, 7, 5, 6


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


def _pair(name, *args, **kw):
    pt.seed(0)
    j = getattr(jnn, name)(*args, **kw)
    t = getattr(tr, name)(*args, device="cpu", **kw)
    assert {k: tuple(v.shape) for k, v in t.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in j.state_dict().items()}
    load_jax_state(t, jax_state(j))
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(getattr(x, "value", x))


def close_tree(got, want):
    if isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            close_tree(g, w)
        return
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL, rtol=TOL)


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _to(tree, wrap):
    if isinstance(tree, tuple):
        return tuple(_to(t, wrap) for t in tree)
    return wrap(tree)


@pytest.mark.parametrize("time_major", [False, True])
@pytest.mark.parametrize("direction", ["forward", "bidirect"])
@pytest.mark.parametrize("mode", ["SimpleRNN", "SimpleRNN-relu", "LSTM",
                                  "GRU"])
def test_multi_layer_rnn_matches_jax(mode, direction, time_major):
    rng = np.random.default_rng(1)
    name, _, act = mode.partition("-")
    kw = dict(num_layers=2, direction=direction, time_major=time_major)
    if act:
        kw["activation"] = act
    j, t = _pair(name, I, H, **kw)
    x = _x(rng, T, B, I) if time_major else _x(rng, B, T, I)
    n = 2 * (2 if direction == "bidirect" else 1)
    init = _x(rng, n, B, H)
    init = (init, _x(rng, n, B, H)) if name == "LSTM" else init
    for states in (None, init):
        want = j(Tensor(x), None if states is None else _to(states, Tensor))
        got = t(torch.from_numpy(x),
                None if states is None else _to(states, torch.from_numpy))
        close_tree(got, want)
    out, _ = got
    width = H * (2 if direction == "bidirect" else 1)
    assert tuple(out.shape) == ((T, B, width) if time_major
                                else (B, T, width))


def test_lstm_gradients_match_jax():
    rng = np.random.default_rng(2)
    j, t = _pair("LSTM", I, H, num_layers=2, direction="bidirect")
    x, w = _x(rng, B, T, I), _x(rng, B, T, 2 * H)
    jo, (jh, jc) = j(Tensor(x))
    ((jo * Tensor(w)).sum() + jc.sum()).backward()
    to, (th, tc) = t(torch.from_numpy(x))
    ((to * torch.from_numpy(w)).sum() + tc.sum()).backward()
    want = {n: _np(p.grad.value) for n, p in j.named_parameters()}
    for n, p in t.named_parameters():
        g = p.grad.numpy()
        rel = np.linalg.norm(g - want[n]) / np.linalg.norm(want[n])
        assert rel <= GRAD_REL, (n, rel)


@pytest.mark.parametrize("cell", ["SimpleRNNCell", "SimpleRNNCell-relu",
                                  "LSTMCell", "GRUCell"])
def test_cells_match_jax(cell):
    rng = np.random.default_rng(3)
    name, _, act = cell.partition("-")
    j, t = _pair(name, I, H, **({"activation": act} if act else {}))
    x = _x(rng, B, I)
    states = (_x(rng, B, H), _x(rng, B, H)) if name == "LSTMCell" else \
        _x(rng, B, H)
    close_tree(t(torch.from_numpy(x)), j(Tensor(x)))
    close_tree(t(torch.from_numpy(x), _to(states, torch.from_numpy)),
               j(Tensor(x), _to(states, Tensor)))


def test_default_initializer_is_uniform_over_one_over_sqrt_hidden():
    t = tr.GRU(I, 64, device="cpu", generator=torch.Generator()
               .manual_seed(0))
    for p in t.parameters():
        assert float(p.detach().abs().max()) <= 1.0 / 8.0
    assert float(t.bias_ih_l0.detach().abs().max()) > 0.1
    # the JAX recurrent layers accept their weight attributes and create
    # every weight without them: an attribute object, and a ParamAttr
    # with an initializer, leave the default draw in both packages
    from paddle_tpu.nn import initializer as jinit
    from paddle_tpu_torch.nn import initializer as tinit
    gen = torch.Generator().manual_seed(3)
    plain = tr.LSTM(I, H, device="cpu", generator=gen)
    for attr in (object(), tinit.ParamAttr(initializer=tinit.Constant(0.5))):
        got = tr.LSTM(I, H, weight_ih_attr=attr, device="cpu",
                      generator=torch.Generator().manual_seed(3))
        for (n, p), (_, q) in zip(got.named_parameters(),
                                  plain.named_parameters()):
            assert torch.equal(p, q), n
    pt.seed(0)
    j = jnn.LSTM(I, H, weight_ih_attr=jnn.ParamAttr(
        initializer=jinit.Constant(0.5)))
    w = jax_state(j)["weight_ih_l0"]
    assert np.abs(w).max() <= 1.0 / np.sqrt(H) and (w != 0.5).all()


@pytest.mark.parametrize("time_major", [False, True])
@pytest.mark.parametrize("is_reverse", [False, True])
@pytest.mark.parametrize("cell", ["GRUCell", "LSTMCell"])
def test_rnn_wrapper_with_sequence_length_matches_jax(cell, is_reverse,
                                                      time_major):
    """States freeze past each row's length and outputs are zero there;
    the reverse walk holds the initial state until it enters the row's
    valid prefix. Without initial states the cell starts from zeros."""
    rng = np.random.default_rng(4)
    pt.seed(0)
    jc = getattr(jnn, cell)(I, H)
    jr = jnn.RNN(jc, is_reverse=is_reverse, time_major=time_major)
    tr_ = tr.RNN(getattr(tr, cell)(I, H, device="cpu"),
                 is_reverse=is_reverse, time_major=time_major)
    load_jax_state(tr_, jax_state(jr))
    x = _x(rng, T, B, I) if time_major else _x(rng, B, T, I)
    lens = np.array([7, 3, 5], np.int64)
    h0 = _x(rng, B, H)
    init = (h0, _x(rng, B, H)) if cell == "LSTMCell" else h0
    for states in (None, init):
        want = jr(Tensor(x), None if states is None else _to(states, Tensor),
                  sequence_length=Tensor(lens))
        got = tr_(torch.from_numpy(x),
                  None if states is None else _to(states, torch.from_numpy),
                  sequence_length=torch.from_numpy(lens))
        close_tree(got, want)
    out, final = got
    out = out if not time_major else out.transpose(0, 1)
    assert float(out[1, 3:].detach().abs().max()) == 0.0
    if not is_reverse:
        # the final state is the step at len - 1
        ref, _ = tr_(torch.from_numpy(x[:, :3] if not time_major
                                      else x[:3]),
                     _to(states, torch.from_numpy))
        last = ref[1, 2] if not time_major else ref[2, 1]
        h = final[0] if cell == "LSTMCell" else final
        np.testing.assert_allclose(h[1].detach().numpy(),
                                   last.detach().numpy(), atol=TOL)


@pytest.mark.parametrize("time_major", [False, True])
def test_birnn_matches_jax(time_major):
    rng = np.random.default_rng(5)
    pt.seed(0)
    jb = jnn.BiRNN(jnn.LSTMCell(I, H), jnn.GRUCell(I, H),
                   time_major=time_major)
    tb = tr.BiRNN(tr.LSTMCell(I, H, device="cpu"),
                  tr.GRUCell(I, H, device="cpu"), time_major=time_major)
    assert set(tb.state_dict()) == set(jb.state_dict())
    load_jax_state(tb, jax_state(jb))
    x = _x(rng, T, B, I) if time_major else _x(rng, B, T, I)
    lens = np.array([2, 7, 4], np.int64)
    init = ((_x(rng, B, H), _x(rng, B, H)), _x(rng, B, H))
    close_tree(tb(torch.from_numpy(x), _to(init, torch.from_numpy),
                  sequence_length=torch.from_numpy(lens)),
               jb(Tensor(x), _to(init, Tensor),
                  sequence_length=Tensor(lens)))
    close_tree(tb(torch.from_numpy(x)), jb(Tensor(x)))


def test_rnn_cell_base_initial_states_match_jax():
    class JCell(jnn.RNNCellBase):
        state_shape = ((H,), (2, H))

    class TCell(tr.RNNCellBase):
        state_shape = ((H,), (2, H))

    ref = np.zeros((B, I), np.float32)
    want = JCell().get_initial_states(Tensor(ref), init_value=0.5)
    got = TCell().get_initial_states(torch.from_numpy(ref), init_value=0.5)
    close_tree(got, want)
    single = TCell().get_initial_states(torch.from_numpy(ref), shape=(H,),
                                        dtype="float64")
    assert single.dtype == torch.float64 and tuple(single.shape) == (B, H)
    with pytest.raises(NotImplementedError):
        tr.RNNCellBase().get_initial_states(torch.from_numpy(ref))


def test_map_structure_keeps_container_types():
    x = torch.ones(2)
    tree = {"a": (x, [x, x]), "b": None}
    out = tr.map_structure(lambda t: t * 2, tree)
    assert type(out) is dict and type(out["a"]) is tuple and \
        type(out["a"][1]) is list and out["b"] is None
    assert float(out["a"][1][0][0]) == 2.0
    assert len(tr.flatten_structure(tree)) == 3
