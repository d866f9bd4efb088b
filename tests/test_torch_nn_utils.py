"""``nn/container.py``, ``nn/utils.py`` and the functional capture of
``nn/layer.py`` of the port against the JAX package.

The containers: ``LayerList`` / ``LayerDict`` / ``ParameterList`` name
their children as the JAX ones do, so a JAX model's state (numpy) loads
through ``load_jax_state`` and the forward equals JAX's (1e-5
relative: two tanh layers, whose last bit moves with the thread count). The reparametrisations: ``weight_norm`` and ``spectral_norm``
on a ``Linear`` carried from JAX give the JAX package's parameter and
buffer names, its outputs and its gradients of ``g`` / ``v`` / ``orig``
within 1e-5 relative over three forward calls (the power iteration
updates ``weight_u`` / ``weight_v`` at each call in both);
``remove_weight_norm`` restores the weight. ``parameters_to_vector`` /
``vector_to_parameters`` round-trip in JAX's order. ``functional_call``
computes the layer as a function of a state dict (outputs within 1e-6 of
JAX's ``functional_call`` on the same state), restores the layer's own
tensors after, returns a BatchNorm's new running statistics with
``mutable_buffers``, and differentiates through autograd.
"""

import _torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from _torch_eager_parity import on_cpu
from paddle_tpu_torch.nn.layer import load_jax_state

_cpu = pytest.fixture(autouse=True, scope="module")(on_cpu)


@pytest.fixture(scope="module", autouse=True)
def _single_device_jax():
    from paddle_tpu.distributed.topology import (
        get_hybrid_communicate_group, set_hybrid_communicate_group)
    prev = get_hybrid_communicate_group()
    set_hybrid_communicate_group(None)
    try:
        yield
    finally:
        set_hybrid_communicate_group(prev)


def _state(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def _pair(make_j, make_t):
    j, t = make_j(), make_t()
    load_jax_state(t, _state(j))
    return j, t


X = np.random.default_rng(0).standard_normal((3, 6)).astype(np.float32)


class _JNet(pt.nn.Layer):
    def __init__(self):
        super().__init__()
        self.blocks = pt.nn.LayerList([pt.nn.Linear(6, 5),
                                       pt.nn.Linear(5, 4)])
        self.heads = pt.nn.LayerDict({"a": pt.nn.Linear(4, 2),
                                      "b": pt.nn.Linear(4, 3)})
        self.scales = pt.nn.ParameterList(
            [self.create_parameter([4]), self.create_parameter([2])])

    def forward(self, x):
        for blk in self.blocks:
            x = pt.tanh(blk(x))
        x = x * self.scales[0]
        return self.heads["a"](x) * self.scales[1], self.heads["b"](x)


class _TNet(paddle.nn.Layer):
    def __init__(self):
        super().__init__()
        lin = paddle.nn.Linear
        self.blocks = paddle.nn.LayerList([lin(6, 5, device="cpu"),
                                           lin(5, 4, device="cpu")])
        self.heads = paddle.nn.LayerDict({"a": lin(4, 2, device="cpu"),
                                          "b": lin(4, 3, device="cpu")})
        self.scales = paddle.nn.ParameterList(
            [self.create_parameter([4]), self.create_parameter([2])])

    def forward(self, x):
        for blk in self.blocks:
            x = torch.tanh(blk(x))
        x = x * self.scales[0]
        return self.heads["a"](x) * self.scales[1], self.heads["b"](x)


def test_containers_take_jax_names_and_match_jax():
    j, t = _pair(_JNet, _TNet)
    assert set(t.state_dict()) == set(j.state_dict())
    jo = j(pt.to_tensor(X))
    to = t(torch.from_numpy(X))
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a.detach().numpy(),
                                   np.asarray(b.numpy()), rtol=1e-5,
                                   atol=1e-7)


def test_container_methods():
    lin = lambda: paddle.nn.Linear(2, 2, device="cpu")  # noqa: E731
    ll = paddle.nn.LayerList([lin()])
    assert ll.append(lin()) is ll
    ll.extend([lin()])
    ll.insert(0, lin())
    assert len(ll) == 4 and isinstance(ll[1:], paddle.nn.LayerList)
    assert ll[-1] is list(ll)[-1]
    pl = paddle.nn.ParameterList()
    pl.append(paddle.create_parameter([3], "float32"))
    assert len(pl) == 1 and [n for n, _ in pl.named_parameters()] == ["0"]
    ld = paddle.nn.LayerDict([("x", lin())])
    ld["y"] = lin()
    ld.update({"z": lin()})
    assert list(ld) == ["x", "y", "z"] and "y" in ld
    del ld["x"]
    assert list(ld.keys()) == ["y", "z"]
    for c in (ll, pl, ld):
        assert isinstance(c, paddle.nn.Layer)


def _lin_pair(i, o):
    return _pair(lambda: pt.nn.Linear(i, o),
                 lambda: paddle.nn.Linear(i, o, device="cpu"))


@pytest.mark.parametrize("dim", [0, 1, None])
def test_weight_norm_matches_jax(dim):
    j, t = _lin_pair(6, 4)
    w0 = t.weight.detach().clone()
    pt.nn.utils.weight_norm(j, "weight", dim=dim)
    paddle.nn.utils.weight_norm(t, "weight", dim=dim)
    assert sorted(n for n, _ in t.named_parameters()) == \
        sorted(n for n, _ in j.named_parameters())
    np.testing.assert_allclose(t.weight_g.detach().numpy(),
                               np.asarray(j.weight_g.numpy()), rtol=1e-6)
    jy = j(pt.to_tensor(X))
    ty = t(torch.from_numpy(X))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy.numpy()),
                               rtol=1e-5, atol=1e-6)
    (jy * jy).sum().backward()
    (ty * ty).sum().backward()
    for n in ("weight_g", "weight_v", "bias"):
        np.testing.assert_allclose(getattr(t, n).grad.numpy(), np.asarray(
            getattr(j, n).grad.numpy()), rtol=1e-5, atol=1e-6, err_msg=n)
    paddle.nn.utils.remove_weight_norm(t, "weight")
    assert "weight" in dict(t.named_parameters())
    assert "weight_g" not in dict(t.named_parameters())
    np.testing.assert_allclose(t.weight.detach().numpy(), w0.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_spectral_norm_matches_jax_over_calls():
    j, t = _lin_pair(8, 5)
    pt.nn.utils.spectral_norm(j, "weight", n_power_iterations=2)
    paddle.nn.utils.spectral_norm(t, "weight", n_power_iterations=2)
    assert {"weight_u", "weight_v"} <= set(dict(t.named_buffers()))
    assert "weight_orig" in dict(t.named_parameters())
    x = np.random.default_rng(1).standard_normal((2, 8)).astype(np.float32)
    for _ in range(3):
        jy = j(pt.to_tensor(x))
        ty = t(torch.from_numpy(x))
        np.testing.assert_allclose(ty.detach().numpy(),
                                   np.asarray(jy.numpy()), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(t.weight_u.numpy(),
                               np.asarray(j.weight_u.numpy()), rtol=1e-5,
                               atol=1e-6)
    (jy * jy).sum().backward()
    (ty * ty).sum().backward()
    np.testing.assert_allclose(t.weight_orig.grad.numpy(), np.asarray(
        j.weight_orig.grad.numpy()), rtol=1e-4, atol=1e-6)


def test_parameters_vector_round_trip_matches_jax():
    j, t = _pair(_JNet, _TNet)
    jv = pt.nn.utils.parameters_to_vector(j.parameters())
    tv = paddle.nn.utils.parameters_to_vector(t.parameters())
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv.numpy()))
    paddle.nn.utils.vector_to_parameters(tv * 2.0, t.parameters())
    np.testing.assert_array_equal(
        paddle.nn.utils.parameters_to_vector(t.parameters()).numpy(),
        2.0 * np.asarray(jv.numpy()))


def test_functional_call_matches_jax_and_restores_the_layer():
    j, t = _lin_pair(6, 4)
    js = pt.nn.functional_state(j)
    ts = paddle.nn.functional_state(t)
    assert set(ts["params"]) == set(js["params"])
    r = np.random.default_rng(2)
    new = {k: r.standard_normal(np.shape(v)).astype(np.float32)
           for k, v in js["params"].items()}
    jo = pt.nn.functional_call(j, {"params": new}, pt.to_tensor(X))
    to = paddle.nn.functional_call(t, {"params": {
        k: torch.from_numpy(v) for k, v in new.items()}},
        torch.from_numpy(X))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               rtol=1e-6)
    np.testing.assert_array_equal(t.weight.detach().numpy(),
                                  ts["params"]["weight"].numpy())
    # differentiable through autograd with respect to the state
    w = torch.from_numpy(new["weight"]).requires_grad_(True)
    out = paddle.nn.functional_call(t, {"params": {"weight": w}},
                                    torch.from_numpy(X))
    out.sum().backward()
    np.testing.assert_allclose(w.grad.numpy(),
                               np.repeat(X.sum(0)[:, None], 4, 1), rtol=1e-5)
    assert t.weight.grad is None


def test_functional_call_mutable_buffers_and_bind_state():
    bn = paddle.nn.BatchNorm1D(3, device="cpu")
    st = paddle.nn.functional_state(bn)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (8, 3)).astype(np.float32))
    mean0 = bn._mean.clone()
    state = {"params": st["params"],
             "buffers": {k: v.clone() for k, v in st["buffers"].items()}}
    out, bufs = paddle.nn.functional_call(bn, state, x, training=True,
                                          mutable_buffers=True)
    assert not torch.equal(bufs["_mean"], mean0)
    assert torch.equal(bn._mean, mean0) and bn.training
    jbn = pt.nn.BatchNorm1D(3)
    jout, jbufs = pt.nn.functional_call(
        jbn, pt.nn.functional_state(jbn), pt.to_tensor(x.numpy()),
        training=True, mutable_buffers=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(bufs["_mean"].numpy(),
                               np.asarray(jbufs["_mean"]), rtol=1e-5)
    lin = paddle.nn.Linear(2, 2, device="cpu")
    w = torch.zeros(2, 2)
    with paddle.nn.bind_state(lin, {"params": {"weight": w}}) as m:
        assert m.weight is w
    assert lin.weight is not w
