"""QAT and PTQ of the port (``paddle_tpu_torch/quantization/quant.py``)
against the JAX package's on the CPU, from the same seeded inputs and
the JAX layers' weights (``load_jax_state``).

Tolerances, stated:
- ``fake_quant``'s values and straight-through gradients: bitwise (the
  same IEEE steps elementwise).
- QAT layers' outputs and gradients: 1e-6 / 1e-5 relative, as the fp32
  matmuls and convolutions sum in another order than XLA's.
- ``FakeQuantLayer``'s scale under the port's ``TrainStep`` against the
  JAX eager loop: bitwise (an abs-max and one fp32 multiply-add a step).
- PTQ: ``act_ranges`` of a layer whose input is the model's input and
  ``quantize_weights`` bitwise; ranges behind an fp32 layer within 1e-6.
- The int8 LeNet: bitwise, as every int8 layer's output is exact
  integer arithmetic and one fixed fp32 epilogue.
"""

import _torch_threads  # noqa: F401

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.optimizer as joptim
from paddle_tpu import nn as jnn
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.quantization import quant as jq
from paddle_tpu.vision.models import LeNet as JLeNet

from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn.activation import ReLU
from paddle_tpu_torch.nn.common import Linear
from paddle_tpu_torch.nn.container import Sequential
from paddle_tpu_torch.nn.conv import Conv2D
from paddle_tpu_torch.nn.layer import load_jax_state
from paddle_tpu_torch.quantization import quant as tq
from paddle_tpu_torch.vision.models import LeNet
from test_torch_transformer import jax_state

OUT_RTOL = 1e-6
GRAD_RTOL = 1e-5


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


def _np(t):
    return np.asarray(t.value if hasattr(t, "value") else t)


def _mlp_pair(qat=True):
    pt.seed(0)
    j = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    t = Sequential(Linear(8, 16, device="cpu"), ReLU(),
                   Linear(16, 4, device="cpu"))
    if qat:
        jq.ImperativeQuantAware().quantize(j)
        tq.ImperativeQuantAware().quantize(t)
    state = jax_state(j)
    assert set(state) == set(t.state_dict())
    load_jax_state(t, state)
    return j, t


def _conv_pair():
    pt.seed(0)
    j = jnn.Sequential(jnn.Conv2D(3, 4, 3, padding=1), jnn.ReLU(),
                       jnn.Conv2D(4, 2, 3, stride=2))
    t = Sequential(Conv2D(3, 4, 3, padding=1, device="cpu"), ReLU(),
                   Conv2D(4, 2, 3, stride=2, device="cpu"))
    jq.ImperativeQuantAware().quantize(j)
    tq.ImperativeQuantAware().quantize(t)
    load_jax_state(t, jax_state(j))
    return j, t


@pytest.mark.parametrize("bits,scale", [(8, 1.0), (8, 0.37), (4, 2.5),
                                        (8, 0.0), (8, "per_channel")])
def test_fake_quant_values_and_ste(bits, scale):
    x = np.linspace(-3, 3, 48, dtype=np.float32).reshape(6, 8)
    if scale == "per_channel":
        s = np.abs(x).max(axis=0, keepdims=True) * 0.7
    else:
        s = np.float32(scale)
    jx = pt.to_tensor(x, stop_gradient=False)
    jy = jq.fake_quant(jx, pt.to_tensor(s), bits)
    jy.sum().backward()
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = tq.fake_quant(tx, torch.as_tensor(s), bits)
    ty.sum().backward()
    np.testing.assert_array_equal(ty.detach().numpy(), jy.numpy())
    np.testing.assert_array_equal(tx.grad.numpy(), _np(jx.grad))
    np.testing.assert_array_equal(tx.grad.numpy(), np.ones_like(x))


def test_quant_dequant_matches_jax_numpy_and_torch():
    w = np.random.default_rng(1).standard_normal((12, 6)).astype(np.float32)
    for axis in (None, 0, 1):
        jqw, js = jq.quant_dequant(w, 8, axis=axis)
        nq, ns = tq.quant_dequant(w, 8, axis=axis)
        tqw, ts = tq.quant_dequant(torch.from_numpy(w), 8, axis=axis)
        assert nq.tobytes() == jqw.tobytes() == tqw.numpy().tobytes()
        assert np.asarray(ns).tobytes() == np.asarray(js).tobytes() \
            == ts.numpy().tobytes()


def test_qat_linear_forward_backward_match_jax():
    j, t = _mlp_pair()
    assert isinstance(t[0], tq.QuantizedLinear)
    x = np.random.default_rng(2).standard_normal((5, 8)).astype(np.float32)
    jout = j(pt.to_tensor(x))
    jout.sum().backward()
    tout = t(torch.from_numpy(x))
    tout.sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), jout.numpy(),
                               rtol=OUT_RTOL, atol=OUT_RTOL)
    jgrads = dict(j.named_parameters())
    for name, p in t.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), _np(jgrads[name].grad),
                                   rtol=GRAD_RTOL, atol=GRAD_RTOL,
                                   err_msg=name)
    # the first scale observes the input itself; the second observes an
    # fp32 matmul's output
    np.testing.assert_array_equal(t[0].act_quant.scale.numpy(),
                                  _np(j._sub_layers["0"].act_quant.scale))
    np.testing.assert_allclose(t[2].act_quant.scale.numpy(),
                               _np(j._sub_layers["2"].act_quant.scale),
                               rtol=OUT_RTOL)


def test_qat_conv_forward_backward_match_jax():
    j, t = _conv_pair()
    assert isinstance(t[0], tq.QuantizedConv2D)
    x = np.random.default_rng(3).standard_normal((2, 3, 9, 9)).astype(
        np.float32)
    jout = j(pt.to_tensor(x))
    (jout * jout).sum().backward()
    tout = t(torch.from_numpy(x))
    (tout * tout).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), jout.numpy(),
                               rtol=OUT_RTOL, atol=OUT_RTOL)
    jgrads = dict(j.named_parameters())
    for name, p in t.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), _np(jgrads[name].grad),
                                   rtol=GRAD_RTOL, atol=GRAD_RTOL,
                                   err_msg=name)


def _batches():
    rng = np.random.default_rng(4)
    xs = [rng.standard_normal((4, 8)).astype(np.float32) * f
          for f in (1.0, 2.0, 3.0)]
    ys = [rng.standard_normal((4, 4)).astype(np.float32) for _ in xs]
    return xs, ys


def test_fake_quant_scale_moving_average_matches_jax_eager():
    """The port keeps the moving average under its TrainStep; the JAX
    package keeps it in its eager loop (the reference's
    moving_average_abs_max)."""
    j, t = _mlp_pair()
    xs, ys = _batches()
    jopt = joptim.SGD(learning_rate=0.0, parameters=j.parameters())
    step = TrainStep(t, toptim.SGD(learning_rate=0.0),
                     lambda m, b: ((m(b[0]) - b[1]) ** 2).mean(),
                     device="cpu")
    for x, y in zip(xs, ys):
        loss = ((j(pt.to_tensor(x)) - pt.to_tensor(y)) ** 2).mean()
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        step((torch.from_numpy(x), torch.from_numpy(y)))
        np.testing.assert_array_equal(
            t[0].act_quant.scale.numpy(),
            _np(j._sub_layers["0"].act_quant.scale))
    # the average moved: not the last batch's abs-max
    assert float(t[0].act_quant.scale) < float(np.abs(xs[-1]).max())


def test_jax_trainstep_sets_each_batch_abs_max():
    """Pins the JAX package's jitted TrainStep: the Python flag
    ``_initialized`` is read at trace time, so every compiled step sets
    the scale to the batch's abs-max (no moving average); ROADMAP.md
    Queue 3 "Decided" records the port's choice."""
    j, _ = _mlp_pair()
    xs, ys = _batches()
    step = JTrainStep(j, joptim.SGD(learning_rate=0.0),
                      lambda m, b: ((m(b[0]) - b[1]) ** 2).mean())
    for x, y in zip(xs, ys):
        step((jnp.asarray(x), jnp.asarray(y)))
        step.sync_to_model()
        assert float(_np(j._sub_layers["0"].act_quant.scale)) == \
            float(np.abs(x).max())


def test_ptq_ranges_and_weights_match_jax():
    j, t = _mlp_pair(qat=False)
    rng = np.random.default_rng(5)
    data = [(rng.standard_normal((4, 8)).astype(np.float32),)
            for _ in range(4)]
    jp, tp = jq.PTQ(), tq.PTQ()
    jp.calibrate(j, [(pt.to_tensor(d[0]),) for d in data], num_batches=3)
    tp.calibrate(t, data, num_batches=3)
    assert sorted(tp.act_ranges) == sorted(jp.act_ranges) == ["0", "2"]
    assert tp.act_ranges["0"] == jp.act_ranges["0"]
    np.testing.assert_allclose(tp.act_ranges["2"], jp.act_ranges["2"],
                               rtol=OUT_RTOL)
    jw, tw = jp.quantize_weights(j), tp.quantize_weights(t)
    assert sorted(jw) == sorted(tw)
    for name in jw:
        for key in ("weight_int8", "weight_scale"):
            want = np.asarray(jw[name][key])
            assert tw[name][key].dtype == want.dtype
            assert tw[name][key].tobytes() == want.tobytes(), (name, key)
        assert tw[name]["act_scale"] == tp.act_ranges[name]


def _lenet_pair():
    pt.seed(0)
    j = JLeNet()
    t = LeNet(device="cpu")
    load_jax_state(t, jax_state(j))
    j.eval()
    t.eval()
    return j, t


def test_convert_to_int8_lenet_matches_jax():
    j, t = _lenet_pair()
    rng = np.random.default_rng(6)
    cal = [rng.standard_normal((8, 1, 28, 28)).astype(np.float32)
           for _ in range(3)]
    jp, tp = jq.PTQ(), tq.PTQ()
    jp.calibrate(j, [(c,) for c in cal], num_batches=3)
    tp.calibrate(t, [(c,) for c in cal], num_batches=3)
    assert sorted(tp.act_ranges) == sorted(jp.act_ranges)
    for name, v in jp.act_ranges.items():
        np.testing.assert_allclose(tp.act_ranges[name], v, rtol=OUT_RTOL,
                                   err_msg=name)
    # the same ranges on both sides: then every int8 layer is exact
    tp.act_ranges = dict(jp.act_ranges)
    jq.convert_to_int8(j, jp)
    tq.convert_to_int8(t, tp)
    x = rng.standard_normal((5, 1, 28, 28)).astype(np.float32)
    want = j(pt.to_tensor(x)).numpy()
    with torch.no_grad():
        got = t(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    # a converted JAX model's state loads into a converted port model
    # byte for byte (int8 buffers and 0-d scales)
    _, t2 = _lenet_pair()
    tq.convert_to_int8(t2, tp)
    with torch.no_grad():
        for buf in t2.buffers():
            buf.zero_()
    load_jax_state(t2, jax_state(j))
    for name, v in jax_state(j).items():
        assert t2.state_dict()[name].numpy().tobytes() == v.tobytes(), name
    with torch.no_grad():
        np.testing.assert_array_equal(t2(torch.from_numpy(x)).numpy(), want)


def test_save_quantized_model_writes_a_program(tmp_path):
    from paddle_tpu_torch.static import InputSpec, load_inference_model
    _, t = _mlp_pair()
    x = np.random.default_rng(7).standard_normal((3, 8)).astype(np.float32)
    t.train()
    t(torch.from_numpy(x))  # one observed batch sets the scales
    prefix = str(tmp_path / "qat")
    tq.ImperativeQuantAware().save_quantized_model(
        t, prefix, [InputSpec((3, 8), "float32", "x")])
    assert not t.training
    with torch.no_grad():
        want = t(torch.from_numpy(x))
    got = load_inference_model(prefix).run(x)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_quant_config_and_exports():
    import paddle_tpu.quantization as jpkg
    import paddle_tpu_torch.quantization as tpkg
    names = [n for n in dir(jpkg) if not n.startswith("_")
             and n != "quant"]
    for n in names:
        assert hasattr(tpkg, n), n
    assert tq.QuantConfig().__dict__ == jq.QuantConfig().__dict__
    cfg = tq.QuantConfig(weight_quantize_type="abs_max")
    _, t = _mlp_pair(qat=False)
    tq.ImperativeQuantAware(cfg).quantize(t)
    assert not t[0].per_channel and t[0]._w_scale().dim() == 0
