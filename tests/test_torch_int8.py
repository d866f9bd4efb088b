"""int8 execution on the CPU: the plain versions of the port's two int8
kernels (``ops/kernels/int8_matmul.py``) against the JAX package's
``Int8Linear`` / ``Int8Conv2D`` (``paddle_tpu/quantization/quant.py``),
and an int8 program saved and served by the CPU predictor.

Tolerances, stated: none. The quantized activations and the int32
accumulators are integers and must be equal; the fp32 epilogue takes the
same IEEE steps in the same order on both sides (JAX eager dispatches
each op alone, nothing is fused), so the outputs are held bitwise. The
buffers ``weight_int8`` / ``weight_scale`` / ``act_scale`` are
byte-equal. On the card ``chip_smoke.py`` holds the kernels bitwise
against these plain versions.
"""

import _torch_threads  # noqa: F401

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.nn.common import Linear as JLinear
from paddle_tpu.nn.conv import Conv2D as JConv2D
from paddle_tpu.quantization import quant as jq

from paddle_tpu_torch.core.enforce import InvalidArgumentError
from paddle_tpu_torch.inference import Config, create_predictor
from paddle_tpu_torch.nn.common import Linear
from paddle_tpu_torch.nn.conv import Conv2D
from paddle_tpu_torch.nn.layer import load_jax_state
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import int8_matmul as I
from paddle_tpu_torch.quantization import quant as tq
from paddle_tpu_torch.static import InputSpec, save_inference_model
from paddle_tpu_torch.vision.models import LeNet
from test_torch_transformer import jax_state


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


def _buffers_equal(j, t):
    for name in ("weight_int8", "weight_scale", "act_scale"):
        want = _np(getattr(j, name))
        got = getattr(t, name).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert got.tobytes() == want.tobytes(), name


def _pair(jcls, tcls, *args, **kw):
    pt.seed(0)
    j = jcls(*args, **kw)
    t = tcls(*args, device="cpu", **kw)
    load_jax_state(t, jax_state(j))
    return j, t


@pytest.mark.parametrize("lead,k,n,bias,dtype", [
    ((7,), 400, 120, True, "float32"),
    ((2, 5), 84, 10, False, "float32"),
    ((3, 4), 96, 48, True, "bfloat16"),
    ((16,), 2048, 40, True, "float32"),
])
def test_int8_linear_matches_jax(lead, k, n, bias, dtype):
    j, t = _pair(JLinear, Linear, k, n,
                 bias_attr=None if bias else False)
    rng = np.random.default_rng(k + n)
    x = rng.standard_normal(lead + (k,)).astype(np.float32) * 2.0
    act = float(np.abs(x).max()) * 0.8  # some inputs clip
    jl = jq.Int8Linear(j, act)
    tl = tq.Int8Linear(t, act)
    _buffers_equal(jl, tl)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    # the quantized activations and the int32 accumulators
    jqx = np.asarray(jq.quantize_int8(jx, _np(jl.act_scale)))
    tqx = I.quantize_activation(tx, tl.act_scale)
    np.testing.assert_array_equal(tqx.numpy(), jqx)
    jacc = np.asarray(jax.lax.dot_general(
        jnp.asarray(jqx), _np(jl.weight_int8),
        (((jqx.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))
    tacc = I._int_matmul(tqx, tl.weight_int8)
    assert tacc.dtype == torch.int32
    np.testing.assert_array_equal(tacc.numpy(), jacc)
    want = _np(jl(pt.Tensor(jx)))
    got = tl(tx).detach()
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


CONV_CASES = [
    # (C, M, k, stride, padding, dilation, groups, bias, H, W)
    (3, 16, 7, 2, 3, 1, 1, True, 20, 20),     # ResNet conv1's form
    (8, 16, 1, 2, 0, 1, 1, False, 9, 9),      # a 1x1 stride-2 downsample
    (1, 6, 3, 1, 1, 1, 1, True, 12, 12),      # LeNet's C=1 3x3
    (6, 6, 3, 1, 1, 1, 6, False, 10, 10),     # depthwise
    (8, 12, 3, 1, "SAME", 2, 2, True, 11, 9),  # grouped, dilated, SAME
    (4, 8, 3, 2, "VALID", 1, 1, True, 11, 10),
    (4, 8, 3, 2, (1, 2), 1, 1, False, 9, 8),  # per-dim pads
    (4, 8, 3, 1, (0, 1, 2, 0), 1, 1, True, 7, 9),  # (lo, hi) pairs
]


@pytest.mark.parametrize("case", CONV_CASES)
def test_int8_conv2d_matches_jax(case):
    c, m, k, stride, padding, dilation, groups, bias, h, w = case
    j, t = _pair(JConv2D, Conv2D, c, m, k, stride=stride,
                 padding=padding, dilation=dilation, groups=groups,
                 bias_attr=None if bias else False)
    rng = np.random.default_rng(c * 100 + m)
    x = rng.standard_normal((2, c, h, w)).astype(np.float32)
    act = float(np.abs(x).max()) * 0.9
    jl = jq.Int8Conv2D(j, act)
    tl = tq.Int8Conv2D(t, act)
    _buffers_equal(jl, tl)
    want = _np(jl(pt.to_tensor(x)))
    got = tl(torch.from_numpy(x)).detach()
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantize_dequantize_match_jax():
    x = np.array([0.5, -1.0, 0.0039, -0.0118, 3.0, 1e-12], np.float32)
    for scale in (1.0, 0.25, 0.0):
        jqv = np.asarray(jq.quantize_int8(pt.to_tensor(x), scale))
        tqv = tq.quantize_int8(torch.from_numpy(x), scale)
        assert tqv.dtype == torch.int8
        np.testing.assert_array_equal(tqv.numpy(), jqv)
        np.testing.assert_array_equal(
            tq.dequantize_int8(tqv, scale).numpy(),
            np.asarray(jq.dequantize_int8(jnp.asarray(jqv), scale)))


def test_ties_round_half_to_even():
    # x / 127 * 127 lands on .5 exactly: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5])
    q = I.quantize_activation(x, torch.tensor(127.0))
    np.testing.assert_array_equal(q.numpy(), [0, 2, 2, 0, -2])


def test_plain_conv_is_exact_at_resnet_depth():
    # K = 512 * 9: float64 sums of int8 products stay integers
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((1, 512, 5, 5)).astype(
        np.float32))
    wq = torch.from_numpy(rng.integers(-127, 128, (4, 512, 3, 3)).astype(
        np.int8))
    got = I.int8_conv2d_reference(x, wq, torch.tensor(1.0),
                                  torch.tensor(127.0), None, (1, 1),
                                  (1, 1, 1, 1), (1, 1), 1)
    qx = I.quantize_activation(x, torch.tensor(127.0)).to(torch.int64)
    pad = torch.nn.functional.pad(qx, (1, 1, 1, 1))
    acc = sum(pad[:, :, dy:dy + 5, dx:dx + 5][:, None] *
              wq[None, :, :, dy:dy + 1, dx:dx + 1].to(torch.int64)
              for dy in range(3) for dx in range(3)).sum(2)
    want = I.dequantize_output(acc.to(torch.int32), torch.tensor(1.0),
                               torch.tensor(127.0), None)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_quantize_int8_bf16_promotes_as_jnp():
    """bf16 ``x`` is promoted to fp32 beside an array scale and kept in
    bf16 beside a Python number (weakly typed in JAX): both bitwise."""
    x = (np.random.default_rng(3).standard_normal(4096) * 3).astype(
        np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    for scale in (2.7, np.float32(2.7), np.float64(2.7),
                  np.array(2.7, np.float32)):
        want = np.asarray(jq.quantize_int8(jx, scale))
        np.testing.assert_array_equal(tq.quantize_int8(tx, scale).numpy(),
                                      want, err_msg=repr(type(scale)))


GRAD_RTOL = 1e-6  # the bias gradient is a sum, taken in another order


@pytest.mark.parametrize("kind", ["linear", "conv"])
def test_int8_layer_gradients_match_jax_trainstep(kind):
    """The gradients ``jax.grad`` takes through the JAX int8 layers (the
    JAX ``TrainStep``; SGD at rate 1, so a parameter moves by minus its
    gradient): the bias gets the output's gradient summed, the layer
    before gets zeros (round's derivative)."""
    import paddle_tpu.optimizer as joptim
    from paddle_tpu.jit import TrainStep as JTrainStep
    from paddle_tpu_torch.nn.container import Sequential
    if kind == "linear":
        (jpre, tpre), (jin, tin) = _pair(JLinear, Linear, 8, 8), \
            _pair(JLinear, Linear, 8, 4)
        jint, tint = jq.Int8Linear(jin, 2.0), tq.Int8Linear(tin, 2.0)
        shape = (3, 8)
    else:
        (jpre, tpre), (jin, tin) = _pair(JConv2D, Conv2D, 2, 2, 1), \
            _pair(JConv2D, Conv2D, 2, 4, 3, padding=1)
        jint, tint = jq.Int8Conv2D(jin, 1.5), tq.Int8Conv2D(tin, 1.5)
        shape = (2, 2, 5, 5)
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    jm = pt.nn.Sequential(jpre, jint)
    before = {k: _np(v).copy() for k, v in jax_state(jm).items()}
    step = JTrainStep(jm, joptim.SGD(learning_rate=1.0),
                      lambda m, b: (m(b[0]) ** 2).sum())
    step((jnp.asarray(x),))
    step.sync_to_model()
    after = jax_state(jm)
    tm = Sequential(tpre, tint)
    (tm(torch.from_numpy(x)) ** 2).sum().backward()
    grads = {k: p.grad for k, p in tm.named_parameters()}
    assert sorted(grads) == ["0.bias", "0.weight", "1.bias"]
    for name, g in grads.items():
        want = before[name] - _np(after[name])
        np.testing.assert_allclose(g.numpy(), want, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(want).max(),
                                   err_msg=name)
    assert not grads["0.weight"].any() and not grads["0.bias"].any()
    assert grads["1.bias"].abs().max() > 0


def test_int8_scales_refuse_grad():
    layer = tq.Int8Linear(Linear(8, 4, device="cpu"), 2.0)
    layer.act_scale.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        layer(torch.randn(3, 8))
    with torch.no_grad():
        assert tuple(layer(torch.randn(3, 8)).shape) == (3, 4)


def test_registered_ops_have_fake_kernels():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        x = torch.empty(2, 3, 9, 9)
        wq = torch.empty(8, 3, 3, 3, dtype=torch.int8)
        s = torch.empty(())
        out = torch.ops.paddle_tpu_torch.int8_conv2d(
            x, wq, s, s, None, [2, 2], [1, 1, 0, 1], [1, 1], 1)
        assert tuple(out.shape) == (2, 8, 5, 4)
        assert out.dtype == torch.float32
        out = torch.ops.paddle_tpu_torch.int8_linear(
            torch.empty(2, 5, 16), torch.empty(16, 7, dtype=torch.int8),
            torch.empty(7), s, None)
        assert tuple(out.shape) == (2, 5, 7)


def test_c_entry_points_match_signatures():
    """Each ``extern "C"`` entry of csrc/int8_gemm.cu takes as many
    arguments as its ``_build.SIGNATURES`` row: ctypes passes what the
    row says, and a short row would cut the call."""
    path = os.path.join(_build.CSRC, "int8_gemm.cu")
    src = open(path).read()
    for name in ("pt_int8_linear", "pt_int8_conv2d"):
        m = re.search(rf"int {name}\(([^)]*)\)", src)
        assert m, name
        n_args = len([a for a in m.group(1).split(",") if a.strip()])
        assert n_args == len(_build.SIGNATURES[name]), name


def _calibrated_lenet(batches):
    torch.manual_seed(0)
    model = LeNet(device="cpu",
                  generator=torch.Generator().manual_seed(0))
    ptq = tq.PTQ()
    ptq.calibrate(model, [(b,) for b in batches], num_batches=len(batches))
    return model, ptq


def test_int8_program_served_by_cpu_predictor(tmp_path):
    rng = np.random.default_rng(0)
    batches = [rng.standard_normal((8, 1, 28, 28)).astype(np.float32)
               for _ in range(3)]
    model, ptq = _calibrated_lenet(batches)
    tq.convert_to_int8(model, ptq)
    kinds = [type(m).__name__ for m in model.modules()]
    assert kinds.count("Int8Conv2D") == 2 and kinds.count("Int8Linear") == 3
    x = rng.standard_normal((4, 1, 28, 28)).astype(np.float32)
    with torch.no_grad():
        want = model(torch.from_numpy(x))
    prefix = str(tmp_path / "lenet_int8")
    save_inference_model(prefix, [InputSpec((4, 1, 28, 28), "float32",
                                            "x")], layer=model)
    cfg = Config(prefix)
    cfg.enable_low_precision("int8")
    pred = create_predictor(cfg)
    names = [str(n.target) for n in pred._program.exported.graph.nodes
             if n.op == "call_function"]
    assert sum("int8_conv2d" in n for n in names) == 2
    assert sum("int8_linear" in n for n in names) == 3
    got = pred.run([x])[0]
    np.testing.assert_array_equal(got, want.numpy())
    # the int8 weights travel as int8
    state = torch.load(prefix + ".pdiparams", weights_only=True)
    assert state["features.0.weight_int8"].dtype == torch.int8


def test_convert_to_int8_errors():
    model = LeNet(device="cpu")
    with pytest.raises(InvalidArgumentError, match="calibration"):
        tq.convert_to_int8(model, tq.PTQ())
    assert issubclass(InvalidArgumentError, ValueError)
    net = torch.nn.Sequential(Conv2D(3, 4, 3, data_format="NHWC",
                                     device="cpu"))
    ptq = tq.PTQ()
    ptq.act_ranges["0"] = 1.0
    with pytest.raises(InvalidArgumentError, match="NCHW"):
        tq.convert_to_int8(net, ptq)
