"""ONNX export of the port against the JAX package's, on the CPU
(``tests/test_onnx_export.py``).

Each model is built in the JAX package and in the port with the JAX
weights (``load_jax_state``), so the two files describe one function.
The port's file is parsed back with the port's protobuf reader and run
by its numpy interpreter (``onnx/_interp.py``): its graph holds the
expected inputs, ops and initializers (the weights byte-exact), and its
values are the eager port model's and the JAX file's within 1e-5
relative / 1e-6 absolute (MLP), 1e-4 / 1e-5 (the conv net and the BERT
encoders; the JAX test's own limits). The registered kernel ops are
written as their plain math: a BERT encoder whose attention reaches the
folded kernel (#9, at S=256) and a fused bottleneck (#11) run in numpy
within the same limits. An op outside the converter's set raises naming
it.
"""

import _torch_threads  # noqa: F401

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn as jnn
import paddle_tpu.onnx as jonnx
from paddle_tpu.static import InputSpec as JSpec
from paddle_tpu.tensor import Tensor

import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.onnx as tonnx
from paddle_tpu_torch.core.enforce import InvalidArgumentError
from paddle_tpu_torch.nn.layer import load_jax_state
from paddle_tpu_torch.onnx import _interp
from paddle_tpu_torch.ops import nn_functional as tnf
from paddle_tpu_torch.ops.kernels import fused_conv_block as FC
from paddle_tpu_torch.static import InputSpec as TSpec
from paddle_tpu_torch.tensor import unwrap
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


def _mlp(nn, F, **kw):
    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(8, 16, **kw)
            self.fc2 = nn.Linear(16, 4, **kw)

        def forward(self, x):
            return F.softmax(self.fc2(F.relu(self.fc1(x))), axis=-1)
    return MLP()


def _convnet(nn, F, **kw):
    class ConvNet(nn.Layer):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2D(1, 3, 3, padding=1, **kw)
            self.fc = nn.Linear(3 * 6 * 6, 5, **kw)

        def forward(self, x):
            return self.fc(F.relu(self.conv(x)).reshape((2, -1)))
    return ConvNet()


def _bert_head(side):
    if side == "jax":
        from paddle_tpu import dispatch
        from paddle_tpu.models.bert import BertModel, bert_tiny

        def cat(a, b):
            return dispatch.wrapped_ops["concat"]([a, b], axis=-1)
        nn, bert = jnn, BertModel(bert_tiny())
    else:
        from paddle_tpu_torch.models import bert as tb

        def cat(a, b):
            return torch.cat([a, b], dim=-1)
        nn, bert = tnn, tb.BertModel(tb.bert_tiny(), device="cpu")

    class BertHead(nn.Layer):
        def __init__(self):
            super().__init__()
            self.bert = bert

        def forward(self, input_ids, attention_mask):
            seq, pooled = self.bert(input_ids,
                                    attention_mask=attention_mask)
            return cat(seq[:, 0], pooled)
    return BertHead()


def _pair(kind):
    import paddle_tpu.nn.functional as jF
    import paddle_tpu_torch.nn.functional as tF
    pt.seed(5)
    if kind == "bert":
        j, t = _bert_head("jax"), _bert_head("port")
    else:
        build = {"mlp": _mlp, "conv": _convnet}[kind]
        j, t = build(jnn, jF), build(tnn, tF, device="cpu")
    load_jax_state(t, jax_state(j))
    j.eval()
    t.eval()
    return j, t


def _inputs(kind):
    rng = np.random.default_rng(5)
    if kind == "mlp":
        return {"x": rng.normal(size=(2, 8)).astype(np.float32)}
    if kind == "conv":
        return {"img": rng.normal(size=(2, 1, 6, 6)).astype(np.float32)}
    mask = np.ones((2, 16), np.int32)
    mask[1, 10:] = 0
    return {"input_ids": rng.integers(0, 128, (2, 16)).astype(np.int32),
            "attention_mask": mask}


TOLS = {"mlp": (1e-5, 1e-6), "conv": (1e-4, 1e-5), "bert": (1e-4, 1e-5)}
OPS = {"mlp": {"MatMul", "Add", "Relu", "Softmax"},
       "conv": {"Conv", "Relu", "Reshape", "MatMul"},
       "bert": {"Gather", "MatMul", "Softmax", "Where", "Concat", "Erf",
                "Tanh", "ReduceMean", "Sqrt"}}


@pytest.mark.parametrize("kind", ["mlp", "conv", "bert"])
def test_export_matches_eager_and_the_jax_file(kind, tmp_path):
    j, t = _pair(kind)
    feeds = _inputs(kind)
    specs = [(n, list(v.shape), str(v.dtype)) for n, v in feeds.items()]
    tpath = tonnx.export(t, str(tmp_path / "port"),
                         input_spec=[TSpec(s, d, n) for n, s, d in specs])
    jpath = jonnx.export(j, str(tmp_path / "jax"),
                         input_spec=[JSpec(s, d, n) for n, s, d in specs])
    assert tpath.endswith("port.onnx")
    with open(tpath, "rb") as f:
        data = f.read()
    nodes, inits, ins, outs, opset = _interp.parse_model(data)
    assert opset == 13
    assert [(n, dims) for n, _, dims in ins] == [(n, s) for n, s, _ in specs]
    assert OPS[kind] <= {n["op"] for n in nodes}
    state = {k: v.detach().numpy() for k, v in t.state_dict().items()}
    for name, arr in inits.items():
        if name in state:
            assert np.array_equal(arr, state[name]), name
    assert sum(name in state for name in inits) >= 4
    got = _interp.run_model(data, feeds)[0]
    with torch.no_grad():
        eager = unwrap(t(*[torch.from_numpy(v) for v in feeds.values()]))
    with open(jpath, "rb") as f:
        jgot = _interp.run_model(f.read(), feeds)[0]
    jeager = np.asarray(j(*[Tensor(jnp.asarray(v))
                            for v in feeds.values()]).value)
    assert got.shape == tuple(outs[0][2]) == jeager.shape
    rtol, atol = TOLS[kind]
    np.testing.assert_allclose(got, eager.numpy(), rtol=rtol, atol=atol)
    np.testing.assert_allclose(got, jgot, rtol=rtol, atol=atol)
    np.testing.assert_allclose(got, jeager, rtol=rtol, atol=atol)


def test_attention_kernel_op_is_written_as_its_plain_math(tmp_path,
                                                         monkeypatch):
    """At S=256 the BERT encoder's attention reaches the folded kernel
    (``paddle_tpu_torch::attention_fwd``, #9): the exported program holds
    the op and the file its plain math."""
    from paddle_tpu_torch.models import bert as tb
    monkeypatch.setattr(tnf, "_on_card", lambda t: True)
    cfg = tb.BertConfig(vocab_size=256, hidden_size=128,
                        num_hidden_layers=2, num_attention_heads=2,
                        intermediate_size=256, max_position_embeddings=256,
                        hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    m = tb.BertModel(cfg, device="cpu")
    m.eval()
    ids = np.random.default_rng(6).integers(0, 256, (1, 256)).astype(
        np.int32)
    from paddle_tpu_torch.ops.kernels import attention as tat
    before = tat.attention_fwd.launches
    path = tonnx.export(m, str(tmp_path / "bert256"),
                        input_spec=[TSpec([1, 256], "int32", "ids")])
    with open(path, "rb") as f:
        data = f.read()
    ops = {n["op"] for n in _interp.parse_model(data)[0]}
    assert {"Exp", "Log", "ReduceMax", "ReduceSum"} <= ops
    got = _interp.run_model(data, {"ids": ids})
    with torch.no_grad():
        want = m(torch.from_numpy(ids))
    assert tat.attention_fwd.launches == before  # the CPU ran no kernel
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w.numpy(), rtol=1e-4, atol=1e-5)
    from paddle_tpu_torch.static.program import build_program
    program = build_program(m, [TSpec([1, 256], "int32", "ids")])
    targets = {str(n.target) for n in program.exported().graph.nodes}
    assert "paddle_tpu_torch.attention_fwd.default" in targets


def test_fused_bottleneck_op_is_written_as_its_plain_math(tmp_path):
    gen = torch.Generator().manual_seed(0)
    c, m = 16, 4

    def p(*shape):
        return torch.nn.Parameter(torch.randn(*shape, generator=gen) * 0.2)

    class Block(tnn.Layer):
        def __init__(self):
            super().__init__()
            self.w1, self.b1 = p(c, m), p(1, m)
            self.w2, self.b2 = p(9 * m, m), p(1, m)
            self.w3, self.b3 = p(m, c), p(1, c)

        def forward(self, x):
            return FC.fused_bottleneck_eval(x, self.w1, self.b1, self.w2,
                                            self.b2, self.w3, self.b3)

    blk = Block()
    path = tonnx.export(blk, str(tmp_path / "fb"),
                        input_spec=[TSpec([2, 5, 6, c], "float32", "x")])
    with open(path, "rb") as f:
        data = f.read()
    assert {"Pad", "Slice", "Concat", "MatMul", "Relu"} <= {
        n["op"] for n in _interp.parse_model(data)[0]}
    x = np.random.default_rng(7).standard_normal((2, 5, 6, c)).astype(
        np.float32)
    got = _interp.run_model(data, {"x": x})[0]
    with torch.no_grad():
        want = blk(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_unsupported_op_is_explicit(tmp_path):
    import paddle_tpu_torch.nn.functional as tF

    class Pooled(tnn.Layer):
        def forward(self, x):
            return tF.max_pool2d(x, 2)

    from paddle_tpu_torch.core import place
    place.set_device("cpu")
    try:
        with pytest.raises(NotImplementedError,
                           match="unsupported aten op 'aten.max_pool2d"):
            tonnx.export(Pooled(), str(tmp_path / "pool"),
                         input_spec=[TSpec([1, 1, 4, 4], "float32")])
    finally:
        place.reset_device()


def test_argument_checks_and_mode(tmp_path):
    import paddle_tpu_torch.nn.functional as tF
    t = _mlp(tnn, tF, device="cpu")
    with pytest.raises(InvalidArgumentError, match="input_spec"):
        tonnx.export(t, str(tmp_path / "a"))
    with pytest.raises(InvalidArgumentError, match="static"):
        tonnx.export(t, str(tmp_path / "a"),
                     input_spec=[TSpec([None, 8], "float32", "x")])
    t.train()
    path = tonnx.export(t, str(tmp_path / "a.onnx"),
                        input_spec=[TSpec([2, 8], "float32")])
    assert path == str(tmp_path / "a.onnx") and t.training
    ins = _interp.parse_model(open(path, "rb").read())[2]
    assert [n for n, _, _ in ins] == ["x0"]
