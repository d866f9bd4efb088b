"""The port's program path on the CPU: ``static`` (``build_program``,
``Executor`` with ``train_from_dataset``, ``save`` /
``load_inference_model``), ``inference.Predictor`` and its handles,
``PredictorPool``, ``capi_bridge``, ``jit.save`` / ``load``,
``EvalStep``, ``TracedLayer`` / ``TranslatedLayer``, ``to_static``
Layers exported, ``framework.io`` with and without a cipher key, and
the trainer runtime, each against the JAX package where it has the
same function.

The slice as a whole, at the JAX benchmark's CPU size of config 5
(``bench_all.py:3304-3366``): ResNet-18 (``num_classes=10``, 1x3x64x64)
and ``bert_tiny`` (S=32, int32 ids) from seed 0 in the JAX package,
their weights carried over with ``load_jax_state`` (ResNet's BN
statistics seeded, so the fold moves them), each saved with
``optimize=True`` and loaded in a predictor by both packages, inputs
from ``np.random.default_rng(0)``. Tolerance, stated: the two
predictors' outputs within 1e-4 of the largest output magnitude, in
fp32 and with bf16 parameter storage (both packages round the same
parameters to bf16 and compute in f32). Measured: ResNet-18 4.6e-7
(fp32) and 5.4e-7 (bf16) of it, bert_tiny 5.4e-7 and 6.3e-7
(``test_config5_predictors_match_jax`` prints the gap).

Inside the port a loaded program equals the eager layer it was saved
from bitwise (the graph runs the same ATen ops), and the trainer's
losses equal the JAX trainer's within 1e-5 relative (one worker, so
one order of steps).
"""

import _torch_threads  # noqa: F401

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu import static as jstatic
from paddle_tpu.framework import crypto as jcrypto
from paddle_tpu.inference import Config as JConfig
from paddle_tpu.inference import create_predictor as jcreate
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import bert as jb
from paddle_tpu.vision import models as jmodels

from paddle_tpu_torch import framework, static
from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.framework import crypto as tcrypto
from paddle_tpu_torch.inference import (Config, PredictorPool, capi_bridge,
                                        create_predictor)
from paddle_tpu_torch.jit import (EvalStep, TracedLayer, TrainStep,
                                  TranslatedLayer, to_static)
from paddle_tpu_torch.jit import load as jit_load
from paddle_tpu_torch.jit import save as jit_save
from paddle_tpu_torch.models import bert as tb
from paddle_tpu_torch.nn.common import Linear
from paddle_tpu_torch.nn.layer import load_jax_state
from paddle_tpu_torch.ops import nn_functional as tnf
from paddle_tpu_torch.optimizer import SGD
from paddle_tpu_torch.static import InputSpec
from paddle_tpu_torch.vision import models as tmodels
from test_torch_transformer import jax_state

# config 5 across the packages: outputs within this share of the
# largest output magnitude
PRED_TOL = 1e-4
LOSS_RTOL = 1e-5


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


class _MLP(torch.nn.Module):
    def __init__(self, seed=0, out=3):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.fc1 = Linear(4, 8, device="cpu", generator=g)
        self.fc2 = Linear(8, out, device="cpu", generator=g)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def _x(shape=(2, 4), seed=2):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _eager(layer, *xs):
    layer.eval()
    with torch.no_grad():
        return layer(*[torch.as_tensor(x) for x in xs])


# -- build_program / Executor -------------------------------------------------

def test_build_program_and_run():
    net = _MLP()
    prog = static.build_program(net, [InputSpec((-1, 4), "float32", "x")])
    x = _x((3, 4), 0)
    assert torch.equal(prog.run(x), _eager(net, x))
    # the exported graph is inspectable (the ProgramDesc analog), traced
    # at the static shape (None / -1 -> 1)
    assert "graph" in prog.lowered_text()
    assert prog.num_ops() > 0
    assert prog.input_specs[0].static_shape() == (1, 4)


def test_executor_feed_fetch():
    net = _MLP(out=2)
    prog = static.build_program(net, [InputSpec((-1, 4), "float32", "x")])
    exe = static.Executor()
    x = np.ones((2, 4), np.float32)
    (by_name,) = exe.run(prog, feed={"x": x}, fetch_list=None)
    (by_pos,) = exe.run(prog, feed={"other": x})
    assert by_name.shape == (2, 2)
    np.testing.assert_array_equal(by_name, by_pos)
    np.testing.assert_array_equal(by_name, _eager(net, x).numpy())
    with static.program_guard(prog):
        assert static.default_main_program() is prog
        (guarded,) = exe.run(feed={"x": x})
    np.testing.assert_array_equal(guarded, by_name)
    assert static.default_main_program() is None


def test_build_program_of_a_function_runs_on_the_named_device():
    prog = static.build_program(lambda a, b: a * b + 1,
                                [InputSpec((2,), "float32", "a"),
                                 InputSpec((2,), "float32", "b")],
                                device="cpu")
    out = prog.run(np.array([1.0, 2.0], np.float32),
                   np.array([3.0, 4.0], np.float32))
    assert out.tolist() == [4.0, 9.0]
    assert prog.device == torch.device("cpu")


def test_save_load_inference_model_roundtrip(tmp_path):
    net = _MLP(seed=1, out=2)
    x = _x((5, 4), 1)
    prefix = str(tmp_path / "model")
    static.save_inference_model(prefix, [InputSpec((5, 4), "float32", "x")],
                                layer=net)
    for ext in (".pdmodel", ".pdiparams", ".pdmeta"):
        assert os.path.exists(prefix + ext)
    meta = json.load(open(prefix + ".pdmeta"))
    assert meta["input_specs"] == [[[5, 4], "float32", "x"]]
    assert meta["name"] == "_MLP" and meta["device"] == "cpu"
    loaded = static.load_inference_model(prefix)
    assert torch.equal(loaded.run(x), _eager(net, x))
    # the parameters are graph inputs: new values in .pdiparams change
    # the output without a new export
    state = static.load_program_state(prefix)
    assert sorted(state) == sorted(n for n, _ in net.named_parameters())


def test_pdmeta_holds_the_jax_fields(tmp_path):
    pt.seed(0)
    jnet = jnn.Linear(4, 2)
    jstatic.save_inference_model(str(tmp_path / "j"),
                                 [jstatic.InputSpec((5, 4), "float32", "x")],
                                 layer=jnet)
    import pickle
    jmeta = pickle.load(open(str(tmp_path / "j") + ".pdmeta", "rb"))
    net = Linear(4, 2, device="cpu")
    static.save_inference_model(str(tmp_path / "t"),
                                [InputSpec((5, 4), "float32", "x")],
                                layer=net)
    tmeta = static.program.read_meta(str(tmp_path / "t"))
    assert set(jmeta) <= set(tmeta)
    assert [(tuple(s), d, n) for s, d, n in tmeta["input_specs"]] == \
        jmeta["input_specs"]
    assert tmeta["name"] == jmeta["name"] == "Linear"


# -- the predictor ------------------------------------------------------------

def _saved_mlp(tmp_path, shape=(2, 4)):
    net = _MLP(seed=3)
    prefix = str(tmp_path / "serve")
    static.save_inference_model(prefix, [InputSpec(shape, "float32", "x")],
                                layer=net)
    return net, prefix


def test_predictor_api(tmp_path):
    net, prefix = _saved_mlp(tmp_path)
    x = _x()
    pred = create_predictor(Config(prefix))
    assert pred.get_input_names() == ["x"]
    h = pred.get_input_handle("x")
    h.copy_from_cpu(x.astype(np.float64))  # cast to the input's dtype
    assert pred.run() is None
    out = pred.get_output_handle(pred.get_output_names()[0])
    want = _eager(net, x).numpy()
    np.testing.assert_array_equal(out.copy_to_cpu(), want)
    # share_external_data binds a device tensor without a copy
    h.share_external_data(torch.as_tensor(x))
    pred.run()
    np.testing.assert_array_equal(out.copy_to_cpu(), want)
    (got,) = pred.run([x])
    np.testing.assert_array_equal(got, want)
    assert pred.device == torch.device("cpu")


def test_predictor_pool(tmp_path):
    net, prefix = _saved_mlp(tmp_path)
    pool = PredictorPool(Config(prefix), size=2)
    assert len(pool) == 2 and pool.retrieve(0) is not pool.retrieve(1)
    assert pool.retrieve(2) is pool.retrieve(0)
    x = _x()
    outs = [pool.retrieve(i).run([x])[0] for i in range(2)]
    np.testing.assert_array_equal(outs[0], outs[1])


def test_predictor_type_helpers():
    from paddle_tpu import inference as jinf
    from paddle_tpu_torch import inference as tinf
    for name in ("FLOAT32", "INT64", "INT32", "UINT8", "INT8", "FLOAT16",
                 "BFLOAT16"):
        code = getattr(tinf.DataType, name)
        assert code == getattr(jinf.DataType, name)
        assert tinf.get_num_bytes_of_data_type(code) == \
            jinf.get_num_bytes_of_data_type(code)
    assert tinf.PlaceType.GPU == jinf.PlaceType.GPU
    assert tinf.get_num_bytes_of_data_type("float64") == 8
    assert "paddle_tpu_torch" in tinf.get_version()


def test_capi_bridge(tmp_path):
    net, prefix = _saved_mlp(tmp_path)
    x = _x()
    h = capi_bridge.create(prefix, device="cpu")
    assert capi_bridge.input_names(h) == ["x"]
    capi_bridge.set_input(h, "x", x.tobytes(), x.shape, "float32")
    n_out = capi_bridge.run(h)
    assert n_out == 1 and capi_bridge.output_names(h) == ["out0"]
    data, shape, dtype = capi_bridge.get_output(h, "out0")
    got = np.frombuffer(data, dtype).reshape(shape)
    np.testing.assert_array_equal(got, _eager(net, x).numpy())
    capi_bridge.destroy(h)
    with pytest.raises(KeyError, match="invalid predictor handle"):
        capi_bridge.run(h)


# -- the device rule ----------------------------------------------------------

def _as_card_program(prefix):
    """The meta of a program exported on the card (the device is all
    the predictor reads before it loads anything)."""
    meta = static.program.read_meta(prefix)
    meta["device"] = "cuda:0"
    with open(prefix + ".pdmeta", "w") as f:
        json.dump(meta, f)


def test_disable_gpu_refuses_a_card_program(tmp_path):
    _, prefix = _saved_mlp(tmp_path)
    _as_card_program(prefix)
    cfg = Config(prefix)
    cfg.disable_gpu()
    with pytest.raises(RuntimeError, match=r"exported for cuda:0.*on cpu"):
        create_predictor(cfg)
    with pytest.raises(RuntimeError, match="exported for cuda:0"):
        capi_bridge.create(prefix, device="cpu")


def test_a_cpu_program_refuses_the_gpu(tmp_path):
    _, prefix = _saved_mlp(tmp_path)
    cfg = Config(prefix)
    cfg.enable_use_gpu()
    with pytest.raises(RuntimeError, match=r"exported for cpu.*on cuda"):
        create_predictor(cfg)
    cfg = Config(prefix)
    cfg.disable_gpu()
    assert create_predictor(cfg).device == torch.device("cpu")


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults run on it")


def test_entry_points_raise_without_a_gpu(tmp_path):
    _no_card()
    _, prefix = _saved_mlp(tmp_path)
    _as_card_program(prefix)
    with pytest.raises(RuntimeError, match="no usable GPU"):
        create_predictor(Config(prefix))
    with pytest.raises(RuntimeError, match="no usable GPU"):
        capi_bridge.create(prefix)
    with pytest.raises(RuntimeError, match="no usable GPU"):
        static.build_program(lambda x: x + 1, [InputSpec((2,))])
    with pytest.raises(RuntimeError, match="no usable GPU"):
        EvalStep(_MLP())
    with pytest.raises(RuntimeError, match="no usable GPU"):
        static.create_global_var((2,), 1.0, "float32")


# -- the slice as a whole: config 5 at the JAX benchmark's CPU size -----------

def _resnet_pair():
    pt.seed(0)
    j = jmodels.resnet18(num_classes=10)
    t = tmodels.resnet18(num_classes=10, device="cpu")
    state = jax_state(j)
    rng = np.random.default_rng(3)
    for k in state:
        if k.endswith("._mean"):
            state[k] = rng.normal(0, 0.3, state[k].shape).astype(np.float32)
        elif k.endswith("._variance"):
            state[k] = rng.uniform(0.5, 2.0, state[k].shape).astype(
                np.float32)
    j.set_state_dict(state)
    load_jax_state(t, state)
    x = np.random.default_rng(0).standard_normal((1, 3, 64, 64)).astype(
        np.float32)
    return j, t, (1, 3, 64, 64), "float32", "x", x


def _bert_pair():
    pt.seed(0)
    j = jb.BertForSequenceClassification(jb.bert_tiny())
    t = tb.BertForSequenceClassification(tb.bert_tiny(), device="cpu")
    load_jax_state(t, jax_state(j))
    ids = np.random.default_rng(0).integers(0, 1024, (1, 32)).astype(
        np.int32)
    return j, t, (1, 32), "int32", "input_ids", ids


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", ["resnet18", "bert_tiny"])
def test_config5_predictors_match_jax(tmp_path, model, precision):
    j, t, shape, dtype, name, x = (_resnet_pair() if model == "resnet18"
                                   else _bert_pair())
    j.eval()
    t.eval()
    jprefix, tprefix = str(tmp_path / "jax"), str(tmp_path / "port")
    jstatic.save_inference_model(jprefix,
                                 [jstatic.InputSpec(shape, dtype, name)],
                                 layer=j)
    static.save_inference_model(tprefix, [InputSpec(shape, dtype, name)],
                                layer=t)
    if model == "resnet18":
        # optimize=True folded the copy: no BN in the port's graph
        text = open(tprefix + ".pdmodel", "rb").read()
        assert b"batch_norm" not in text
    jcfg, tcfg = JConfig(jprefix), Config(tprefix)
    for cfg in (jcfg, tcfg):
        cfg.set_precision(precision)
    want = jcreate(jcfg).run([x])[0]
    got = create_predictor(tcfg).run([x])[0]
    scale = float(np.max(np.abs(want)))
    gap = float(np.max(np.abs(got - want))) / scale
    print(f"{model} {precision}: {gap:.3g} of the largest magnitude")
    assert got.shape == want.shape
    assert gap <= PRED_TOL
    if precision == "bfloat16":
        # the storage changes the outputs in both packages alike
        full = create_predictor(Config(tprefix)).run([x])[0]
        assert not np.array_equal(full, got)


def test_bf16_storage_is_fp32_over_rounded_parameters(tmp_path):
    """A bf16-storage predictor equals an fp32 one over parameters
    pre-rounded to bf16, bitwise (the casts back are exact)."""
    _, t, shape, dtype, name, x = _bert_pair()
    t.eval()
    static.save_inference_model(str(tmp_path / "a"),
                                [InputSpec(shape, dtype, name)], layer=t)
    with torch.no_grad():
        for p in t.parameters():
            p.copy_(p.to(torch.bfloat16).to(torch.float32))
    static.save_inference_model(str(tmp_path / "b"),
                                [InputSpec(shape, dtype, name)], layer=t)
    cfg = Config(str(tmp_path / "a"))
    cfg.enable_low_precision("bfloat16")
    low = create_predictor(cfg).run([x])[0]
    rounded = create_predictor(Config(str(tmp_path / "b"))).run([x])[0]
    np.testing.assert_array_equal(low, rounded)


def test_optimize_keeps_the_callers_layer(tmp_path):
    _, t, shape, dtype, name, x = _resnet_pair()
    t.eval()
    before = {k: v.clone() for k, v in t.state_dict().items()}
    static.save_inference_model(str(tmp_path / "r"),
                                [InputSpec(shape, dtype, name)], layer=t)
    after = t.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    got = create_predictor(Config(str(tmp_path / "r"))).run([x])[0]
    want = _eager(t, x).numpy()
    assert np.max(np.abs(got - want)) <= 1e-4 * np.max(np.abs(want))


# -- to_static, jit.save / load, TracedLayer, EvalStep ------------------------

class _Gate(torch.nn.Module):
    """A Layer whose forward branches on its input's sum."""

    def __init__(self):
        super().__init__()
        self.fc = Linear(4, 4, device="cpu",
                         generator=torch.Generator().manual_seed(4))

    def forward(self, x):
        if x.sum() > 0:
            y = self.fc(x)
        else:
            y = x * 2
        return y


def test_to_static_layer_exports_its_converted_forward(tmp_path):
    layer = to_static(_Gate())
    pos, neg = np.ones((1, 4), np.float32), -np.ones((1, 4), np.float32)
    prefix = str(tmp_path / "gate")
    static.save_inference_model(prefix, [InputSpec((1, 4), "float32", "x")],
                                layer=layer)
    pred = create_predictor(Config(prefix))
    for x in (pos, neg):
        assert np.array_equal(pred.run([x])[0], _eager(layer, x).numpy())
    assert not np.array_equal(pred.run([pos])[0], 2 * pos)
    np.testing.assert_array_equal(pred.run([neg])[0], 2 * neg)
    # without the rewrite the export cannot keep the branch
    with pytest.raises(Exception):
        static.build_program(_Gate(), [InputSpec((1, 4))]).exported()


def test_jit_save_load(tmp_path):
    net = _MLP(seed=5)
    jit_save(net, str(tmp_path / "m"))
    blob = jit_load(str(tmp_path / "m"))
    assert blob["class"].endswith("test_torch_static._MLP")
    fresh = _MLP(seed=6)
    fresh.load_state_dict(blob["state_dict"])
    x = _x()
    assert torch.equal(_eager(fresh, x), _eager(net, x))


def test_traced_and_translated_layer(tmp_path):
    net = _MLP(seed=7)
    net.eval()
    x = torch.as_tensor(_x())
    outs, traced = TracedLayer.trace(net, [x])
    assert torch.equal(traced([x]), outs)
    traced.save_inference_model(str(tmp_path / "t"))
    tl = TranslatedLayer.from_path(str(tmp_path / "t"))
    assert torch.equal(tl(x), outs)
    assert tl.eval() is tl and not tl.training
    with pytest.raises(RuntimeError, match="frozen inference program"):
        tl.train()


def test_eval_step():
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(4, 4), torch.nn.Dropout(0.5))
    model.train()
    step = EvalStep(model, device="cpu")
    x = torch.randn(3, 4)
    x.requires_grad_(True)
    out = step(x)
    assert not model.training and not out.requires_grad
    assert torch.equal(out, step(x))  # dropout off
    with pytest.raises(ValueError, match="lives on"):
        EvalStep(model, device="meta")


def test_eval_step_draws_a_fresh_key_a_call():
    class Noisy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(()))

        def forward(self, x):
            return x + torch.rand(x.shape, generator=trng.next_generator())

    step = EvalStep(Noisy(), seed=3, device="cpu")
    a, b = step(torch.zeros(4)), step(torch.zeros(4))
    again = EvalStep(Noisy(), seed=3, device="cpu")
    assert not torch.equal(a, b)
    assert torch.equal(again(torch.zeros(4)), a)


# -- framework.io, crypto -----------------------------------------------------

def _nest():
    g = torch.Generator().manual_seed(9)
    return {"w": torch.randn(3, 2, generator=g),
            "p": torch.nn.Parameter(torch.randn(2, generator=g)),
            "arr": np.arange(5, dtype=np.int64),
            "meta": {"step": 7, "name": "x", "lr": [0.1, (1, 2)]}}


@pytest.mark.parametrize("key", [None, b"secret-key"])
def test_framework_io_roundtrip(tmp_path, key):
    obj = _nest()
    path = str(tmp_path / "sub" / "ckpt.pdparams")
    framework.save(obj, path, cipher_key=key)
    got = framework.load(path, cipher_key=key)
    assert torch.equal(got["w"], obj["w"])
    assert isinstance(got["p"], torch.nn.Parameter)
    assert torch.equal(got["p"], obj["p"])
    np.testing.assert_array_equal(got["arr"], obj["arr"])
    assert got["meta"] == obj["meta"]
    as_np = framework.load(path, return_numpy=True, cipher_key=key)
    assert isinstance(as_np["w"], np.ndarray)
    if key is not None:
        assert open(path, "rb").read(6) == b"PTENC2"
        with pytest.raises(ValueError, match="encrypted artifact"):
            framework.load(path)
        with pytest.raises(ValueError, match="integrity"):
            framework.load(path, cipher_key=b"wrong")


def test_aes_known_answers():
    # FIPS-197 appendix C.1, through the vectorised keystream (one
    # counter block whose value is the plaintext)
    key = bytes(range(16))
    pt_block = bytes.fromhex("00112233445566778899aabbccddeeff")
    rk = np.array(tcrypto._expand_key(key), np.uint8).reshape(11, 16)
    got = tcrypto._keystream(rk, pt_block, 0, 1).tobytes()
    assert got.hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"
    assert tcrypto._encrypt_block_py(tcrypto._expand_key(key),
                                     pt_block).hex() == got.hex()
    assert tcrypto._sbox()[:4] == [0x63, 0x7C, 0x77, 0x7B]


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 255, 4096 + 3])
def test_aes_ctr_matches_jax(n):
    rng = np.random.default_rng(n)
    key = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
    # a counter about to wrap its low 8 bytes
    iv = bytes([7] * 8 + [255] * 7 + [250])
    data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    got = tcrypto.aes128_ctr(key, iv, data)
    assert got == jcrypto.aes128_ctr_py(key, iv, data)
    assert got == jcrypto.aes128_ctr(key, iv, data)


def test_cipher_envelopes_cross_the_packages():
    data = np.random.default_rng(1).integers(0, 256, 1000,
                                             dtype=np.uint8).tobytes()
    key = b"shared"
    assert tcrypto.AESCipher(key).decrypt(
        jcrypto.AESCipher(key).encrypt(data)) == data
    assert jcrypto.AESCipher(key).decrypt(
        tcrypto.AESCipher(key).encrypt(data)) == data
    blob = bytearray(tcrypto.AESCipher(key).encrypt(data))
    blob[-1] ^= 1
    with pytest.raises(ValueError, match="integrity"):
        tcrypto.AESCipher(key).decrypt(bytes(blob))
    assert len(tcrypto.CipherFactory.generate_key()) == 16


# -- the trainer runtime ------------------------------------------------------

class _Channels:
    """An in-memory dataset: samples dealt round-robin to the channels,
    as the reference's ``InMemoryDataset.channels`` deals them."""

    def __init__(self, samples, batch_size, drop_last=False):
        self.samples = samples
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.thread_num = 1

    def channels(self, n):
        return [self.samples[i::n] for i in range(n)]


def _samples(n=40):
    out = []
    for i in range(n):
        sign = (i % 2) * 2 - 1
        out.append({"feat": np.array([sign, 1.0, 2.0, 3.0], np.float32),
                    "label": np.array([i % 2], np.int64)})
    return out


def _train_pair():
    pt.seed(0)

    class J(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = jnn.Linear(4, 2)

        def forward(self, feat, label):
            return jnn.functional.cross_entropy(self.fc(feat),
                                                label.reshape(-1))

    from paddle_tpu import optimizer as jopt
    jm = J()
    jstep = JTrainStep(jm, jopt.SGD(learning_rate=0.2),
                       lambda mm, b: mm(b["feat"], b["label"]))

    class T(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = Linear(4, 2, device="cpu")

        def forward(self, feat, label):
            return tnf.cross_entropy(self.fc(feat), label.reshape(-1))

    tm = T()
    load_jax_state(tm, jax_state(jm))
    tstep = TrainStep(tm, SGD(learning_rate=0.2),
                      lambda m, b: m(b["feat"], b["label"]), device="cpu")
    return jstep, tstep, tm


def test_train_from_dataset_matches_jax():
    jstep, tstep, _ = _train_pair()
    ds = _Channels(_samples(), batch_size=8)
    want = jstatic.Executor().train_from_dataset(jstep, ds, thread=1)
    got = static.Executor().train_from_dataset(tstep, ds, thread=1)
    assert got["steps"] == want["steps"] == 5
    np.testing.assert_allclose(got["avg_loss"], want["avg_loss"],
                               rtol=LOSS_RTOL)


def test_train_from_dataset_threads_and_drop_last():
    _, tstep, _ = _train_pair()
    ds = _Channels(_samples(41), batch_size=4, drop_last=True)
    r = static.Executor().train_from_dataset(tstep, ds, thread=3)
    # 14 + 14 + 13 samples a channel: 3 + 3 + 3 full batches
    assert r["steps"] == 9 and np.isfinite(r["avg_loss"])
    ds.drop_last = False
    assert static.Executor().train_from_dataset(
        tstep, ds, thread=3)["steps"] == 12


def test_program_dict_feed_by_name():
    prog = static.build_program(
        lambda label, feat: (feat * label).sum(),
        [InputSpec((2, 4), "float32", "label"),
         InputSpec((2, 4), "float32", "feat")], device="cpu")
    ds = _Channels([{"feat": np.full(4, 2.0, np.float32),
                     "label": np.full(4, 3.0, np.float32)}] * 4,
                   batch_size=2)
    r = static.Executor().infer_from_dataset(prog, ds, thread=1,
                                             fetch_list=[0])
    assert r["steps"] == 2 and r["avg_loss"] == 48.0
    assert float(r["fetches"][0]) == 48.0
    bad = static.build_program(lambda a: a.sum(),
                               [InputSpec((2, 4), "float32", "missing")],
                               device="cpu")
    with pytest.raises(KeyError, match="do not cover program inputs"):
        static.Executor().infer_from_dataset(bad, ds, thread=1)


def test_trainer_refusals():
    _, tstep, _ = _train_pair()
    ds = _Channels(_samples(8), batch_size=4)
    with pytest.raises(TypeError, match="must not mutate state"):
        static.Executor().infer_from_dataset(tstep, ds)
    with pytest.raises(KeyError, match="DistMultiTrainer waits"):
        static.Executor().train_from_dataset(tstep, ds,
                                             trainer="DistMultiTrainer")
    assert not hasattr(framework, "DistMultiTrainer")

    def boom(batch, worker_id):
        raise ValueError("worker failed")

    with pytest.raises(ValueError, match="worker failed"):
        framework.MultiTrainer(boom, thread_num=2).run(ds)


# -- the module-level static API ----------------------------------------------

def test_serialize_and_state_api(tmp_path):
    net = _MLP(seed=8)
    prog = static.build_program(net, [InputSpec((2, 4), "float32", "x")])
    x = _x()
    ep = static.deserialize_program(static.serialize_program(prog))
    want = prog.run(x)
    assert torch.equal(ep.module()(prog.params, prog.buffers,
                                   torch.as_tensor(x)), want)
    blob = static.serialize_persistables(prog)
    zeroed = {k: torch.zeros_like(v) for k, v in prog.params.items()}
    prog.params = zeroed
    assert not torch.equal(prog.run(x), want)
    static.deserialize_persistables(prog, blob)
    assert torch.equal(prog.run(x), want)
    path = str(tmp_path / "p" / "prog")
    static.save(prog, path)
    state = static.load_program_state(path)
    static.set_program_state(prog, {k: np.zeros_like(v)
                                    for k, v in state.items()})
    static.load(prog, path)
    assert torch.equal(prog.run(x), want)
    static.save_to_file(str(tmp_path / "b" / "raw"), b"abc")
    assert static.load_from_file(str(tmp_path / "b" / "raw")) == b"abc"
    assert static.normalize_program(prog) is prog


def test_scopes_guards_and_vars():
    scope = static.Scope()
    with static.scope_guard(scope):
        v = static.create_global_var((2,), 3.0, "float32", name="gv",
                                     device="cpu")
        assert static.global_scope().find_var("gv") is v
        p = static.create_parameter((3, 2), "float32", name="cp",
                                    device="cpu")
        assert static.global_scope().var("cp") is p
    assert static.global_scope() is not scope
    assert scope.new_scope().find_var("gv") is v
    with static.device_guard("gpu:0"):
        assert static.api.current_device_tag() == "gpu:0"
    with static.name_scope("blk"):
        pass
    x = torch.ones(2)
    assert static.Print(x, message="x") is x
    assert static.BuildStrategy().enable_inplace
    assert static.ExecutionStrategy().num_iteration_per_run == 1
    static.default_startup_program().random_seed = 5
    assert static.default_startup_program().random_seed == 5


def test_py_func_and_autodiff_facades():
    x = torch.tensor([1.0, 2.0, 3.0], requires_grad=True)
    out = static.py_func(lambda a: a * a, x, torch.empty(3),
                         backward_func=lambda a, g: 2 * a * g)
    out.sum().backward()
    assert out.tolist() == [1.0, 4.0, 9.0]
    assert x.grad.tolist() == [2.0, 4.0, 6.0]
    w = torch.nn.Parameter(torch.tensor([2.0, 3.0]))
    b = torch.nn.Parameter(torch.tensor(1.0))
    loss = (w * torch.tensor([1.0, 4.0])).sum() + b
    pairs = static.append_backward(loss)
    assert {id(p) for p, _ in pairs} == {id(w), id(b)}
    assert w.grad.tolist() == [1.0, 4.0] and float(b.grad) == 1.0
    y = torch.tensor([3.0], requires_grad=True)
    z = torch.tensor([1.0], requires_grad=True)
    gy, gz = static.gradients([(y * y).sum()], [y, z])
    assert gy.tolist() == [6.0] and gz is None


def test_auc_matches_jax():
    rng = np.random.default_rng(4)
    scores = rng.uniform(0, 1, (64, 2)).astype(np.float32)
    labels = rng.integers(0, 2, (64, 1)).astype(np.int64)
    ja, _, jstats = jstatic.auc(pt.Tensor(jnp.asarray(scores)),
                                pt.Tensor(jnp.asarray(labels)))
    ta, _, tstats = static.auc(torch.as_tensor(scores),
                               torch.as_tensor(labels))
    np.testing.assert_allclose(float(ta), float(np.asarray(ja.value)),
                               rtol=1e-6)
    for t, j in zip(tstats, jstats):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j.value))
