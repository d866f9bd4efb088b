"""The port's public surface against the JAX package's: the top-level,
``nn`` and ``nn.functional`` names and the ``Tensor`` methods; every
name not ported yet raises ``NotImplementedError`` naming ROADMAP.md;
a Paddle-style ``nn.Layer`` model trained eagerly on ``Tensor``s with
the JAX package's loss trajectory; ``Layer`` on plain torch tensors
returning plain torch tensors; and the base-class switch leaving the
GPT engine's tokens where they were (pinned on ``gpt_tiny``).

Tolerance: the CNN's losses within rtol 2e-4 / atol 2e-5 of JAX's
eager loop (``tests/test_model_mode_parity.py``'s own limits); the
engine's tokens and loss bitwise the pins.
"""

import _torch_threads  # noqa: F401

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from paddle_tpu_torch._not_ported import NotPorted
from paddle_tpu_torch.core import place

REPO = __file__.rsplit("/tests/", 1)[0]


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    place.set_device("cpu")
    yield
    place.reset_device()


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


@pytest.mark.parametrize("jmod,tmod", [
    ("paddle_tpu", "paddle_tpu_torch"),
    ("paddle_tpu.nn", "paddle_tpu_torch.nn"),
    ("paddle_tpu.nn.functional", "paddle_tpu_torch.nn.functional"),
])
def test_public_names_cover_the_jax_package(jmod, tmod):
    """The JAX module's names as a fresh import of it lists them (in a
    test process other tests' imports add submodules to its dir)."""
    import importlib
    import json
    code = (f"import json, importlib; m = importlib.import_module({jmod!r})"
            f"; print(json.dumps(sorted(n for n in dir(m) "
            f"if not n.startswith('_'))))")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-2000:]
    jnames = set(json.loads(r.stdout.strip().splitlines()[-1]))
    t = importlib.import_module(tmod)
    missing = sorted(jnames - _public(t))
    assert not missing, missing
    for name in sorted(jnames):
        assert getattr(t, name) is not None, name


def test_tensor_methods_cover_the_jax_tensor():
    missing = sorted(_public(pt.Tensor) - _public(paddle.Tensor))
    assert not missing, missing


def _not_ported_names():
    out = []
    for modname in ("paddle_tpu_torch", "paddle_tpu_torch.nn"):
        import importlib
        mod = importlib.import_module(modname)
        for name in sorted(_public(mod)):
            if isinstance(getattr(mod, name), NotPorted):
                out.append((modname, name))
    return out


def test_the_not_ported_names_are_the_expected_ones():
    names = {n for _, n in _not_ported_names()}
    assert names == {"DataParallel", "native"}
    assert not names & {"to_tensor", "Tensor", "grad", "no_grad", "Layer",
                        "add", "reshape", "topk", "rand", "seed", "linalg",
                        "fft", "TensorArray", "array_write", "LayerList",
                        "LayerDict", "ParameterList", "functional_call",
                        "bind_state", "functional_state"}
    assert not isinstance(pt_nn_utils(), NotPorted)


def pt_nn_utils():
    import paddle_tpu_torch.nn as tnn
    return tnn.utils


@pytest.mark.parametrize("modname,name", _not_ported_names())
def test_a_name_not_ported_raises_naming_the_roadmap(modname, name):
    import importlib
    obj = getattr(importlib.import_module(modname), name)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        obj()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        obj.anything


def test_registered_ops_not_ported_raise_naming_the_roadmap():
    from paddle_tpu_torch import dispatch
    from paddle_tpu_torch.ops.registry import all_ops
    stubs = [n for n, o in all_ops().items() if not o.ported]
    assert stubs == ["paged_attention_head_sharded"]
    x = paddle.to_tensor(np.eye(3, dtype=np.float32))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        dispatch.wrapped_ops["paged_attention_head_sharded"](x)
    spd = np.array([[4.0, 2.0, 0.6], [2.0, 5.0, 1.0], [0.6, 1.0, 3.0]],
                   np.float32)
    a = paddle.to_tensor(spd)
    # the factor, singular values and spectrum of a known SPD matrix
    np.testing.assert_allclose(a.cholesky().numpy(),
                               np.linalg.cholesky(spd), rtol=1e-6)
    u, s, vh = paddle.linalg.svd(a)
    np.testing.assert_allclose(s.numpy(), np.linalg.svd(spd)[1],
                               rtol=1e-5)
    np.testing.assert_allclose(np.abs(paddle.fft.rfft(x).numpy()),
                               np.abs(np.fft.rfft(np.eye(3))), atol=1e-6)
    assert paddle.fft.rfft(x).dtype == paddle.complex64


def test_importing_the_package_stays_light():
    code = ("import sys\n"
            "import paddle_tpu_torch\n"
            "bad = [m for m in sys.modules if m.startswith(("
            "'paddle_tpu_torch.dispatch', 'paddle_tpu_torch.ops', "
            "'paddle_tpu_torch.nn'))]\n"
            "assert not bad, bad\n"
            "print('light')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "light" in r.stdout


def test_the_card_is_the_default_place_and_raises_without_a_gpu():
    place.reset_device()
    try:
        assert paddle.get_device() == "gpu:0"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                paddle.to_tensor([1.0])
            with pytest.raises(RuntimeError, match="CUDA"):
                paddle.zeros([2])
            with pytest.raises(RuntimeError, match="CUDA"):
                paddle.nn.Linear(2, 2)
        with pytest.raises(RuntimeError):
            paddle.set_device("tpu")
    finally:
        place.set_device("cpu")
    assert paddle.get_device() == "cpu:0"
    assert paddle.to_tensor([1.0]).place == paddle.CPUPlace()
    assert paddle.static.cpu_places(2) == [paddle.CPUPlace(0),
                                           paddle.CPUPlace(1)]


def test_dtype_names_canonicalise_as_the_jax_package():
    from paddle_tpu.core.dtype import convert_dtype as jconvert
    from paddle_tpu_torch.core.dtype import convert_dtype, dtype_name
    for spelling in ("float32", "float64", "int64", "int32", "bool", "int",
                     "long", "float", "bf16", "fp16", "complex128", "uint8",
                     np.int64, np.float64, "int8", "int16"):
        assert dtype_name(convert_dtype(spelling)) == str(np.dtype(
            jconvert(spelling))), spelling
    assert paddle.get_default_dtype() == pt.get_default_dtype()
    assert isinstance(paddle.to_tensor([1.0]).dtype, paddle.dtype)


def test_parameter_is_a_torch_parameter_with_paddle_names():
    p = paddle.create_parameter([2, 3], name="w0")
    assert isinstance(p, torch.nn.Parameter) and isinstance(
        p, paddle.Parameter)
    assert p.name == "w0" and not p.stop_gradient and p.trainable
    assert p.optimize_attr == {"learning_rate": 1.0} and p.need_clip
    p.stop_gradient = True
    assert not p.requires_grad
    p.stop_gradient = False
    (paddle.to_tensor(np.ones((2, 3), np.float32)) * p).sum().backward()
    np.testing.assert_array_equal(p.gradient(), np.ones((2, 3)))
    assert isinstance(p.numpy(), np.ndarray)
    assert p.astype("float16").dtype == paddle.float16
    p.clear_grad()
    assert p.grad is None
    assert torch.zeros(2).name is None


def test_layer_on_plain_torch_tensors_returns_plain_torch_tensors():
    lin = paddle.nn.Linear(4, 3)
    out = lin(torch.ones(2, 4))
    assert type(out) is torch.Tensor
    wrapped = lin(paddle.to_tensor(np.ones((2, 4), np.float32)))
    assert isinstance(wrapped, paddle.Tensor)
    np.testing.assert_array_equal(wrapped.numpy(), out.detach().numpy())
    seen = []
    lin.register_forward_post_hook(lambda m, i, o: seen.append(type(o)))
    lin(paddle.to_tensor(np.ones((2, 4), np.float32)))
    assert seen == [torch.Tensor]


class _Net(paddle.nn.Layer):
    """A Paddle-style Layer: parameters from ``create_parameter``, a
    sublayer from ``add_sublayer``, ops from the top level."""

    def __init__(self):
        super().__init__()
        self.w = self.create_parameter([4, 3])
        self.b = self.create_parameter([3], is_bias=True)
        self.act = self.add_sublayer("act", paddle.nn.ReLU())

    def forward(self, x):
        return self.act(paddle.matmul(x, self.w) + self.b)


def test_paddle_style_layer_names():
    net = _Net()
    assert [n for n, _ in net.named_parameters()] == ["w", "b"]
    assert net.sublayers() == [net.act]
    assert net.full_name() == "_net"
    out = net(paddle.to_tensor(np.ones((2, 4), np.float32)))
    assert isinstance(out, paddle.Tensor) and out.shape == (2, 3)
    out.sum().backward()
    assert net.w.grad is not None
    net.clear_gradients()
    assert net.w.grad is None
    state = {k: v.detach().numpy() * 0 + 1 for k, v in
             net.state_dict().items()}
    assert net.set_state_dict(state) == []
    np.testing.assert_array_equal(net.w.detach().numpy(), np.ones((4, 3)))
    net.register_buffer("steps", paddle.to_tensor([0]), persistable=False)
    assert "steps" not in net.state_dict()


# -- the CNN of tests/test_model_mode_parity.py, trained eagerly ---------------

def _jax_cnn():
    pt.seed(7)
    jnn = pt.nn
    return jnn.Sequential(
        jnn.Conv2D(1, 8, 3, padding=1), jnn.ReLU(), jnn.MaxPool2D(2, 2),
        jnn.Flatten(), jnn.Linear(8 * 4 * 4, 10))


def _port_cnn(jmodel):
    from paddle_tpu_torch.nn.layer import load_jax_state
    nn = paddle.nn
    model = nn.Sequential(
        nn.Conv2D(1, 8, 3, padding=1), nn.ReLU(), nn.MaxPool2D(2, 2),
        nn.Flatten(), nn.Linear(8 * 4 * 4, 10))
    load_jax_state(model, {k: np.asarray(v.numpy())
                           for k, v in jmodel.state_dict().items()})
    return model


def _cnn_batches(n=6):
    rng = np.random.default_rng(3)
    return [(rng.standard_normal((8, 1, 8, 8)).astype("float32"),
             (rng.integers(0, 10, 8)).astype("int64")) for _ in range(n)]


def _eager_losses(P, model, batches, lr=0.1):
    opt = P.optimizer.SGD(learning_rate=lr, parameters=model.parameters())
    losses = []
    for x, y in batches:
        loss = P.nn.functional.cross_entropy(model(P.to_tensor(x)),
                                             P.to_tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    return losses


def test_cnn_eager_loop_matches_the_jax_eager_loop():
    batches = _cnn_batches()
    jmodel = _jax_cnn()
    tmodel = _port_cnn(jmodel)
    want = _eager_losses(pt, jmodel, batches)
    got = _eager_losses(paddle, tmodel, batches)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    assert got[-1] < got[0]


# -- the base-class switch leaves the engine where it was ----------------------

# gpt_tiny from torch.Generator seed 5 on the CPU, five prompts through two
# slots of 10 pages of 8 tokens, 8 new tokens each; recorded on the tree
# before the port's layers took ``Layer`` as their base
PINNED_STREAMS = [
    [871, 652, 523, 276, 315, 18, 20, 20, 20, 20, 20, 214, 214],
    [41, 77, 16, 179, 832, 665, 934, 515, 621, 870, 870, 870, 870, 870,
     870, 870, 870],
    [994, 747, 647, 556, 573, 957, 284, 835, 686, 2, 403, 877, 567, 555,
     555, 555, 555, 555, 555, 555, 555],
    [34, 783, 747, 866, 179, 91, 883, 983, 1013, 1013, 1013, 1013, 1013,
     1013, 1013],
    [22, 554, 82, 306, 492, 432, 412, 28, 5, 127, 8, 686, 538, 662, 263,
     630, 782, 392, 471, 1021, 399, 399, 399, 399, 399, 399, 399, 399],
]
PINNED_LOSS = 6.9590020179748535


def test_gpt_engine_tokens_are_unchanged_by_the_layer_base_class():
    from paddle_tpu_torch.inference import create_decode_engine
    from paddle_tpu_torch.models import gpt as tgpt
    m = tgpt.GPTForCausalLM(tgpt.gpt_tiny(), device="cpu",
                            generator=torch.Generator().manual_seed(5))
    m.eval()
    assert isinstance(m, paddle.nn.Layer) and isinstance(m.gpt.h[0],
                                                         paddle.nn.Layer)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 1024, n).astype(np.int32)
               for n in (5, 9, 13, 7, 20)]
    eng = create_decode_engine(m, device="cpu", num_slots=2, page_size=8,
                               max_seq_len=64, num_pages=10)
    rids = [eng.submit(p, max_new_tokens=8) for p in prompts]
    res = eng.run()
    eng.close()
    assert [res[r].tolist() for r in rids] == PINNED_STREAMS
    ids = np.stack([prompts[1][:8], prompts[2][:8]])
    with torch.no_grad():
        plain = float(m(torch.from_numpy(ids.astype(np.int64)),
                        labels=torch.from_numpy(ids.astype(np.int64))))
        eager = m(paddle.to_tensor(ids), labels=paddle.to_tensor(ids))
    assert plain == PINNED_LOSS
    assert isinstance(eager, paddle.Tensor) and float(eager) == PINNED_LOSS


def test_module_types():
    assert isinstance(paddle.nn, types.ModuleType)
    assert isinstance(paddle.nn.functional.relu(paddle.to_tensor(
        [-1.0, 2.0])), paddle.Tensor)


# -- the dispatch layer's hooks ---------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("matmul", 2), ("exp", 1), ("add", 2)])
def test_auto_cast_at_dispatch_matches_jax(name, args):
    rng = np.random.default_rng(9)
    xs = [rng.standard_normal((3, 3)).astype(np.float32)
          for _ in range(args)]
    with pt.amp.auto_cast():
        j = getattr(pt, name)(*[pt.to_tensor(x) for x in xs])
    with paddle.amp.auto_cast():
        with paddle.amp.record_casts() as casts:
            t = getattr(paddle, name)(*[paddle.to_tensor(x) for x in xs])
    from paddle_tpu_torch.core.dtype import dtype_name
    assert dtype_name(t.dtype) == str(np.dtype(j.dtype))
    assert [c[0] for c in casts] == [name]


def test_check_nan_inf_flag_and_op_counter():
    from paddle_tpu_torch import dispatch
    from paddle_tpu_torch.core.enforce import EnforceNotMet
    x = paddle.to_tensor([0.0, 1.0])
    with dispatch.count_op_calls() as c:
        paddle.log(x + 1.0)
    assert c.count == 2
    paddle.set_flags({"check_nan_inf": True})
    try:
        with pytest.raises(EnforceNotMet, match="log"):
            paddle.log(x)
    finally:
        paddle.set_flags({"check_nan_inf": False})


def test_mode_unique_name_and_batch():
    assert paddle.in_dynamic_mode()
    paddle.enable_static()
    try:
        assert not paddle.in_dynamic_mode()
    finally:
        paddle.disable_static()
    from paddle_tpu_torch.framework import unique_name
    with unique_name.guard():
        assert unique_name.generate("fc") == "fc_0"
        assert unique_name.generate("fc") == "fc_1"
    reader = paddle.batch(lambda: iter(range(5)), 2)
    assert list(reader()) == [[0, 1], [2, 3], [4]]
    paddle.check_shape([2, 3])
    with pytest.raises(TypeError):
        paddle.check_shape(3)


def test_an_op_returning_its_input_gives_a_tensor_of_its_own():
    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    y = x.astype("float32")
    y.stop_gradient = True
    assert not x.stop_gradient and y.value is not x.value
    (paddle.real(x) * 2).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), [2.0, 2.0])


def _accepted_cases():
    """Calls a script written for the JAX package makes, each with the
    keyword or default the JAX function takes: ``(jax call, port call)``,
    each returning a value the two packages should agree on."""
    import jax.numpy as jnp
    import paddle_tpu.nn as jnn
    import paddle_tpu.nn.functional as jF
    import paddle_tpu_torch.nn as tnn
    import paddle_tpu_torch.nn.functional as tF
    from paddle_tpu.core import dtype as jdt, monitor as jmon
    from paddle_tpu.ops import nn_functional as jnf
    from paddle_tpu.optimizer import ClipGradByGlobalNorm as JClip
    from paddle_tpu_torch.core import dtype as tdt, monitor as tmon
    from paddle_tpu_torch.ops import nn_functional as tnf
    from paddle_tpu_torch.optimizer import ClipGradByGlobalNorm as TClip

    ids = np.array([[0, 2, 1], [3, 0, 2]], np.int32)
    w = np.arange(12, dtype=np.float32).reshape(4, 3)
    grads = {"a": np.array([3.0, 4.0], np.float32),
             "b": np.array([12.0], np.float32)}
    pool = np.zeros((3, 2, 2), np.float32)
    block = np.ones((2, 2), np.float32)

    def tree(mod, Linear, **kw):
        m = mod.LayerList([Linear(2, 3, **kw)])
        m.append(layer=Linear(3, 3, **kw))
        m.insert(0, layer=Linear(2, 2, **kw))
        m.extend(layers=[Linear(3, 1, **kw)])
        return [tuple(l.weight.shape) for l in m]

    def params(mod, p, **kw):
        pl = mod.ParameterList()
        pl.append(parameter=p)
        return len(pl)

    def named(m):
        return ([n for n, _ in m.named_parameters("net", True)],
                len(list(m.parameters(include_sublayers=False))),
                [n for n, _ in m.named_parameters(
                    prefix="p", include_sublayers=False)])

    def counted(mon):
        stat = mon.stat("surface_case")
        stat.reset()
        stat.add(3)
        return mon.stat("surface_case").get()

    def nested(mod, **kw):
        outer = mod.Sequential(mod.Linear(2, 2, **kw))
        outer.add_parameter("scale", pt.create_parameter(
            [1], "float32") if mod is jnn else torch.nn.Parameter(
                torch.ones(1)))
        return outer

    return {
        "embedding_padding_idx_sparse": (
            lambda: np.asarray(jF.embedding(pt.to_tensor(ids),
                                            pt.to_tensor(w), padding_idx=0,
                                            sparse=True).value),
            lambda: tF.embedding(torch.from_numpy(ids).long(),
                                 torch.from_numpy(w), 0, True).numpy()),
        "dropout_name": (
            lambda: jnn.Dropout(0.25, name="drop").p,
            lambda: tnn.Dropout(0.25, name="drop").p),
        "clip_group_name": (
            lambda: {k: np.asarray(v) for k, v in JClip(
                1.0, group_name="g").apply(grads).items()},
            lambda: {k: v.numpy() for k, v in TClip(
                1.0, group_name="g").apply({k: torch.from_numpy(v) for k, v
                                            in grads.items()}).items()}),
        "seed_keyword": (
            lambda: (pt.seed(seed=5), np.asarray(pt.rand([3]).value).shape)
            [1],
            lambda: (paddle.seed(seed=5), tuple(paddle.rand([3]).shape))[1]),
        "paged_page_splice_default_page": (
            lambda: np.asarray(jnf.paged_page_splice(jnp.asarray(pool),
                                                     block)),
            lambda: tnf.paged_page_splice(torch.from_numpy(pool.copy()),
                                          torch.from_numpy(block)).numpy()),
        "layer_parameters_keywords": (
            lambda: named(nested(jnn)),
            lambda: named(nested(tnn, device="cpu"))),
        "layer_list_keywords": (
            lambda: tree(jnn, jnn.Linear),
            lambda: tree(tnn, tnn.Linear, device="cpu")),
        "parameter_list_append": (
            lambda: params(jnn, pt.create_parameter([2], "float32")),
            lambda: params(tnn, torch.nn.Parameter(torch.zeros(2)))),
        "dtype_info": (
            lambda: (float(jdt.finfo("float32").eps),
                     int(jdt.iinfo("int32").max), jdt.is_floating("bfloat16"),
                     jdt.is_integer("int8"), jdt.is_integer("float16")),
            lambda: (float(tdt.finfo("float32").eps),
                     int(tdt.iinfo("int32").max), tdt.is_floating("bfloat16"),
                     tdt.is_integer("int8"), tdt.is_integer("float16"))),
        "monitor_stat": (lambda: counted(jmon), lambda: counted(tmon)),
    }


_ACCEPTED = ["embedding_padding_idx_sparse", "dropout_name",
             "clip_group_name", "seed_keyword",
             "paged_page_splice_default_page", "layer_parameters_keywords",
             "layer_list_keywords", "parameter_list_append", "dtype_info",
             "monitor_stat"]


def _same_value(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    elif isinstance(want, np.ndarray):
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        assert got == want


@pytest.mark.parametrize("side", ["jax", "port"])
@pytest.mark.parametrize("case", _ACCEPTED)
def test_arguments_jax_accepts_are_accepted(case, side):
    """Each call of ROADMAP.md's Queue 3 open fault 3 (the keywords and
    defaults the JAX package takes and the port refused with
    ``TypeError``, and the missing ``core.dtype`` / ``core.monitor``
    names): ``[jax]`` runs it on the reference, ``[port]`` on the port
    and holds the result to the reference's (values within 1e-6)."""
    jax_call, port_call = _accepted_cases()[case]
    want = jax_call()
    if side == "port":
        _same_value(port_call(), want)
