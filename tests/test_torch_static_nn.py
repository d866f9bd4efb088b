"""``static/nn.py`` of the port against the JAX package: every builder
run in both packages from the same named parameters.

Each builder first runs in the JAX package (its parameters named by
``ParamAttr(name=...)`` in a fresh ``static.Scope``); ``load_jax_scope``
carries that scope's arrays into the port's scope, and then the JAX
builder runs again and the port's builder once, both reusing them by
name. Outputs and gradients must equal the
JAX package's within 1e-5 relative (1e-6 absolute), the moving
statistics a train-mode ``batch_norm`` writes back too. Also: reuse by
name, auto-created parameters live outside the scope, the SSD
``multi_box_head`` priors, and the control-flow / sequence /
``crf_decoding`` re-exports.
"""

import _torch_threads  # noqa: F401

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.static as jst
import paddle_tpu_torch as paddle
import paddle_tpu_torch.static as tst
from _torch_eager_parity import on_cpu
from paddle_tpu_torch.static.nn import load_jax_scope

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


R = np.random.default_rng(0)
IMG = R.standard_normal((2, 3, 6, 6)).astype(np.float32)
SEQ = R.standard_normal((2, 5, 4)).astype(np.float32)
X = R.standard_normal((3, 4)).astype(np.float32)
Y = R.standard_normal((3, 5)).astype(np.float32)
IDS = np.array([[1, 2], [3, 0]], np.int32)
VOL = R.standard_normal((1, 2, 4, 4, 4)).astype(np.float32)


def _builders():
    """(name, fn(pkg, snn, attr) -> output Tensor, inputs that get
    gradients)."""
    def a(attr, n):
        return attr(name=n)
    return [
        ("fc", lambda p, s, at: s.fc(p.to_tensor(SEQ), 6, num_flatten_dims=2,
                                     weight_attr=a(at, "w"),
                                     bias_attr=a(at, "b"),
                                     activation="relu")),
        ("fc_list", lambda p, s, at: s.fc(
            [p.to_tensor(X), p.to_tensor(X * 2.0)], 3,
            weight_attr=a(at, "w"), bias_attr=False)),
        ("embedding", lambda p, s, at: s.embedding(
            p.to_tensor(IDS), (5, 3), padding_idx=0,
            param_attr=a(at, "emb"))),
        ("sparse_embedding", lambda p, s, at: s.sparse_embedding(
            p.to_tensor(IDS), (5, 3), param_attr=a(at, "emb"))),
        ("conv2d", lambda p, s, at: s.conv2d(
            p.to_tensor(IMG), 4, 3, stride=2, padding=1, groups=1,
            param_attr=a(at, "w"), bias_attr=a(at, "b"), act="sigmoid")),
        ("conv2d_transpose", lambda p, s, at: s.conv2d_transpose(
            p.to_tensor(IMG), 4, filter_size=2, stride=2,
            param_attr=a(at, "w"), bias_attr=a(at, "b"))),
        ("conv3d", lambda p, s, at: s.conv3d(
            p.to_tensor(VOL), 3, 2, param_attr=a(at, "w"),
            bias_attr=a(at, "b"))),
        ("conv3d_transpose", lambda p, s, at: s.conv3d_transpose(
            p.to_tensor(VOL), 3, filter_size=2, stride=2,
            param_attr=a(at, "w"), bias_attr=a(at, "b"))),
        ("batch_norm", lambda p, s, at: s.batch_norm(
            p.to_tensor(IMG), param_attr=a(at, "g"), bias_attr=a(at, "b"),
            moving_mean_name="bn_m", moving_variance_name="bn_v")),
        ("batch_norm_test", lambda p, s, at: s.batch_norm(
            p.to_tensor(IMG), is_test=True, param_attr=a(at, "g"),
            bias_attr=a(at, "b"), moving_mean_name="bn_m",
            moving_variance_name="bn_v")),
        ("layer_norm", lambda p, s, at: s.layer_norm(
            p.to_tensor(SEQ), begin_norm_axis=2, param_attr=a(at, "g"),
            bias_attr=a(at, "b"))),
        ("group_norm", lambda p, s, at: s.group_norm(
            p.to_tensor(IMG), 3, param_attr=a(at, "g"),
            bias_attr=a(at, "b"), act="relu")),
        ("instance_norm", lambda p, s, at: s.instance_norm(
            p.to_tensor(IMG), param_attr=a(at, "g"), bias_attr=a(at, "b"))),
        ("data_norm", lambda p, s, at: s.data_norm(p.to_tensor(X),
                                                   name="dn")),
        ("prelu_all", lambda p, s, at: s.prelu(p.to_tensor(IMG), "all",
                                               param_attr=a(at, "a"))),
        ("prelu_channel", lambda p, s, at: s.prelu(
            p.to_tensor(IMG), "channel", param_attr=a(at, "a"))),
        ("prelu_element", lambda p, s, at: s.prelu(
            p.to_tensor(X), "element", param_attr=a(at, "a"))),
        ("row_conv", lambda p, s, at: s.row_conv(
            p.to_tensor(SEQ), 2, param_attr=a(at, "w"), act="tanh")),
        ("bilinear_tensor_product", lambda p, s, at:
         s.bilinear_tensor_product(p.to_tensor(X), p.to_tensor(Y), 7,
                                   param_attr=a(at, "w"),
                                   bias_attr=a(at, "b"))),
        ("deform_conv2d", lambda p, s, at: s.deform_conv2d(
            p.to_tensor(IMG), p.to_tensor(np.full((2, 18, 6, 6), 0.3,
                                                  np.float32)),
            p.to_tensor(np.full((2, 9, 6, 6), 0.5, np.float32)), 4, 3,
            padding=1, weight_attr=a(at, "w"), bias_attr=a(at, "b"))),
    ]


BUILDERS = _builders()


@pytest.mark.parametrize("case", BUILDERS, ids=[b[0] for b in BUILDERS])
def test_builder_matches_jax(case):
    name, fn = case
    with jst.scope_guard(jst.Scope()), tst.scope_guard(tst.Scope()):
        # the first JAX call creates the parameters; its scope then goes
        # over, and the second JAX call and the port's call start from it
        fn(pt, jst.nn, pt.ParamAttr)
        scope = jst.global_scope()
        names = scope.local_var_names()
        load_jax_scope({n: np.asarray(scope.find_var(n).numpy())
                        for n in names},
                       buffers={n for n in names if not isinstance(
                           scope.find_var(n), pt.Parameter)})
        jout = fn(pt, jst.nn, pt.ParamAttr)
        tout = fn(paddle, tst.nn, paddle.ParamAttr)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout.numpy()),
                                   rtol=1e-5, atol=1e-6)
        # a train-mode batch_norm has written its moving statistics
        for n in names:
            jv = np.asarray(scope.find_var(n).numpy())
            np.testing.assert_allclose(
                tst.global_scope().find_var(n).numpy(), jv, rtol=1e-5,
                atol=1e-6, err_msg=n)
        if tout.value.is_floating_point() and name != "data_norm":
            w = R.standard_normal(tout.shape).astype(np.float32)
            (jout * pt.to_tensor(w)).sum().backward()
            (tout * paddle.to_tensor(w)).sum().backward()
            for n in names:
                jp = scope.find_var(n)
                if getattr(jp, "grad", None) is None:
                    continue
                jg = np.asarray(jp.grad.numpy())
                tg = tst.global_scope().find_var(n).grad.numpy()
                np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-6,
                                           err_msg=n)


def test_named_parameters_are_reused_and_unnamed_drawn_anew():
    x = paddle.to_tensor(np.ones((2, 4), np.float32))
    with tst.scope_guard(tst.Scope()):
        y1 = tst.nn.fc(x, 3, weight_attr=paddle.ParamAttr(name="shared"),
                       bias_attr=False)
        y2 = tst.nn.fc(x, 3, weight_attr=paddle.ParamAttr(name="shared"),
                       bias_attr=False)
        np.testing.assert_array_equal(y1.numpy(), y2.numpy())
        assert tst.global_scope().local_var_names() == ["shared"]
        z1 = tst.nn.fc(x, 3, bias_attr=False)
        z2 = tst.nn.fc(x, 3, bias_attr=False)
        assert not np.array_equal(z1.numpy(), z2.numpy())
        assert tst.global_scope().local_var_names() == ["shared"]


def test_spectral_norm_matches_jax_and_scales_to_unit_sigma():
    w = R.standard_normal((6, 4)).astype(np.float32)
    j = jst.nn.spectral_norm(pt.to_tensor(w), power_iters=50)
    t = tst.nn.spectral_norm(paddle.to_tensor(w), power_iters=50)
    np.testing.assert_allclose(t.numpy(), np.asarray(j.numpy()), rtol=1e-5)
    assert np.linalg.svd(t.numpy(), compute_uv=False)[0] == \
        pytest.approx(1.0, abs=1e-3)


def test_multi_box_head_matches_jax():
    feats = [R.standard_normal((1, 8, s, s)).astype(np.float32)
             for s in (4, 2)]
    image = np.zeros((1, 3, 32, 32), np.float32)

    def head(p, s):
        return s.multi_box_head([p.to_tensor(f) for f in feats],
                                p.to_tensor(image), base_size=32,
                                num_classes=3, aspect_ratios=[[2.0], [2.0]],
                                min_ratio=20, max_ratio=90)
    with jst.scope_guard(jst.Scope()), tst.scope_guard(tst.Scope()):
        j = head(pt, jst.nn)
        t = head(paddle, tst.nn)
    for k in (0, 1):
        assert tuple(t[k].shape) == tuple(j[k].shape)
    for k in (2, 3):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k].numpy()))


def test_reexports_are_the_ops():
    from paddle_tpu_torch import dispatch
    from paddle_tpu_torch.ops import control_flow
    for n in ("cond", "case", "switch_case", "while_loop"):
        assert getattr(tst.nn, n) is getattr(control_flow, n)
    for n in ("crf_decoding", "sequence_pool", "sequence_unpad",
              "sequence_softmax"):
        assert getattr(tst.nn, n) is dispatch.wrapped_ops[n]
    sm = tst.nn.sequence_softmax(paddle.to_tensor(np.ones((2, 3, 1),
                                                          np.float32)),
                                 paddle.to_tensor(np.array([2, 3])))
    np.testing.assert_allclose(sm.numpy()[0, :, 0], [0.5, 0.5, 0.0])
    assert tst.nn.py_func is tst.py_func
    with pytest.raises(AttributeError):
        tst.nn.no_such_builder
    assert set(jst.nn.__all__) <= set(tst.nn.__all__)


def test_multi_box_head_name_keeps_its_parameters():
    """With ``name`` the head's convolutions live in the scope under
    ``{name}.loc{i}.w`` / ``.b`` and ``{name}.conf{i}.w`` / ``.b``, so a
    second call reuses them (the JAX function ignores ``name`` and draws
    anew, as the port does without it)."""
    feats = [paddle.to_tensor(R.standard_normal((1, 8, s, s)).astype(
        np.float32)) for s in (4, 2)]
    image = paddle.to_tensor(np.zeros((1, 3, 32, 32), np.float32))

    def head(**kw):
        return tst.nn.multi_box_head(feats, image, base_size=32,
                                     num_classes=3,
                                     aspect_ratios=[[2.0], [2.0]],
                                     min_ratio=20, max_ratio=90, **kw)
    with tst.scope_guard(tst.Scope()):
        a, b = head(name="mbox"), head(name="mbox")
        np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
        np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())
        assert sorted(tst.global_scope().local_var_names()) == sorted(
            f"mbox.{k}{i}.{p}" for k in ("loc", "conf") for i in (0, 1)
            for p in ("w", "b"))
        c = head()
        assert not np.array_equal(a[0].numpy(), c[0].numpy())
