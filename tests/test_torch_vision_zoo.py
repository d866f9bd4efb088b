"""The port's vision zoo against the JAX package's, on the CPU: LeNet,
MobileNet v1 and v2 (``scale=0.25``), VGG11 with batch norm, NCHW and
NHWC, on the JAX models' weights (``load_jax_state``) with seeded BN
running statistics (mean N(0, 0.3), variance U(0.5, 2), as
``chip_smoke.py``'s ResNet phase seeds them); the eval logits, the JAX
side through its jitted ``EvalStep``; and
``inference/fusion.py`` ``fuse_conv_bn`` over MobileNet v2 and VGG11-BN
(the ``_ConvBNRelu`` ``conv`` / ``bn`` children, the projection pairs
in ``Sequential``, the depthwise convolutions): the fold count equal to
the JAX pass's and the folded logits.

VGG's classifier (a 25088 x 4096 linear) is left out here
(``num_classes=0``), as in the JAX package's own fusion test; its full
width runs on the card (``chip_smoke.py`` ``phase_vision_zoo``). ResNet
has its own files (``test_torch_resnet.py``, ``test_torch_vision_train.
py``).

Tolerances, stated: fp32, sums in other orders through up to 53
layers: logits within 1e-4 relative in L2 (as ``test_torch_resnet.py``);
the folded model's logits within 1e-4 relative of the JAX folded
model's and within the JAX fusion test's 5e-4 of the unfolded port
model's. (Train-mode batch norm is held in ``test_torch_resnet.py`` and
``test_torch_vision_train.py``.)
"""

import _torch_threads  # noqa: F401

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.inference.fusion import fuse_conv_bn as jfuse
from paddle_tpu.jit import EvalStep
from paddle_tpu.vision import models as jmodels

from paddle_tpu_torch.inference.fusion import fuse_conv_bn
from paddle_tpu_torch.nn.layer import load_jax_state
from paddle_tpu_torch.vision import models as tmodels
from test_torch_transformer import jax_state

MODEL_REL_TOL = 1e-4
FOLD_VS_UNFOLDED = 5e-4


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


# name -> (constructor name, kwargs, input shape)
ZOO = {
    "lenet": ("LeNet", {}, (2, 1, 28, 28)),
    "mobilenet_v1": ("mobilenet_v1", dict(scale=0.25, num_classes=10),
                     (2, 3, 64, 64)),
    "mobilenet_v2": ("mobilenet_v2", dict(scale=0.25, num_classes=10),
                     (2, 3, 64, 64)),
    "vgg11_bn": ("vgg11", dict(batch_norm=True, num_classes=0,
                               with_pool=False), (2, 3, 32, 32)),
    "vgg11_bn_pool": ("vgg11", dict(batch_norm=True, num_classes=0),
                      (2, 3, 32, 32)),
}


def _pair(name, fmt):
    make, kw, shape = ZOO[name]
    if fmt == "NHWC":
        kw = dict(kw, data_format="NHWC")
    pt.seed(0)
    j = getattr(jmodels, make)(**kw)
    t = getattr(tmodels, make)(device="cpu", **kw)
    want = {k: tuple(v.shape) for k, v in j.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in t.state_dict().items()} == want
    state = jax_state(j)
    rng = np.random.default_rng(0)
    for k in state:
        if k.endswith("._mean"):
            state[k] = rng.normal(0, 0.3, state[k].shape).astype(np.float32)
        elif k.endswith("._variance"):
            state[k] = rng.uniform(0.5, 2.0, state[k].shape).astype(
                np.float32)
    j.set_state_dict(state)
    load_jax_state(t, state)
    j.eval()
    t.eval()
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    return j, t, x


def _run(j, t, x):
    with torch.no_grad():
        got = t(torch.from_numpy(x)).numpy()
    return np.asarray(EvalStep(j)(jnp.asarray(x))), got


def _rel(got, want):
    return float(np.linalg.norm(got.astype(np.float64) - want) /
                 np.linalg.norm(want))


# MobileNet v2 and VGG11-BN take their logits test in the fold test
CASES = [("lenet", "NCHW")] + [(n, f) for n in ("mobilenet_v1",
                                                "vgg11_bn_pool")
                               for f in ("NCHW", "NHWC")]


@pytest.mark.parametrize("name,fmt", CASES)
def test_zoo_logits_match_jax(name, fmt):
    j, t, x = _pair(name, fmt)
    want, got = _run(j, t, x)
    assert got.shape == want.shape
    assert _rel(got, want) <= MODEL_REL_TOL


@pytest.mark.parametrize("name", ["mobilenet_v2", "vgg11_bn"])
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_fuse_conv_bn_counts_and_logits_match_jax(name, fmt):
    j, t, x = _pair(name, fmt)
    want, before = _run(j, t, x)
    assert _rel(before, want) <= MODEL_REL_TOL
    n_j, n_t = jfuse(j), fuse_conv_bn(t)
    assert n_t == n_j > 0
    # every conv of MobileNet v2 feeds a BN, depthwise ones included: 52;
    # VGG11-BN has 8
    assert n_t == {"mobilenet_v2": 52, "vgg11_bn": 8}[name]
    assert not any(type(m).__name__ == "BatchNorm2D" for m in t.modules())
    want, got = _run(j, t, x)
    assert _rel(got, want) <= MODEL_REL_TOL
    np.testing.assert_allclose(got, before, rtol=FOLD_VS_UNFOLDED,
                               atol=FOLD_VS_UNFOLDED)


def test_zoo_exports_match_jax():
    import paddle_tpu.vision.models as jm
    names = {n for n in dir(jm) if not n.startswith("_")
             and callable(getattr(jm, n))}
    assert names <= set(dir(tmodels))


def test_nchw_and_nhwc_agree_on_one_model():
    """The same weights in both layouts (the convolution weights are
    ``[out, in, kh, kw]`` in both): the NHWC model's public input and
    output stay NCHW."""
    pt.seed(0)
    a = tmodels.mobilenet_v1(scale=0.25, num_classes=10, device="cpu")
    b = tmodels.mobilenet_v1(scale=0.25, num_classes=10, data_format="NHWC",
                             device="cpu")
    b.load_state_dict(a.state_dict())
    a.eval()
    b.eval()
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        np.testing.assert_allclose(b(x).numpy(), a(x).numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_fold_counts_the_chip_check_pins():
    """``chip_smoke.py`` ``ZOO_MODELS`` pins each full-width model's fold
    count; the structures give them here (VGG without its classifier,
    which holds no convolution)."""
    from test_torch_attention_fwd import _chip_smoke
    pinned = {m[0]: m[4] for m in _chip_smoke().ZOO_MODELS}
    built = {
        "lenet": tmodels.LeNet(device="cpu"),
        "mobilenet_v1": tmodels.mobilenet_v1(device="cpu"),
        "mobilenet_v2": tmodels.mobilenet_v2(device="cpu"),
        "vgg16": tmodels.vgg16(num_classes=0, device="cpu"),
        "vgg16_bn": tmodels.vgg16(batch_norm=True, num_classes=0,
                                  device="cpu"),
    }
    counts = {}
    for name, m in built.items():
        m.eval()
        counts[name] = fuse_conv_bn(m)
    assert counts == pinned
