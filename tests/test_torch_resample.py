"""The port's resampling and ``nn/common.py`` functionals and layers
against the JAX package's, on the CPU.

- ``interpolate`` in every mode, both ``align_mode``s, up and down, in
  1-D, 2-D and 3-D, channels first and last: JAX's nearest floor map,
  its asymmetric ``align_mode=1`` lerp, and ``jax.image.resize`` for
  the rest (half-pixel, antialiased when it downsamples, Keys cubic,
  ``"area"`` linear). ``align_corners=True`` gives JAX's result, which
  ignores it; ``F.interpolate``'s own bilinear downsampling is shown to
  differ. Gradients of the linear and cubic modes.
- ``grid_sample`` (bilinear with zero and edge padding, nearest, both
  ``align_corners``; a grid reaching past every border) and
  ``affine_grid``; ``unfold`` / ``fold``; ``pad`` / ``pad3d`` /
  ``zeropad2d`` in every mode; ``pixel_shuffle`` / ``pixel_unshuffle``,
  ``temporal_shift``, ``channel_shuffle``, ``sequence_mask``,
  ``one_hot``, ``label_smooth``, ``linear`` and ``bilinear``.
- The layers of ``nn/common.py`` (the pads, the upsamplers,
  ``PixelShuffle``, ``Bilinear`` on the JAX layer's weights,
  ``CosineSimilarity``, ``Unfold``, ``Fold``, ``PairwiseDistance``)
  against the JAX layers.

Tolerances, stated: outputs within 1e-5 absolute and relative, and
gradients within 1e-5 relative in L2 (``test_torch_conv.parity``);
exact gathers (nearest, pads, shuffles, masks) bitwise.
"""

import _torch_threads  # noqa: F401

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as TF

import paddle_tpu as pt
from paddle_tpu.nn import common as jcommon
from paddle_tpu.ops import nn_functional as jnf
from paddle_tpu.tensor import Tensor

from paddle_tpu_torch.nn import common as tcommon
from paddle_tpu_torch.nn.layer import load_jax_state
from paddle_tpu_torch.ops import nn_functional as tnf
from test_torch_conv import TOL, parity
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


def _f(shape, seed, lo=-2.0, hi=2.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _exact(jfn, tfn, *arrays):
    want = np.asarray(jfn(*(jnp.asarray(a) for a in arrays)))
    got = tfn(*(torch.from_numpy(np.asarray(a)) for a in arrays))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


# -- interpolate ---------------------------------------------------------------

# (mode, input shape, data_format, out size (up), out size (down))
INTERP = [
    ("nearest", (2, 3, 9), "NCW", 14, 5),
    ("nearest", (2, 3, 9, 11), "NCHW", (14, 17), (4, 6)),
    ("nearest", (1, 9, 11, 2), "NHWC", (13, 20), (5, 4)),
    ("nearest", (1, 2, 5, 6, 7), "NCDHW", (8, 9, 11), (3, 4, 2)),
    ("linear", (2, 3, 9), "NCW", 14, 4),
    ("linear", (2, 9, 3), "NWC", 17, 5),
    ("bilinear", (2, 3, 9, 11), "NCHW", (14, 17), (4, 6)),
    ("bilinear", (1, 9, 11, 2), "NHWC", (13, 20), (5, 4)),
    ("trilinear", (1, 2, 5, 6, 7), "NCDHW", (8, 9, 11), (3, 4, 2)),
    ("trilinear", (1, 5, 6, 7, 2), "NDHWC", (7, 9, 10), (2, 3, 3)),
    ("bicubic", (2, 3, 9, 11), "NCHW", (14, 17), (4, 6)),
    ("area", (2, 3, 12, 10), "NCHW", (15, 13), (3, 4)),
]


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("way", ["up", "down"])
@pytest.mark.parametrize("case", range(len(INTERP)))
def test_interpolate_matches_jax(case, way, align_corners):
    mode, shape, fmt, up, down = INTERP[case]
    size = up if way == "up" else down
    x = _f(shape, case)
    kw = dict(size=size, mode=mode, align_corners=align_corners,
              data_format=fmt)
    parity(lambda x: jnf.interpolate(x, **kw),
           lambda x: tnf.interpolate(x, **kw), [x],
           grads=mode != "nearest")


@pytest.mark.parametrize("shape,fmt,size", [
    ((2, 3, 9), "NCW", 14), ((2, 3, 9), "NCW", 4),
    ((2, 3, 9, 11), "NCHW", (14, 5)), ((1, 9, 11, 2), "NHWC", (4, 20)),
    ((1, 2, 5, 6, 7), "NCDHW", (8, 3, 11))])
def test_interpolate_align_mode_1_matches_jax(shape, fmt, size):
    mode = {3: "linear", 4: "bilinear", 5: "trilinear"}[len(shape)]
    kw = dict(size=size, mode=mode, align_mode=1, data_format=fmt)
    parity(lambda x: jnf.interpolate(x, **kw),
           lambda x: tnf.interpolate(x, **kw), [_f(shape, 3)])


def test_interpolate_scale_factor_upsample_and_uint8():
    x = _f((2, 3, 8, 10), 4)
    for kw in (dict(scale_factor=(2.5, 2.5), mode="bilinear"),
               dict(scale_factor=(0.5, 1.5), mode="nearest"),
               dict(scale_factor=2, mode="linear", data_format="NCW"),
               dict(scale_factor=(0.4, 0.4), mode="bicubic")):
        arr = x[:, :, 0] if kw.get("data_format") == "NCW" else x
        parity(lambda x: jnf.upsample(x, **kw),
               lambda x: tnf.upsample(x, **kw), [arr])
    # a float scale_factor is not a tuple in either package
    with pytest.raises(TypeError):
        jnf.interpolate(jnp.asarray(x), scale_factor=0.5, mode="bilinear")
    with pytest.raises(TypeError):
        tnf.interpolate(torch.from_numpy(x), scale_factor=0.5,
                        mode="bilinear")
    img = np.random.default_rng(5).integers(0, 256, (1, 3, 20, 30),
                                            dtype=np.uint8)
    want = jnf.interpolate(jnp.asarray(img), (7, 11), mode="bilinear")
    got = tnf.interpolate(torch.from_numpy(img), (7, 11), mode="bilinear")
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)


@pytest.mark.parametrize("method", ["linear", "cubic"])
@pytest.mark.parametrize("shape,out", [
    ((37, 53, 3), (16, 20, 3)), ((37, 53, 3), (80, 90, 3)),
    ((3, 30, 40), (3, 56, 24)), ((9,), (4,)), ((2, 9, 10), (2, 5, 17))])
def test_resize_host_matches_jax_image_resize(shape, out, method):
    """The transforms' numpy resize (a banded sum over each column's
    nonzero taps) against ``jax.image.resize``, uint8 in, float32 out,
    within 1e-5 of the values' 255 scale; the torch ``resize`` on the
    same input agrees with it as closely."""
    import jax
    img = np.random.default_rng(7).integers(0, 256, shape, dtype=np.uint8)
    want = np.asarray(jax.image.resize(jnp.asarray(img), out, method))
    got = tnf.resize_host(img, out, method)
    assert got.dtype == np.float32 and got.shape == out
    np.testing.assert_allclose(got, want, atol=255e-5, rtol=0)
    np.testing.assert_allclose(
        got, tnf.resize(torch.from_numpy(img), out, method).numpy(),
        atol=255e-5, rtol=0)


def test_interpolate_is_not_torch_bilinear_when_downsampling():
    """JAX antialiases: ``F.interpolate``'s default would be off by more
    than the limit, and its antialiased 4-D form agrees."""
    x = _f((1, 3, 37, 53), 6, 0, 10)
    got = tnf.interpolate(torch.from_numpy(x), (16, 20), mode="bilinear")
    plain = TF.interpolate(torch.from_numpy(x), (16, 20), mode="bilinear",
                           align_corners=False)
    anti = TF.interpolate(torch.from_numpy(x), (16, 20), mode="bilinear",
                          align_corners=False, antialias=True)
    assert float((got - plain).abs().max()) > 0.1
    np.testing.assert_allclose(got.numpy(), anti.numpy(), atol=1e-4)


# -- grid_sample, affine_grid ------------------------------------------------

@pytest.mark.parametrize("mode,padding", [("bilinear", "zeros"),
                                          ("bilinear", "border"),
                                          ("nearest", "zeros")])
@pytest.mark.parametrize("align_corners", [True, False])
def test_grid_sample_matches_jax(mode, padding, align_corners):
    x = _f((2, 3, 7, 9), 7)
    grid = _f((2, 5, 6, 2), 8, -1.3, 1.3)      # past every border
    grid[0, 0, 0] = (-1.0, -1.0)
    grid[1, 4, 5] = (1.0, 1.0)
    kw = dict(mode=mode, padding_mode=padding, align_corners=align_corners)
    parity(lambda x, g: jnf.grid_sample(x, g, **kw),
           lambda x, g: tnf.grid_sample(x, g, **kw), [x, grid],
           grads=mode == "bilinear")


@pytest.mark.parametrize("align_corners", [True, False])
def test_affine_grid_matches_jax(align_corners):
    theta = _f((3, 2, 3), 9)
    parity(lambda t: jnf.affine_grid(t, (3, 4, 5, 7), align_corners),
           lambda t: tnf.affine_grid(t, (3, 4, 5, 7), align_corners),
           [theta])


# -- unfold, fold, pads ------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(kernel_sizes=3), dict(kernel_sizes=(2, 3), strides=2, paddings=1),
    dict(kernel_sizes=3, strides=(1, 2), paddings=[1, 0, 2, 1],
         dilations=2)])
def test_unfold_and_fold_match_jax(kw):
    x = _f((2, 3, 9, 10), 10)
    parity(lambda x: jnf.unfold(x, **kw), lambda x: tnf.unfold(x, **kw),
           [x])
    cols = np.asarray(jnf.unfold(jnp.asarray(x), **kw))
    parity(lambda c: jnf.fold(c, (9, 10), **kw),
           lambda c: tnf.fold(c, (9, 10), **kw), [cols])


@pytest.mark.parametrize("mode", ["constant", "reflect", "replicate",
                                  "circular"])
@pytest.mark.parametrize("fmt", ["NCDHW", "NDHWC"])
def test_pad3d_matches_jax(mode, fmt):
    x = _f((2, 3, 4, 5, 6), 11)
    pads = [1, 2, 0, 3, 2, 1]
    parity(lambda x: jnf.pad3d(x, pads, mode, 0.5, fmt),
           lambda x: tnf.pad3d(x, pads, mode, 0.5, fmt), [x])


@pytest.mark.parametrize("mode", ["constant", "reflect", "replicate",
                                  "circular"])
def test_pad_every_dim_and_spatial_match_jax(mode):
    from paddle_tpu.ops import manipulation as jman
    x = _f((2, 3, 5, 6), 12)
    for pads, fmt in (([0, 0, 1, 0, 2, 1, 3, 4], "NCHW"),
                      ([1, 2, 2, 1], "NCHW"), ([2, 1, 0, 3], "NHWC"),
                      ([7, 8], "NCHW")):
        if mode == "circular" and max(pads) > 5:
            continue
        parity(lambda x: jman.pad(x, pads, mode, 0.25, fmt),
               lambda x: tnf.pad(x, pads, mode, 0.25, fmt), [x])
    _exact(lambda x: jnf.zeropad2d(x, [1, 0, 2, 3]),
           lambda x: tnf.zeropad2d(x, [1, 0, 2, 3]), x)


# -- shuffles, masks, products -------------------------------------------------

def test_shuffles_and_masks_match_jax():
    x = _f((4, 8, 6, 6), 13)
    for fmt, arr in (("NCHW", x), ("NHWC", x.transpose(0, 2, 3, 1))):
        _exact(lambda a: jnf.pixel_shuffle(a, 2, fmt),
               lambda a: tnf.pixel_shuffle(a, 2, fmt), arr)
        _exact(lambda a: jnf.pixel_unshuffle(a, 3, fmt),
               lambda a: tnf.pixel_unshuffle(a, 3, fmt), arr)
        _exact(lambda a: jnf.channel_shuffle(a, 4, fmt),
               lambda a: tnf.channel_shuffle(a, 4, fmt), arr)
        _exact(lambda a: jnf.temporal_shift(a, 2, 0.25, fmt),
               lambda a: tnf.temporal_shift(a, 2, 0.25, fmt), arr)
    lengths = np.array([[0, 3], [7, 5]])
    for dtype in ("int64", "float32", "bool"):
        _exact(lambda a: jnf.sequence_mask(a, 6, dtype),
               lambda a: tnf.sequence_mask(a, 6, dtype), lengths)
    with pytest.raises(ValueError):
        tnf.sequence_mask(torch.tensor([2]))
    _exact(lambda a: jnf.one_hot(a, 5), lambda a: tnf.one_hot(a, 5),
           np.array([[0, 4, 7], [-1, 2, 2]]))


def test_label_smooth_linear_and_bilinear_match_jax():
    lab = np.eye(5, dtype=np.float32)[[0, 3, 4]]
    parity(lambda a: jnf.label_smooth(a), lambda a: tnf.label_smooth(a),
           [lab])
    prior = np.full((1, 5), 0.2, np.float32)
    parity(lambda a, p: jnf.label_smooth(a, p, 0.3),
           lambda a, p: tnf.label_smooth(a, p, 0.3), [lab, prior])
    parity(jnf.linear, tnf.linear, [_f((3, 4, 6), 14), _f((6, 5), 15),
                                    _f((5,), 16)])
    parity(jnf.bilinear, tnf.bilinear, [_f((4, 3), 17), _f((4, 5), 18),
                                        _f((2, 3, 5), 19), _f((2,), 20)])


# -- nn/common.py layers --------------------------------------------------------

def _layer_pair(name, *args, **kw):
    return getattr(jcommon, name)(*args, **kw), \
        getattr(tcommon, name)(*args, **kw)


LAYER_CASES = [
    ("Pad1D", (2,), dict(mode="reflect"), [(2, 3, 7)]),
    ("Pad1D", ([1, 3],), dict(value=1.5, data_format="NLC"), [(2, 7, 3)]),
    ("Pad2D", ([1, 0, 2, 1],), dict(mode="replicate"), [(2, 3, 5, 6)]),
    ("Pad2D", (1,), dict(mode="circular", data_format="NHWC"),
     [(2, 5, 6, 3)]),
    ("Pad3D", (1,), dict(mode="reflect"), [(1, 2, 4, 5, 6)]),
    ("ZeroPad2D", ([0, 2, 1, 1],), {}, [(2, 3, 5, 6)]),
    ("Upsample", (), dict(size=(7, 9), mode="bilinear"), [(2, 3, 5, 6)]),
    ("Upsample", (), dict(scale_factor=(0.5, 0.5), mode="bicubic"),
     [(2, 3, 10, 12)]),
    ("UpsamplingNearest2D", (), dict(scale_factor=2), [(2, 3, 5, 6)]),
    ("UpsamplingBilinear2D", (), dict(size=(3, 4)), [(2, 3, 5, 6)]),
    ("PixelShuffle", (2,), {}, [(2, 8, 3, 4)]),
    ("CosineSimilarity", (), dict(axis=2), [(3, 4, 5), (3, 4, 5)]),
    ("Unfold", ((2, 3),), dict(strides=2, paddings=1), [(2, 3, 7, 8)]),
    ("Fold", ((6, 7), 3), dict(paddings=1), [(2, 18, 42)]),
    ("PairwiseDistance", (), {}, [(4, 6), (4, 6)]),
    ("PairwiseDistance", (), dict(p=1.0, keepdim=True), [(4, 6), (4, 6)]),
]


@pytest.mark.parametrize("case", range(len(LAYER_CASES)))
def test_common_layers_match_jax(case):
    name, args, kw, shapes = LAYER_CASES[case]
    jl, tl = _layer_pair(name, *args, **kw)
    ins = [_f(s, 21 + i) for i, s in enumerate(shapes)]
    want = np.asarray(jl(*(Tensor(jnp.asarray(a)) for a in ins)).value)
    got = tl(*(torch.from_numpy(a) for a in ins))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_bilinear_layer_on_jax_weights():
    pt.seed(0)
    jl = jcommon.Bilinear(3, 5, 2)
    tl = tcommon.Bilinear(3, 5, 2, device="cpu")
    assert {k: tuple(v.shape) for k, v in tl.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in jax_state(jl).items()}
    load_jax_state(tl, jax_state(jl))
    a, b = _f((4, 3), 30), _f((4, 5), 31)
    want = np.asarray(jl(Tensor(jnp.asarray(a)), Tensor(jnp.asarray(b)))
                      .value)
    got = tl(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL,
                               atol=TOL)
    fresh = tcommon.Bilinear(3, 5, 2, bias_attr=False, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    assert fresh.bias is None
    bound = float(np.sqrt(6.0 / (5 + 3 * 5)))   # xavier fans of [2, 3, 5]
    assert float(fresh.weight.detach().abs().max()) <= bound
