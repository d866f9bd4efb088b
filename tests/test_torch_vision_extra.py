"""The port's ``ops/vision_extra.py``, ``ops/detection.py`` ``yolo_box``,
``vision/ops.py`` and ``nn/conv.py`` ``DeformConv2D`` against the JAX
package's, on the CPU.

- Every function of ``vision_extra``: the layout and CTR ops, the
  sequence convolutions, ``spp``, ``correlation``, the RoI pools (with
  ``rois_num`` spreading RoIs over images), ``deformable_conv`` (v1 and
  v2, groups, deformable groups, stride / padding / dilation; offsets
  that push samples past every border), ``yolov3_loss``, each forward
  and the vjp of a seeded cotangent; ``shuffle_batch`` by its
  properties (torch's and JAX's streams differ); ``read_file`` and
  ``decode_jpeg`` over a PNG the test writes.
- ``deformable_conv`` at the border by hand: a sample half a pixel
  outside the image keeps only its inside neighbours' weights, which is
  not ``F.grid_sample``'s convention; a float64 ``gradcheck`` of its
  gradient away from integer sample positions, and one of
  ``yolov3_loss``.
- ``DeformConv2D`` on the JAX layer's weights; ``yolo_box`` with and
  without ``iou_aware``; the ``vision.ops`` wrappers in the reference's
  argument order.

Tolerances, stated: outputs within 1e-5 absolute and relative, and
gradients within 1e-5 relative in L2 (``test_torch_conv.parity``),
``yolov3_loss`` (sums over 100+ terms) within 1e-4; exact gathers
bitwise.
"""

import _torch_threads  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.nn import conv as jconv
from paddle_tpu.ops import detection as jdet
from paddle_tpu.ops import vision_extra as jve
from paddle_tpu.tensor import Tensor
from paddle_tpu.vision import ops as jvops

from paddle_tpu_torch.nn import conv as tconv
from paddle_tpu_torch.nn.layer import load_jax_state
from paddle_tpu_torch.ops import detection as tdet
from paddle_tpu_torch.ops import vision_extra as tve
from paddle_tpu_torch.vision import ops as tvops
from test_torch_conv import TOL, parity
from test_torch_transformer import jax_state

YOLO_TOL = 1e-4


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


def _both(arr):
    return jnp.asarray(arr), torch.from_numpy(np.asarray(arr))


# -- the plain ops ---------------------------------------------------------------

# case -> (function name, float arrays, constants after them, keywords)
OPS = {
    "affine_channel": ("affine_channel", [_f((2, 3, 4, 5), 1), _f((3,), 2),
                                          _f((3,), 3)], [], {}),
    "affine_channel_nhwc": ("affine_channel", [_f((2, 4, 5, 3), 1),
                                               _f((3,), 2), _f((3,), 3)],
                            [], {"data_format": "NHWC"}),
    "affine_channel_2d": ("affine_channel", [_f((4, 3), 1), _f((3,), 2),
                                             _f((3,), 3)], [], {}),
    "space_to_depth": ("space_to_depth", [_f((2, 3, 6, 4), 4)], [2], {}),
    "shuffle_channel": ("shuffle_channel", [_f((2, 6, 3, 3), 5)], [3], {}),
    "cvm": ("cvm", [_f((4, 6), 6, 0, 5)], [None], {}),
    "cvm_off": ("cvm", [_f((4, 6), 6, 0, 5)], [None], {"use_cvm": False}),
    "partial_concat": ("partial_concat", [], [], {}),
    "partial_sum": ("partial_sum", [], [], {}),
    "batch_fc": ("batch_fc", [_f((3, 4, 5), 7), _f((3, 5, 2), 8),
                              _f((3, 2), 9)], [], {}),
    "row_conv": ("row_conv", [_f((2, 7, 4), 10), _f((3, 4), 11)], [], {}),
    "conv_shift": ("conv_shift", [_f((3, 8), 12), _f((3, 5), 13)], [], {}),
    "im2sequence": ("im2sequence", [_f((2, 3, 6, 7), 14)], [(2, 3)],
                    {"strides": (2, 1), "paddings": (1, 0, 0, 2)}),
    "add_position_encoding": ("add_position_encoding", [_f((2, 5, 8), 15)],
                              [0.7, 1.3], {}),
    "add_position_encoding_odd": ("add_position_encoding",
                                  [_f((2, 5, 7), 15)], [], {}),
    "fsp": ("fsp", [_f((2, 3, 4, 5), 16), _f((2, 6, 4, 5), 17)], [], {}),
    "bilinear_tensor_product": ("bilinear_tensor_product",
                                [_f((4, 3), 18), _f((4, 5), 19),
                                 _f((2, 3, 5), 20), _f((2,), 21)], [], {}),
    "correlation": ("correlation", [_f((2, 3, 6, 7), 22),
                                    _f((2, 3, 6, 7), 23)], [2, 1, 2], {}),
    "correlation_strided": ("correlation", [_f((1, 2, 8, 8), 24),
                                            _f((1, 2, 8, 8), 25)],
                            [3, 1, 4], {"stride1": 2, "stride2": 2}),
    "spp_max": ("spp", [_f((2, 3, 8, 8), 26)], [3], {}),
    "spp_avg": ("spp", [_f((2, 3, 9, 7), 27)], [2], {"pooling_type": "avg"}),
}


@pytest.mark.parametrize("case", list(OPS))
def test_vision_extra_ops_match_jax(case):
    name, arrays, consts, kw = OPS[case]
    if name in ("partial_concat", "partial_sum"):
        xs = [_f((3, 6), 30 + i) for i in range(3)]
        for start, length in ((0, -1), (2, 3), (-4, 2)):
            parity(lambda *a: getattr(jve, name)(list(a), start, length),
                   lambda *a: getattr(tve, name)(list(a), start, length),
                   xs)
        return
    parity(jax.jit(lambda *a: getattr(jve, name)(*a, *consts, **kw)),
           lambda *a: getattr(tve, name)(*a, *consts, **kw), arrays)


def test_shuffle_batch_is_a_seeded_row_permutation():
    x = torch.from_numpy(_f((9, 4), 40))
    out, idx = tve.shuffle_batch(x, torch.Generator().manual_seed(3))
    assert sorted(idx.tolist()) == list(range(9))
    assert torch.equal(out, x[idx])
    again, _ = tve.shuffle_batch(x, torch.Generator().manual_seed(3))
    assert torch.equal(out, again)


# -- RoI pools -------------------------------------------------------------------

ROIS = np.array([[1.0, 2.0, 9.5, 7.0], [0.0, 0.0, 12.0, 10.0],
                 [3.2, 1.1, 5.7, 9.9], [6.0, 4.0, 6.5, 4.2]], np.float32)


@pytest.mark.parametrize("rois_num", [None, [1, 3], [3, 0]])
def test_psroi_pool_matches_jax(rois_num):
    n = 1 if rois_num is None else 2
    x = _f((n, 2 * 3 * 2, 10, 12), 41)
    rn_j = None if rois_num is None else jnp.asarray(rois_num)
    rn_t = None if rois_num is None else torch.tensor(rois_num)
    parity(jax.jit(lambda x, r: jve.psroi_pool(x, r, 2, 0.5, 3, 2, rn_j)),
           lambda x, r: tve.psroi_pool(x, r, 2, 0.5, 3, 2, rn_t),
           [x, ROIS * 2], grads=False)
    parity(jax.jit(lambda x: jve.psroi_pool(x, jnp.asarray(ROIS), 2, 1.0,
                                            3, 2, rn_j)),
           lambda x: tve.psroi_pool(x, torch.from_numpy(ROIS), 2, 1.0, 3, 2,
                                    rn_t), [x])


@pytest.mark.parametrize("rois_num", [None, [2, 2]])
def test_prroi_pool_matches_jax(rois_num):
    n = 1 if rois_num is None else 2
    x = _f((n, 3, 10, 12), 42)
    rn_j = None if rois_num is None else jnp.asarray(rois_num)
    rn_t = None if rois_num is None else torch.tensor(rois_num)
    rois = ROIS.copy()
    rois[1] = (-2.0, -1.5, 14.0, 11.0)            # past every border
    parity(jax.jit(lambda x, r: jve.prroi_pool(x, r, 1.0, 3, 2, rn_j,
                                               sampling=3)),
           lambda x, r: tve.prroi_pool(x, r, 1.0, 3, 2, rn_t, sampling=3),
           [x, rois])


# -- deformable conv -------------------------------------------------------------

DEFORM = [
    # x shape, weight shape, stride, padding, dilation, dg, groups, mask
    ((2, 4, 7, 8), (6, 4, 3, 3), 1, 1, 1, 1, 1, False),
    ((2, 4, 7, 8), (6, 4, 3, 3), 1, 1, 1, 2, 1, True),
    ((1, 4, 9, 9), (4, 2, 3, 2), 2, (1, 0), (2, 1), 2, 2, True),
    ((1, 2, 5, 6), (3, 2, 1, 1), 1, 0, 1, 1, 1, False),
]


def _deform_inputs(case, seed):
    xs, ws, s, p, d, dg, g, masked = DEFORM[case]
    n, c, h, w = xs
    kh, kw = ws[2:]
    s2, p2, d2 = (v if isinstance(v, tuple) else (v, v) for v in (s, p, d))
    oh = (h + 2 * p2[0] - d2[0] * (kh - 1) - 1) // s2[0] + 1
    ow = (w + 2 * p2[1] - d2[1] * (kw - 1) - 1) // s2[1] + 1
    x = _f(xs, seed)
    wgt = _f(ws, seed + 1, -0.5, 0.5)
    # offsets up to 3 pixels: samples land past every border
    off = _f((n, 2 * dg * kh * kw, oh, ow), seed + 2, -3.0, 3.0)
    mask = _f((n, dg * kh * kw, oh, ow), seed + 3, 0, 1) if masked else None
    bias = _f((ws[0],), seed + 4)
    return x, off, wgt, mask, bias, dict(stride=s, padding=p, dilation=d,
                                         deformable_groups=dg, groups=g)


@pytest.mark.parametrize("case", range(len(DEFORM)))
def test_deformable_conv_and_its_gradient_match_jax(case):
    x, off, wgt, mask, bias, kw = _deform_inputs(case, 50 + case)
    parity(jax.jit(lambda x, o, w, m, b: jve.deformable_conv(x, o, w, m, b,
                                                             **kw)),
           lambda x, o, w, m, b: tve.deformable_conv(x, o, w, m, b, **kw),
           [x, off, wgt, mask, bias])


def test_deformable_conv_border_by_hand():
    """One pixel image 2 x 2 of ones, a 1 x 1 kernel of weight 1: an
    offset of -0.5 in y puts the sample half a pixel above row 0. Its
    neighbours above are outside and give 0, so the output is 0.5 (the
    row-0 neighbours' weight), where ``F.grid_sample`` with border
    clamping would give 1."""
    x = torch.ones((1, 1, 2, 2), dtype=torch.float64)
    w = torch.ones((1, 1, 1, 1), dtype=torch.float64)
    off = torch.zeros((1, 2, 2, 2), dtype=torch.float64)
    off[0, 0, 0, 0] = -0.5                 # y of the output (0, 0)
    off[0, 1, 1, 1] = 0.25                 # x of the output (1, 1)
    off[0, 0, 0, 1] = -1.0                 # wholly above the image
    out = tve.deformable_conv(x, off, w)[0, 0]
    assert out.tolist() == [[0.5, 0.0], [1.0, 0.75]]
    want = np.asarray(jve.deformable_conv(*(jnp.asarray(t.numpy(),
                                                        jnp.float32)
                                            for t in (x, off, w))))
    np.testing.assert_allclose(out.numpy(), want[0, 0], atol=1e-7)


def test_deformable_conv_gradcheck():
    """float64, samples kept off integer positions (where ``floor``
    jumps), some of them outside the image."""
    g = torch.Generator().manual_seed(61)
    x = torch.randn((1, 2, 4, 4), generator=g, dtype=torch.float64)
    w = torch.randn((2, 2, 3, 3), generator=g, dtype=torch.float64)
    off = torch.floor(torch.rand((1, 18, 4, 4), generator=g,
                                 dtype=torch.float64) * 6 - 3) + 0.3
    mask = torch.rand((1, 9, 4, 4), generator=g, dtype=torch.float64)
    args = tuple(t.requires_grad_() for t in (x, off, w, mask))
    assert torch.autograd.gradcheck(
        lambda a, o, w, m: tve.deformable_conv(a, o, w, m, None, 1, 1),
        args, eps=1e-6, atol=1e-6)


def test_deform_conv2d_layer_on_jax_weights():
    pt.seed(0)
    jl = jconv.DeformConv2D(4, 6, 3, padding=1, deformable_groups=2)
    tl = tconv.DeformConv2D(4, 6, 3, padding=1, deformable_groups=2,
                            device="cpu")
    load_jax_state(tl, jax_state(jl))
    x = _f((2, 4, 6, 7), 70)
    off = _f((2, 2 * 2 * 9, 6, 7), 71, -2, 2)
    mask = _f((2, 2 * 9, 6, 7), 72, 0, 1)
    for m in (None, mask):
        jm = None if m is None else Tensor(jnp.asarray(m))
        tm = None if m is None else torch.from_numpy(m)
        want = jl(Tensor(jnp.asarray(x)), Tensor(jnp.asarray(off)), jm).value
        got = tl(torch.from_numpy(x), torch.from_numpy(off), tm)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL)
    # the vision.ops alias and functional in the reference's order
    assert tvops.DeformConv2D is tconv.DeformConv2D
    w = tl.weight.detach()
    got = tvops.deform_conv2d(torch.from_numpy(x), torch.from_numpy(off), w,
                              tl.bias.detach(), 1, 1, 1, 2, 1,
                              torch.from_numpy(mask))
    want = jvops.deform_conv2d(Tensor(jnp.asarray(x)),
                               Tensor(jnp.asarray(off)),
                               Tensor(jnp.asarray(w.numpy())),
                               Tensor(jnp.asarray(tl.bias.detach().numpy())),
                               1, 1, 1, 2, 1, Tensor(jnp.asarray(mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want.value),
                               rtol=TOL, atol=TOL)


# -- YOLO --------------------------------------------------------------------

ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45]


def _yolo_inputs(seed, a=3, cn=4, h=5, w=6):
    x = _f((2, a * (5 + cn), h, w), seed)
    gt_box = np.array([[[0.5, 0.5, 0.3, 0.4], [0.2, 0.3, 0.1, 0.2],
                        [0.91, 0.05, 0.2, 0.08]],
                       [[0.7, 0.2, 0.2, 0.1], [0.0, 0.0, 0.0, 0.0],
                        [0.33, 0.66, 0.5, 0.6]]], np.float32)
    gt_label = np.array([[1, 2, 3], [3, 0, 1]])
    score = _f((2, 3), seed + 1, 0.3, 1.0)
    return x, gt_box, gt_label, score


@pytest.mark.parametrize("mask,smooth,scored", [([0, 1, 2], True, False),
                                                ([2, 3, 4], False, True),
                                                ([1, 3], True, True)])
def test_yolov3_loss_and_its_gradient_match_jax(mask, smooth, scored):
    x, gt_box, gt_label, score = _yolo_inputs(80, a=len(mask))
    lj, lt = _both(gt_label)
    if not scored:
        parity(jax.jit(lambda x, b: jve.yolov3_loss(
                   x, b, lj, ANCHORS, mask, 4, 0.5, 32, None, smooth)),
               lambda x, b: tve.yolov3_loss(x, b, lt, ANCHORS, mask, 4, 0.5,
                                            32, None, smooth),
               [x, gt_box], tol=YOLO_TOL, grad_rel=YOLO_TOL)
        return
    parity(jax.jit(lambda x, b, s: jve.yolov3_loss(
               x, b, lj, ANCHORS, mask, 4, 0.3, 32, s, smooth)),
           lambda x, b, s: tve.yolov3_loss(x, b, lt, ANCHORS, mask, 4, 0.3,
                                           32, s, smooth),
           [x, gt_box, score], tol=YOLO_TOL, grad_rel=YOLO_TOL)


def test_yolov3_loss_gradcheck_and_yolo_loss_wrapper():
    x, gt_box, gt_label, score = _yolo_inputs(81, a=2, cn=2, h=2, w=3)
    x64 = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    b, lab = torch.tensor(gt_box, dtype=torch.float64), torch.tensor(
        gt_label)
    assert torch.autograd.gradcheck(
        lambda x: tve.yolov3_loss(x, b, lab, ANCHORS, [1, 3], 2, 0.5, 32),
        (x64,), eps=1e-6, atol=1e-6)
    got = tvops.yolo_loss(torch.from_numpy(x), torch.from_numpy(gt_box),
                          lab, ANCHORS, [1, 3], 2, 0.5, 32)
    want = jvops.yolo_loss(Tensor(jnp.asarray(x)),
                           Tensor(jnp.asarray(gt_box)),
                           Tensor(jnp.asarray(gt_label)), ANCHORS, [1, 3],
                           2, 0.5, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.value),
                               rtol=YOLO_TOL)


@pytest.mark.parametrize("iou_aware,clip", [(False, True), (True, True),
                                            (False, False)])
def test_yolo_box_matches_jax(iou_aware, clip):
    na, cn, h, w = 3, 4, 5, 6
    ch = na * (6 + cn) if iou_aware else na * (5 + cn)
    x = _f((2, ch, h, w), 90, -3, 3)
    img = np.array([[320, 416], [200, 180]])
    args = (ANCHORS[:6], cn, 0.4, 32, clip, 1.1, iou_aware, 0.4)
    want = jdet.yolo_box(jnp.asarray(x), jnp.asarray(img), *args)
    got = tdet.yolo_box(torch.from_numpy(x), torch.from_numpy(img), *args)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=1e-5,
                                   atol=1e-4)
    assert (got[0] == 0).all(-1).any()       # some boxes under conf_thresh
    vwant = jvops.yolo_box(Tensor(jnp.asarray(x)), Tensor(jnp.asarray(img)),
                           ANCHORS[:6], cn, 0.4, 32, clip, None, 1.1,
                           iou_aware, 0.4)
    vgot = tvops.yolo_box(torch.from_numpy(x), torch.from_numpy(img),
                          ANCHORS[:6], cn, 0.4, 32, clip, None, 1.1,
                          iou_aware, 0.4)
    for g, wnt in zip(vgot, vwant):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt.value),
                                   rtol=1e-5, atol=1e-4)


# -- files -----------------------------------------------------------------------

def test_read_file_and_decode_jpeg_over_a_png(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    rgb = np.random.default_rng(95).integers(0, 256, (7, 9, 3),
                                             dtype=np.uint8)
    path = str(tmp_path / "img.png")
    Image.fromarray(rgb).save(path)
    raw = tve.read_file(path)
    assert raw.dtype == torch.uint8
    np.testing.assert_array_equal(raw.numpy(),
                                  np.asarray(jve.read_file(path)))
    np.testing.assert_array_equal(tvops.read_file(path).numpy(),
                                  np.asarray(jvops.read_file(path).value))
    for mode in ("unchanged", "gray", "rgb"):
        got = tve.decode_jpeg(raw, mode)
        want = np.asarray(jve.decode_jpeg(jnp.asarray(raw.numpy()), mode))
        np.testing.assert_array_equal(got.numpy(), want)
        vgot = tvops.decode_jpeg(raw, mode)
        np.testing.assert_array_equal(vgot.numpy(), want)
    np.testing.assert_array_equal(tve.decode_jpeg(raw).numpy(),
                                  rgb.transpose(2, 0, 1))
