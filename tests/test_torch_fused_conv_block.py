"""The port's fused bottleneck (``paddle_tpu_torch/ops/kernels/
fused_conv_block.py``) against the JAX package's.

The plain version, which a CPU tensor takes and which chip_smoke.py
holds the CUDA kernel against on the card, is compared with the JAX
``fused_bottleneck_eval`` run through the Pallas interpreter (as
``tests/test_fused_conv_block.py`` runs it) on identical packed
parameters. Tolerances: fp32 1e-5 (both sides sum in f32 on the CPU, in
different orders); bf16 2e-2 absolute and relative (y1, y2 and the
output are rounded to bf16, and a sum that lands on the other side of a
rounding boundary moves by one bf16 ulp).

The CUDA kernel's decomposition is rehearsed here as well: the plain
emulation of its tiles (``fused_bottleneck_strip_emulation``) against
the plain version (1e-6) and the JAX kernel (chip_smoke.py's 1e-4), the
wrapper's padding of M and C, the layout constants its shared-memory
formula repeats, the configuration at ResNet-50's shapes and at the
blocks the first kernel could not place, and 3xTF32 products through
the whole chain (``tests/tf32_emulation.py``).
"""

import functools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.inference.fusion import fuse_conv_bn as jfuse_conv_bn
from paddle_tpu import nn as jnn
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import fused_conv_block as jfc
from paddle_tpu.vision.models import resnet50 as jresnet50
from paddle_tpu.vision.models.resnet import BottleneckBlock as JBlock

from paddle_tpu_torch.inference.fusion import fuse_conv_bn
from paddle_tpu_torch.nn.layer import load_jax_state
from paddle_tpu_torch.ops.kernels import fused_conv_block as fc
from paddle_tpu_torch.ops.nn_functional import plain_kernels
from paddle_tpu_torch.vision.models import resnet50
from paddle_tpu_torch.vision.models.resnet import BottleneckBlock
from tf32_emulation import tc_matmul

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
BF16_TOL = 2e-2
MODEL_REL_TOL = 1e-4   # whole-model logits, relative in L2


@pytest.fixture(autouse=True)
def _interpret_and_opt_in(monkeypatch):
    orig = jfc.pl.pallas_call
    monkeypatch.setattr(jfc.pl, "pallas_call",
                        functools.partial(orig, interpret=True))
    monkeypatch.setattr(jfc, "_FUSED_EVAL_ENABLED", True)
    monkeypatch.setattr(fc, "_FUSED_EVAL_ENABLED", True)
    yield


def _jax_block(inplanes=32, planes=8, data_format="NHWC", stride=1,
               downsample=None, seed=1):
    pt.seed(0)
    blk = JBlock(inplanes, planes, stride=stride, downsample=downsample,
                 data_format=data_format)
    blk.eval()
    # non-trivial BN stats so the fold matters
    rng = np.random.default_rng(seed)
    for bn in (blk.bn1, blk.bn2, blk.bn3):
        n = bn._num_features
        bn._mean.value = jnp.asarray(rng.normal(0, 0.3, n), jnp.float32)
        bn._variance.value = jnp.asarray(rng.uniform(0.5, 2.0, n),
                                         jnp.float32)
    return blk


def _jax_state(layer):
    return {k: np.asarray(v.value) for k, v in layer.state_dict().items()}


def _port_block(jblk, data_format="NHWC"):
    inplanes = jblk.conv1.weight.shape[1]
    planes = jblk.conv3.weight.shape[0] // 4
    blk = BottleneckBlock(inplanes, planes, data_format=data_format,
                          device="cpu")
    load_jax_state(blk, _jax_state(jblk))
    return blk.eval()


def _eager(blk, x):
    identity = x
    out = blk.relu(blk.bn1(blk.conv1(x)))
    out = blk.relu(blk.bn2(blk.conv2(out)))
    out = blk.bn3(blk.conv3(out))
    return blk.relu(out + identity)


def _to_torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(dtype)


def _delta_image():
    x = np.zeros((1, 4, 4, 32), np.float32)
    x[0, 1, 0, :] = 1.0   # left-edge pixel
    x[0, 2, 3, :] = -1.0  # right-edge pixel
    return x


SHAPES = {"6x5": (2, 6, 5, 32), "28x28": (1, 28, 28, 32), "delta": None}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_reference_matches_jax_kernel(shape, dtype):
    jblk = _jax_block()
    if dtype == "bfloat16":
        for conv in (jblk.conv1, jblk.conv2, jblk.conv3):
            conv.weight.value = conv.weight.value.astype(jnp.bfloat16)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    x = _delta_image() if shape == "delta" else \
        np.random.default_rng(2).standard_normal(SHAPES[shape]).astype(
            np.float32)
    jparams = jfc.pack_bottleneck(jblk)
    want = jfc.fused_bottleneck_eval(jnp.asarray(x, jd), *jparams)
    tparams = [_to_torch(p.astype(jnp.float32), td if p.dtype == jd
                         and p.shape[0] != 1 else torch.float32)
               for p in jparams]
    got = fc.fused_bottleneck_reference(_to_torch(x, td), *tparams)
    assert got.dtype == td and tuple(got.shape) == x.shape
    tol = TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fold_and_pack_match_jax(dtype):
    jblk = _jax_block()
    blk = _port_block(jblk)
    if dtype == "bfloat16":
        for jc, c in ((jblk.conv1, blk.conv1), (jblk.conv2, blk.conv2),
                      (jblk.conv3, blk.conv3)):
            jc.weight.value = jc.weight.value.astype(jnp.bfloat16)
            c.weight.data = c.weight.data.to(torch.bfloat16)
    want = jfc.pack_bottleneck(jblk)
    got = fc.pack_bottleneck(blk)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        assert g.is_contiguous()
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   rtol=TOL, atol=TOL)
    conv = np.random.default_rng(3).standard_normal((8, 4, 3, 3))
    stats = [np.random.default_rng(4 + i).uniform(0.5, 2.0, 8)
             for i in range(4)]
    jw, jb = jfc.fold_bn(jnp.asarray(conv, jnp.float32),
                         *[jnp.asarray(s, jnp.float32) for s in stats], 1e-5)
    tw, tb = fc.fold_bn(_to_torch(conv, torch.float32),
                        *[_to_torch(s, torch.float32) for s in stats], 1e-5)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=TOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=TOL)


def _gate_case(case):
    """(JAX block, port block, x_shape, data_format) of one gate case:
    those of ``test_block_forward_routes_fused_in_eval``, an NCHW block
    and a block whose BNs were folded away."""
    fmt = "NCHW" if case == "nchw" else "NHWC"
    if case == "stride2_downsample":
        from paddle_tpu_torch.nn.container import Sequential
        from paddle_tpu_torch.nn.conv import Conv2D
        from paddle_tpu_torch.nn.norm import BatchNorm2D
        pt.seed(0)
        jds = jnn.Sequential(
            jnn.Conv2D(32, 32, 1, stride=2, bias_attr=False,
                       data_format=fmt),
            jnn.BatchNorm2D(32, data_format=fmt))
        jblk = _jax_block(stride=2, downsample=jds)
        ds = Sequential(Conv2D(32, 32, 1, stride=2, bias_attr=False,
                               data_format=fmt, device="cpu"),
                        BatchNorm2D(32, data_format=fmt, device="cpu"))
        blk = BottleneckBlock(32, 8, stride=2, downsample=ds,
                              data_format=fmt, device="cpu")
        load_jax_state(blk, _jax_state(jblk))
        blk.eval()
    else:
        jblk = _jax_block(data_format=fmt)
        blk = _port_block(jblk, fmt)
    if case == "folded_bn":
        assert jfuse_conv_bn(jblk) == 3
        assert fuse_conv_bn(blk) == 3
    shape = (1, 4, 4, 32) if case == "small_plane" else (1, 28, 28, 32)
    if fmt == "NCHW":
        shape = (shape[0], shape[3], shape[1], shape[2])
    return jblk, blk, shape, fmt


GATE_CASES = {"admitted": True, "opt_in_off": False,
              "stride2_downsample": False, "small_plane": False,
              "nchw": False, "folded_bn": False}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_gate_matches_jax(case, monkeypatch):
    jblk, blk, shape, fmt = _gate_case(case)
    if case == "opt_in_off":
        monkeypatch.setattr(jfc, "_FUSED_EVAL_ENABLED", False)
        fc.enable_fused_conv_eval(False)
    want = jfc.fused_bottleneck_supported(jblk, shape, fmt, backend="tpu")
    got = fc.fused_bottleneck_supported(blk, shape, fmt, device_type="cuda")
    assert got == want == GATE_CASES[case]


def test_gate_admits_only_cuda_inputs_outside_plain_kernels():
    jblk, blk, shape, fmt = _gate_case("admitted")
    assert fc.fused_bottleneck_supported(blk, shape, fmt, "cuda")
    assert not fc.fused_bottleneck_supported(blk, shape, fmt, "cpu")
    # None: the device of the block's weights (the CPU here)
    assert not fc.fused_bottleneck_supported(blk, shape, fmt)
    with plain_kernels():
        assert not fc.fused_bottleneck_supported(blk, shape, fmt, "cuda")


def test_block_forward_routes_fused_in_eval_only(monkeypatch):
    """With the device rule admitting the CPU, an eval forward goes
    through ``fused_bottleneck_eval`` (its plain version here) and
    matches the eager chain; train mode stays eager."""
    calls = []
    real = fc.fused_bottleneck_eval
    monkeypatch.setattr(fc, "_device_admits", lambda device_type: True)
    monkeypatch.setattr(fc, "fused_bottleneck_eval",
                        lambda *a: calls.append(1) or real(*a))
    blk = _port_block(_jax_block())
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 28, 28, 32)).astype(np.float32))
    with torch.no_grad():
        got = blk(x)
        assert calls, "eval forward did not route to the fused block"
        want = _eager(blk, x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                               atol=TOL)
    calls.clear()
    blk.train()
    blk(x)
    assert not calls


def test_pack_is_rebuilt_after_weights_load_in_place(monkeypatch):
    """``load_jax_state`` copies into the same storage: the pack cache,
    keyed on (data_ptr, _version), must not serve the old fold."""
    monkeypatch.setattr(fc, "_device_admits", lambda device_type: True)
    blk = _port_block(_jax_block(seed=1))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 28, 28, 32)).astype(np.float32))
    with torch.no_grad():
        first = blk(x)
        old_pack = blk._fused_pack[1]
        load_jax_state(blk, _jax_state(_jax_block(seed=7)))
        again = blk(x)
        want = _eager(blk, x)
    assert blk._fused_pack[1] is not old_pack
    assert not torch.allclose(first, again)
    np.testing.assert_allclose(again.numpy(), want.numpy(), rtol=TOL,
                               atol=TOL)


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing():
    blk = _port_block(_jax_block())
    params = fc.pack_bottleneck(blk)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 6, 5, 32)).astype(np.float32))
    before = fc.fused_bottleneck_eval.launches
    with torch.no_grad():
        got = fc.fused_bottleneck_eval(x, *params)
    assert fc.fused_bottleneck_eval.launches == before
    assert torch.equal(got, fc.fused_bottleneck_reference(x, *params))


def test_resnet50_nhwc_fused_path_matches_jax(monkeypatch):
    """ResNet-50 on weights carried from JAX, both sides opted in: JAX
    through the interpreted Pallas kernel (flash forced, so that its
    backend gate admits the CPU), the port through its plain version
    (its device rule patched to admit the CPU). At 112x112 the two
    stride-1 blocks of layer1 (28x28) route; layer2 (14x14) stays eager.
    Logits within 1e-4 relative in L2."""
    pt.seed(0)
    jm = jresnet50(data_format="NHWC")
    jm.eval()
    rng = np.random.default_rng(1)
    for layer in jm.sublayers():
        if isinstance(layer, jnn.BatchNorm2D):
            n = layer._num_features
            layer._mean.value = jnp.asarray(rng.normal(0, 0.3, n),
                                            jnp.float32)
            layer._variance.value = jnp.asarray(rng.uniform(0.5, 2.0, n),
                                                jnp.float32)
    m = resnet50(data_format="NHWC", device="cpu")
    load_jax_state(m, _jax_state(jm))
    m.eval()
    x = np.random.default_rng(6).standard_normal((1, 3, 112, 112)).astype(
        np.float32)
    calls = {"jax": 0, "port": 0}
    jreal, treal = jfc.fused_bottleneck_eval, fc.fused_bottleneck_eval

    def spy(side, real):
        def call(*a):
            calls[side] += 1
            return real(*a)
        return call

    monkeypatch.setattr(jfc, "fused_bottleneck_eval", spy("jax", jreal))
    monkeypatch.setattr(fc, "fused_bottleneck_eval", spy("port", treal))
    monkeypatch.setattr(fc, "_device_admits", lambda device_type: True)
    with jfa.force_flash_for_aot(), pt.no_grad():
        want = np.asarray(jm(pt.Tensor(jnp.asarray(x))).value)
    with torch.inference_mode():
        got = m(torch.from_numpy(x)).numpy()
    assert calls == {"jax": 2, "port": 2}

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    assert rel(got, want) < MODEL_REL_TOL
    fc.enable_fused_conv_eval(False)
    with torch.inference_mode():
        eager = m(torch.from_numpy(x)).numpy()
    assert calls["port"] == 2
    assert rel(got, eager) < MODEL_REL_TOL


# -- the kernel's decomposition (csrc/fused_bottleneck.cu) --------------------

FB_TOL = 1e-4   # chip_smoke.py's fp32 limit for the kernel (atol and rtol)
EMULATION_TOL = 1e-6


def _params(rng, c, m, dtype=torch.float32):
    """Packed weights at the scale of a folded block, f32 biases."""
    def draw(shape, scale):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))
    return (draw((c, m), (2.0 / c) ** 0.5).to(dtype), draw((1, m), 0.1),
            draw((9 * m, m), (2.0 / (9 * m)) ** 0.5).to(dtype),
            draw((1, m), 0.1), draw((m, c), (1.0 / m) ** 0.5).to(dtype),
            draw((1, c), 0.1))


def _cut(h, w, c, m, strips, col_tiles, dtype=torch.float32):
    """A configuration cutting an h x w image into strips x col_tiles."""
    tr, tc = -(-h // strips), -(-w // col_tiles)
    return fc.FusedBottleneckConfig(
        tr, tc, strips, col_tiles,
        fc.fused_bottleneck_smem(tr, tc, m, dtype.itemsize), 1, 0.0)


# (label, x shape, strips, column tiles): H not a multiple of the tile's
# rows (28 = 9 + 9 + 10), one-row strips, every tile at an image edge,
# the 6x5 plane, the delta image's edge columns in separate tiles, and
# the configuration the kernel takes (None)
EMULATION_CASES = {
    "28x28 uneven strips": ((1, 28, 28, 32), 3, 2),
    "6x5 one-row strips": ((2, 6, 5, 32), 6, 2),
    "6x5 4 strips": ((2, 6, 5, 32), 4, 2),
    "6x5 kernel's tiles": ((2, 6, 5, 32), None, None),
    "28x28 kernel's tiles": ((1, 28, 28, 32), None, None),
    "delta 2x2 tiles": (None, 2, 2),
    "delta kernel's tiles": (None, None, None),
}


def _emulation_case(case, dtype=torch.float32):
    shape, strips, col_tiles = EMULATION_CASES[case]
    rng = np.random.default_rng(11)
    xn = _delta_image() if shape is None else \
        rng.standard_normal(shape).astype(np.float32)
    n, h, w, c = xn.shape
    params = _params(rng, c, c // 4, dtype)
    cfg = None if strips is None else _cut(h, w, c, c // 4, strips,
                                           col_tiles, dtype)
    return xn, params, cfg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(EMULATION_CASES))
def test_strip_emulation_matches_reference(case, dtype):
    """The kernel's tiles with their recomputed halo and zero-padded y1
    tile give the plain version's output: within 1e-6 in fp32 (the same
    f32 sums, taken per tile), within the module's bf16 limit in bf16
    (a tile's sum can round y1 or y2 the other way)."""
    td = getattr(torch, dtype)
    xn, params, cfg = _emulation_case(case, td)
    x = _to_torch(xn, td)
    got = fc.fused_bottleneck_strip_emulation(x, *params, config=cfg)
    want = fc.fused_bottleneck_reference(x, *params)
    assert got.dtype == td and got.shape == x.shape
    tol = EMULATION_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("case", list(EMULATION_CASES))
def test_strip_emulation_matches_jax_kernel(case):
    """The decomposition against the TPU kernel (Pallas interpreter) on
    the same packed parameters, fp32, within chip_smoke.py's 1e-4."""
    xn, params, cfg = _emulation_case(case)
    want = jfc.fused_bottleneck_eval(
        jnp.asarray(xn), *[jnp.asarray(p.numpy()) for p in params])
    got = fc.fused_bottleneck_strip_emulation(_to_torch(xn, torch.float32),
                                              *params, config=cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FB_TOL,
                               atol=FB_TOL)


@pytest.mark.parametrize("m", [12, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pad_to_kernel_changes_no_output(m, dtype):
    """The wrapper pads M (and C with x) to multiples of 8 for the
    kernel: the padded block's output, cut back to C, is the block's."""
    td = getattr(torch, dtype)
    rng = np.random.default_rng(12)
    c = 4 * m
    params = _params(rng, c, m, td)
    x = _to_torch(rng.standard_normal((1, 6, 5, c)), td)
    padded = fc._pad_to_kernel(x, *params)
    assert padded[1].shape == (-(-c // 8) * 8, -(-m // 8) * 8)
    got = fc.fused_bottleneck_reference(*padded)[..., :c]
    assert torch.equal(got, fc.fused_bottleneck_reference(x, *params))


def test_kernel_layout_constants_match_the_source():
    """``fused_bottleneck_smem`` repeats the kernel's ``regions``: the
    constants it reads must be the kernel's."""
    src = open(os.path.join(ROOT, "paddle_tpu_torch", "csrc",
                            "fused_bottleneck.cu")).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("kBC") == fc._FB_BC
    assert const("kKC") == fc._FB_KC
    assert const("kStages") == fc._FB_STAGES
    assert const("kThreads") == fc.FB_THREADS
    assert const("kMaxSmem") == fc.FB_MAX_SMEM
    assert const("kPosWarps") * const("kNT1") * 8 == fc._FB_XP
    nt = re.search(r"kNT = sizeof\(T\) == 2 \? (\d) : (\d);", src)
    assert fc._FB_OP == {2: const("kPosWarps") * int(nt.group(1)) * 8,
                         4: const("kPosWarps") * int(nt.group(2)) * 8}
    blocks = re.search(r"kMinBlocks = sizeof\(T\) == 2 \? (\d) : (\d);", src)
    assert fc.FB_REG_BLOCKS == {2: int(blocks.group(1)),
                                4: int(blocks.group(2))}


def _old_kernel_fits(w, m):
    """The first, FMA kernel's rule (its ``strip_rows``): one f32 row of y1
    with its halo rows and one of y2 had to fit 227 KB."""
    def round4(v):
        return (v + 3) // 4 * 4
    return (round4(3 * w * m) + round4(w * m) + 16 * 68 + 16 * 64) * 4 \
        <= 232448


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_config_places_the_blocks_the_first_kernel_refused(dtype):
    """At a 896x896 input, ResNet-50's layer2, layer3 and layer4 identity
    blocks pass the gate, and the first kernel could not place one row of
    them (it returned cudaErrorInvalidValue). The tiles fit now."""
    td = getattr(torch, dtype)
    for h, c, m in ((112, 512, 128), (56, 1024, 256), (28, 2048, 512)):
        blk = BottleneckBlock(c, m, data_format="NHWC", device="cpu").eval()
        assert fc.fused_bottleneck_supported(blk, (1, h, h, c), "NHWC",
                                             device_type="cuda")
        assert not _old_kernel_fits(h, m)
        cfg = fc.fused_bottleneck_config(h, h, c, m, td)
        assert cfg.smem <= fc.FB_MAX_SMEM
        assert cfg.smem == fc.fused_bottleneck_smem(cfg.tr, cfg.tc, m,
                                                    td.itemsize)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_config_at_resnet50_main_path(dtype):
    """The two shapes ResNet-50 gives the kernel at 224x224 and N=128:
    tiles that hold the image, a halo share below 15%, and in bf16 two
    blocks an SM."""
    td = getattr(torch, dtype)
    for h, c, m in ((56, 256, 64), (28, 512, 128)):
        cfg = fc.fused_bottleneck_config(h, h, c, m, td, 128)
        assert cfg.strips * cfg.tr >= h and cfg.col_tiles * cfg.tc >= h
        assert 0 < cfg.halo_share < 0.15
        assert cfg.blocks_per_sm == (2 if dtype == "bfloat16" else 1)


def _emulated_tc_chain(x, w1, b1, w2, b2, w3, b3, passes):
    """The block with every product on the emulated tensor cores
    (``tc_matmul``: 3xTF32 or one TF32 pass), f32 sums: contraction
    depths C, 9M and M."""
    n, h, w, c = x.shape
    m = w1.shape[1]
    xf = x.reshape(-1, c)
    y1 = torch.relu(tc_matmul(xf, w1, passes) + b1)
    pad = torch.nn.functional.pad(y1.reshape(n, h, w, m),
                                  (0, 0, 1, 1, 1, 1))
    cols = torch.cat([pad[:, dy:dy + h, dx:dx + w] for dy in range(3)
                      for dx in range(3)], dim=-1).reshape(-1, 9 * m)
    y2 = torch.relu(tc_matmul(cols, w2, passes) + b2)
    out = torch.relu(tc_matmul(y2, w3, passes) + b3 + xf)
    return out.reshape(n, h, w, c)


@pytest.mark.parametrize("c, m", [(256, 64), (512, 128)])
def test_three_tf32_products_hold_fb_tol_through_the_chain(c, m):
    """The fp32 kernel's 3xTF32 products through all three convolutions
    at ResNet-50's layer1 and layer2 depths stay within FB_TOL of the
    plain f32 chain; one TF32 pass a product misses it."""
    rng = np.random.default_rng(13 + m)
    params = _params(rng, c, m)
    x = _to_torch(rng.standard_normal((1, 7, 6, c)), torch.float32)
    want = fc.fused_bottleneck_reference(x, *params)
    got3 = _emulated_tc_chain(x, *params, passes=3)
    torch.testing.assert_close(got3, want, atol=FB_TOL, rtol=FB_TOL)
    got1 = _emulated_tc_chain(x, *params, passes=1)
    assert not torch.allclose(got1, want, atol=FB_TOL, rtol=FB_TOL)
