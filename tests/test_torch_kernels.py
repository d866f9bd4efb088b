"""The PyTorch port's kernel modules against the JAX package's.

Each plain PyTorch version (what a kernel wrapper runs for CPU tensors,
and what chip_smoke.py holds each CUDA kernel against on the card) is
compared with the JAX function on the same numpy inputs made from a
seed. The JAX attention kernels run as their own tests run them on the
CPU: through the Pallas interpreter. Tolerance 1e-5 in fp32: both sides
compute in fp32 on the CPU, with sums in different orders.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import folded_attention as jfo
from paddle_tpu.ops.pallas import fused_sample as jfs
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu.quantization.quant import quantize_kv as jquantize_kv

from paddle_tpu_torch.ops.kernels import attention as tat
from paddle_tpu_torch.ops.kernels import fused_sample as tfs
from paddle_tpu_torch.ops.kernels import paged_attention as tpa
from paddle_tpu_torch.ops import nn_functional as tnf
from paddle_tpu_torch.quantization.quant import quantize_kv

TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _pool(rng, n_pages, page, h, d):
    return (rng.standard_normal((n_pages + 1, page, h, d)).astype(np.float32),
            rng.standard_normal((n_pages + 1, page, h, d)).astype(np.float32))


# -- paged attention ----------------------------------------------------------

@pytest.mark.parametrize("case", ["ragged", "int8", "q_offsets"])
def test_paged_reference_matches_jax(case):
    rng = np.random.default_rng(0)
    n_pages, page, h, d = 7, 8, 2, 64
    kp, vp = _pool(rng, n_pages, page, h, d)
    table = np.array([[0, 2, 4], [5, 3, 1], [6, 6, 6]], np.int32)
    lens = np.array([20, 7, 0], np.int32)  # 3 pages, 1 page, empty
    sq = 4 if case == "q_offsets" else 1
    q = rng.standard_normal((3, sq, h, d)).astype(np.float32)
    jargs, targs = {}, {}
    if case == "int8":
        kq, ks = jquantize_kv(jnp.asarray(kp))
        vq, vs = jquantize_kv(jnp.asarray(vp))
        jk, jv = kq, vq
        jargs = dict(k_scale=ks, v_scale=vs)
        tk, tv = _t(kq), _t(vq)
        targs = dict(k_scale=_t(ks), v_scale=_t(vs))
    else:
        jk, jv, tk, tv = jnp.asarray(kp), jnp.asarray(vp), _t(kp), _t(vp)
    if case == "q_offsets":
        offs = np.array([10, 3, 0], np.int32)
        jargs["q_offsets"] = jnp.asarray(offs)
        targs["q_offsets"] = _t(offs)
    want = jpa.paged_attention_reference(
        jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(lens),
        **jargs)
    got = tpa.paged_attention_reference(_t(q), tk, tv, _t(table),
                                        _t(lens), **targs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    if case != "q_offsets":
        assert np.all(got.numpy()[2] == 0.0)  # len 0 -> zeros, not NaN


@pytest.mark.parametrize("int8", [False, True])
def test_paged_fused_reference_matches_jax(int8):
    rng = np.random.default_rng(1)
    n_pages, page, h, d = 6, 8, 2, 64
    kp, vp = _pool(rng, n_pages, page, h, d)
    table = np.array([[0, 2, 4], [5, 3, 1]], np.int32)
    lens = np.array([17, 8], np.int32)
    q = rng.standard_normal((2, 1, h, d)).astype(np.float32)
    w = (rng.standard_normal((h * d, 256)) * 0.05).astype(np.float32)
    b = rng.standard_normal((256,)).astype(np.float32)
    jk, jv, tk, tv = jnp.asarray(kp), jnp.asarray(vp), _t(kp), _t(vp)
    jextra, textra = {}, {}
    if int8:
        jk, jks = jquantize_kv(jk)
        jv, jvs = jquantize_kv(jv)
        tk, tv = _t(jk), _t(jv)
        jextra = dict(k_scale=jks, v_scale=jvs)
        textra = dict(k_scale=_t(jks), v_scale=_t(jvs))
    want = jpa.paged_attention_fused_reference(
        jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(lens),
        jnp.asarray(w), jnp.asarray(b), **jextra)
    got = tpa.paged_attention_fused_reference(
        _t(q), tk, tv, _t(table), _t(lens), _t(w), _t(b), **textra)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    # the op the model calls composes the same two wrappers on the CPU
    sel = tnf.paged_attention_fused(_t(q), tk, tv, _t(table), _t(lens),
                                    _t(w), _t(b), **textra)
    assert torch.equal(sel, got)


def test_paged_decode_and_out_proj_wrappers_on_cpu_are_plain():
    rng = np.random.default_rng(2)
    kp, vp = _pool(rng, 4, 8, 2, 64)
    table = _t(np.array([[0, 1], [2, 3]], np.int32))
    lens = _t(np.array([9, 0], np.int32))
    q = _t(rng.standard_normal((2, 2, 64)).astype(np.float32))
    ctx = tpa.paged_decode(q, _t(kp), _t(vp), table, lens)
    ref = tpa.paged_attention_reference(q[:, None], _t(kp), _t(vp), table,
                                        lens)[:, 0]
    assert torch.equal(ctx, ref)
    w = _t(rng.standard_normal((128, 128)).astype(np.float32))
    b = _t(rng.standard_normal((128,)).astype(np.float32))
    out = tpa.decode_out_proj(ctx.reshape(2, 128), w, b)
    assert torch.equal(out, ctx.reshape(2, 128) @ w + b)
    assert tpa.paged_decode.launches == 0  # CPU tensors launch nothing


def test_quantize_kv_matches_jax_bitwise():
    x = np.random.default_rng(3).standard_normal((5, 8, 2, 64)).astype(
        np.float32)
    jq, js = jquantize_kv(jnp.asarray(x))
    tq, ts = quantize_kv(_t(x))
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))


def test_kernel_wrappers_refuse_non_cpu_tensors_without_a_card():
    """A wrapper takes the plain version only for CPU tensors: anything
    else must reach the kernel checks (and raise here), never the plain
    path."""
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_decode(torch.empty(2, 2, 64, **meta),
                         torch.empty(5, 8, 2, 64, **meta),
                         torch.empty(5, 8, 2, 64, **meta),
                         torch.empty(2, 2, dtype=torch.int32, **meta),
                         torch.empty(2, dtype=torch.int32, **meta))
    with pytest.raises(ValueError, match="CUDA"):
        tpa.decode_out_proj(torch.empty(2, 128, **meta),
                            torch.empty(128, 128, **meta))
    with pytest.raises(ValueError, match="CUDA"):
        tfs.fused_argmax(torch.empty(2, 128, **meta),
                         torch.empty(1000, 128, **meta))
    with pytest.raises(ValueError):
        tat.attention_fwd(torch.empty(1, 128, 2, 64, **meta),
                          torch.empty(1, 128, 2, 64, **meta),
                          torch.empty(1, 128, 2, 64, **meta))


@pytest.mark.parametrize("q_shape,kp_shape", [
    ((8, 1, 16, 128), (257, 64, 16, 128)),
    ((4, 1, 4, 32), (33, 8, 4, 32)),
    ((2, 3, 2, 64), (9, 8, 2, 64)),
    ((2, 1, 2, 64), (9, 6, 2, 64)),
])
def test_paged_gate_matches_jax(q_shape, kp_shape):
    assert tpa.paged_attention_supported(q_shape, kp_shape) == \
        jpa.paged_attention_supported(q_shape, kp_shape, backend="tpu")


# -- streaming argmax ---------------------------------------------------------

def _argmax_case(rng, case, vocab, d=128, b=3):
    h = rng.standard_normal((b, d)).astype(np.float32)
    w = (rng.standard_normal((vocab, d)) * 0.1).astype(np.float32)
    if case == "tie":
        w[vocab // 3] = w[vocab - 5] = h[0] / np.linalg.norm(h[0]) * 50
    if case == "nan":
        w[vocab // 2, 0] = np.nan
        w[vocab - 3, 0] = np.nan
    return h, w


@pytest.mark.parametrize("layout", ["vocab_major", "feature_major"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("case", ["plain", "tie", "nan"])
def test_fused_argmax_reference_matches_jax(layout, bias, case):
    rng = np.random.default_rng(4)
    vocab, tile = 1000, 256  # partial last tile (1000 % 256 != 0)
    h, w = _argmax_case(rng, case, vocab)
    vdim = 0 if layout == "vocab_major" else 1
    if vdim == 1:
        w = np.ascontiguousarray(w.T)
    bb = rng.standard_normal((vocab,)).astype(np.float32) if bias else None
    want = jfs.fused_argmax_reference(
        jnp.asarray(h), jnp.asarray(w), vdim,
        bias=None if bb is None else jnp.asarray(bb), tile=tile)
    got = tfs.fused_argmax_reference(
        _t(h), _t(w), vdim, bias=None if bb is None else _t(bb), tile=tile)
    assert got.tolist() == np.asarray(want).tolist()
    logits = h @ (w.T if vdim == 0 else w) + (0 if bb is None else bb)
    assert got.tolist() == np.argmax(logits, axis=1).tolist()
    if case == "tie" and not bias:
        assert int(got[0]) == vocab // 3   # first index of the tie
    if case == "nan":
        assert got.tolist() == [vocab // 2] * 3  # first NaN wins


def test_fused_topk_reference_matches_jax():
    rng = np.random.default_rng(5)
    h, w = _argmax_case(rng, "plain", 1000)
    jv, ji = jfs.fused_topk_reference(jnp.asarray(h), jnp.asarray(w), 0, 8,
                                      tile=256)
    tv, ti = tfs.fused_topk_reference(_t(h), _t(w), 0, 8, tile=256)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=TOL)
    assert ti.tolist() == np.asarray(ji).tolist()


def test_fused_sample_selection_on_cpu_is_the_reference():
    rng = np.random.default_rng(6)
    h, w = _argmax_case(rng, "plain", 1000)
    got = tnf.fused_sample(_t(h), _t(w), transpose_y=True)
    assert got.tolist() == np.argmax(h @ w.T, axis=1).tolist()
    assert tfs.fused_argmax.launches == 0


# -- attention ----------------------------------------------------------------

@pytest.fixture
def _interpret(monkeypatch):
    for mod in (jfa, jfo):
        monkeypatch.setattr(mod.pl, "pallas_call",
                            functools.partial(mod.pl.pallas_call,
                                              interpret=True))
    yield


def _qkv(rng, b, s, h, d):
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_matches_jax_kernel(_interpret, d, causal):
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, 1, 256, 2, d)
    with jfa.force_flash_for_aot():
        jo, jl = jfa.flash_attention_lse(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=causal,
                                         block_q=128, block_k=128)
    to, tl = tat.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_folded_attention_matches_jax_kernel(_interpret, d, causal):
    rng = np.random.default_rng(8)
    q, k, v = _qkv(rng, 1, 128, 2, d)
    with jfa.force_flash_for_aot():
        jo = jfo.folded_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal)
    to = tat.folded_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-4,
                               rtol=1e-4)


def test_attention_reads_strided_qkv_slices():
    """The model hands the kernel q/k/v as slices of the fused QKV
    projection; the plain version must agree with contiguous copies."""
    qkv = torch.randn(1, 128, 3, 2, 64, generator=torch.Generator()
                      .manual_seed(0))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    a, la = tat.attention_fwd(q, k, v, causal=True)
    b, lb = tat.attention_fwd(q.contiguous(), k.contiguous(),
                              v.contiguous(), causal=True)
    assert torch.equal(a, b) and torch.equal(la, lb)


@pytest.mark.parametrize("s", [64, 128, 256, 512, 1024, 2048])
def test_sdpa_routing_matches_jax_gates(s):
    """At GPT-1.3B's head shape the port sends each prefill bucket to the
    same kernel the JAX package sends it to on the TPU."""
    shape = (1, s, 16, 128)
    j_fold = jfo.folded_attention_supported(shape, shape, True,
                                            backend="tpu")
    j_flash = jfa.flash_attention_supported(shape, shape, backend="tpu")
    assert tat.folded_attention_supported(shape, shape, True) == j_fold
    assert tat.flash_attention_supported(shape, shape) == j_flash
    route = ("folded" if j_fold else "flash" if j_flash else "plain")
    assert route == {64: "plain", 128: "folded", 256: "folded",
                     512: "flash", 1024: "flash", 2048: "flash"}[s]


@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_plain_path_matches_jax(causal):
    from paddle_tpu.ops.nn_functional import \
        scaled_dot_product_attention as jsdpa
    rng = np.random.default_rng(9)
    q, k, v = _qkv(rng, 2, 16, 2, 32)
    want = jsdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 is_causal=causal, use_flash=False)
    got = tnf.scaled_dot_product_attention(_t(q), _t(k), _t(v),
                                           is_causal=causal,
                                           use_flash=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
