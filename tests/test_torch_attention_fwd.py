"""The arithmetic of the tensor-core attention forward and the split-K
out-projection, rehearsed on the CPU.

The CUDA kernels (``csrc/attention_fwd.cu``, ``csrc/decode_out_proj.cu``)
run only on the card. What can be shown here:

- the 3xTF32 split the fp32 forward uses: an emulation (written here,
  not in the package) of TF32 rounding to nearest at 10 mantissa bits
  (hi) and of the tensor core's truncation of the remainder (lo),
  run through the kernel's tile-by-tile online softmax (each tile split
  between two warps whose states merge at the end), stays within
  1e-5 of the fp32 plain version, where single-pass TF32 misses 1e-4;
- the plain versions against the JAX package at the shapes the new
  kernels add (D=256, sequence lengths that are not a multiple of the
  JAX block, batch sizes around the out-projection's 8-row chunks);
- the wrapper's split-K partition and alignment rule, and
  ``chip_smoke.py``'s bound.
"""

import functools
import importlib.util
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import folded_attention as jfo
from paddle_tpu.ops.pallas import paged_attention as jpa

from paddle_tpu_torch.ops.kernels import attention as tat
from paddle_tpu_torch.ops.kernels import paged_attention as tpa
from tf32_emulation import split as _split
from tf32_emulation import tc_matmul as _tc_matmul
from tf32_emulation import tf32 as _tf32

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


# -- the forward on the emulated tensor cores (tests/tf32_emulation.py) ------

def _emulated_fwd(q, k, v, causal, passes, block_k=32):
    """The kernel's forward on [B, S, H, D] f32: K tiles of ``block_k``
    keys in order, each split between two warps that keep their own
    running max and sum per row (a row that has seen only masked keys
    takes its exponentials against 0), merged at the end; scores and P.V
    on the emulated tensor cores. Returns ``(out, lse)``."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    rows = torch.arange(sq)
    half = block_k // 2
    neg = torch.tensor(-1e30)
    parts = []
    for first in (0, half):
        m = torch.full((b, h, sq), -1e30)
        l = torch.zeros((b, h, sq))  # noqa: E741
        o = torch.zeros((b, h, sq, d))
        for k0 in range(first, sk, block_k):
            kt, vt = kh[:, :, k0:k0 + half], vh[:, :, k0:k0 + half]
            s = _tc_matmul(qh, kt.transpose(-1, -2), passes) * scale
            if causal:
                cols = torch.arange(k0, k0 + kt.shape[2])
                s = torch.where(cols[None, :] <= rows[:, None], s, neg)
            m_new = torch.maximum(m, s.amax(-1))
            ref = torch.where(m_new == neg, torch.tensor(0.0), m_new)
            alpha = torch.exp(m - ref)
            p = torch.exp(s - ref[..., None])
            l = l * alpha + p.sum(-1)  # noqa: E741
            o = o * alpha[..., None] + _tc_matmul(p, vt, passes)
            m = m_new
        parts.append((m, l, o))
    (m1, l1, o1), (m2, l2, o2) = parts
    m = torch.maximum(m1, m2)
    a1, a2 = torch.exp(m1 - m), torch.exp(m2 - m)
    den = (l1 * a1 + l2 * a2).clamp_min(1e-30)
    out = ((o1 * a1[..., None] + o2 * a2[..., None]) / den[..., None])
    return out.permute(0, 2, 1, 3), (m + torch.log(den)).transpose(1, 2)


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10  # TF32's step at 1
    x = torch.tensor([one + 0.49 * ulp, one + 0.51 * ulp, one + 0.5 * ulp,
                      -(one + 0.5 * ulp), 3.0], dtype=torch.float32)
    want = torch.tensor([one, one + ulp, one + ulp, -(one + ulp), 3.0])
    assert torch.equal(_tf32(x), want)
    hi, lo = _split(x)
    assert torch.equal(hi + lo, x)  # two TF32 terms hold these exactly


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [128, 512, 200])
def test_three_tf32_products_keep_fp32_accuracy(s, d, causal):
    rng = np.random.default_rng(100 + s + d + int(causal))
    q, k, v = (_t(rng.standard_normal((1, s, 2, d)).astype(np.float32))
               for _ in range(3))
    want_o, want_l = tat.attention_reference(q, k, v, causal=causal)
    # 200: ragged, the last tile's second half past the end
    out3, lse3 = _emulated_fwd(q, k, v, causal, passes=3,
                               block_k=64 if s == 200 else 32)
    torch.testing.assert_close(out3, want_o, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse3, want_l, atol=1e-5, rtol=1e-5)
    # one TF32 pass keeps about three digits: it misses the fp32 limit
    out1, _ = _emulated_fwd(q, k, v, causal, passes=1)
    assert not torch.allclose(out1, want_o, atol=1e-4, rtol=1e-4)


# -- the plain forward against the JAX kernels --------------------------------

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


# (S, D): D=256, which only the flash gate admits, and lengths that are
# not a multiple of the default 512 block (the JAX gate picks 384 and
# 128 blocks)
@pytest.mark.parametrize("s,d", [(384, 256), (640, 64), (384, 128)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_reference_matches_jax_kernel(_interpret, s, d, causal):
    rng = np.random.default_rng(11 + s + d)
    q, k, v = _qkv(rng, 1, s, 1, d)
    assert jfa.flash_attention_supported(q.shape, k.shape, backend="tpu")
    with jfa.force_flash_for_aot():
        jo, jl = jfa.flash_attention_lse(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=causal)
    to, tl = tat.attention_reference(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("s,d", [(384, 64), (384, 128)])
@pytest.mark.parametrize("causal", [False, True])
def test_folded_reference_matches_jax_kernel(_interpret, s, d, causal):
    rng = np.random.default_rng(13 + s + d)
    q, k, v = _qkv(rng, 1, s, 2, d)
    if not jfo.folded_attention_supported(q.shape, k.shape, causal,
                                          backend="tpu"):
        # causal D=128 caps at S=256 in the JAX gate; the port's gate agrees
        assert not tat.folded_attention_supported(q.shape, k.shape, causal)
        s = 256
        q, k, v = (x[:, :s] for x in (q, k, v))
    with jfa.force_flash_for_aot():
        jo = jfo.folded_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal)
    to, _ = tat.attention_reference(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5,
                               rtol=1e-5)


def test_strided_slices_pass_the_alignment_rule_and_offsets_do_not():
    qkv = torch.zeros((2, 200, 3, 4, 64))
    for i in range(3):
        tat.check_vector_aligned("attention_fwd", ("q", qkv[:, :, i]))
    bf = qkv.to(torch.bfloat16)
    tat.check_vector_aligned("attention_fwd", ("k", bf[:, :, 1]))
    flat = torch.zeros(1 + 2 * 200 * 4 * 64)
    shifted = flat[1:].view(2, 200, 4, 64)  # starts 4 bytes in
    with pytest.raises(ValueError, match="16-byte"):
        tat.check_vector_aligned("attention_fwd", ("q", shifted))
    rows = torch.zeros((1, 10, 1, 66))[..., :64]  # 264-byte rows
    with pytest.raises(ValueError, match="16-byte"):
        tat.check_vector_aligned("attention_fwd", ("v", rows))


# -- decode_out_proj ----------------------------------------------------------

@pytest.mark.parametrize("w_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("b", [1, 8, 9, 64])
def test_out_proj_reference_matches_jax_fused_reference(b, with_bias,
                                                        w_dtype):
    rng = np.random.default_rng(20 + b)
    n_pages, page, h, d = 2 * b + 1, 8, 2, 64
    kp = rng.standard_normal((n_pages + 1, page, h, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages + 1, page, h, d)).astype(np.float32)
    table = rng.permutation(2 * b).astype(np.int32).reshape(b, 2)
    lens = rng.integers(1, 2 * page + 1, size=b).astype(np.int32)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    w32 = (rng.standard_normal((h * d, 256)) * 0.05).astype(np.float32)
    b32 = rng.standard_normal((256,)).astype(np.float32)
    jw, jb = jnp.asarray(w32), jnp.asarray(b32)
    tw, tb = _t(w32), _t(b32)
    if w_dtype == "bf16":  # both round to nearest even
        jw, jb = jw.astype(jnp.bfloat16), jb.astype(jnp.bfloat16)
        tw, tb = tw.to(torch.bfloat16), tb.to(torch.bfloat16)
    want = jpa.paged_attention_fused_reference(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lens), jw, jb if with_bias else None)
    ctx = tpa.paged_attention_reference(_t(q), _t(kp), _t(vp), _t(table),
                                        _t(lens)).reshape(b, h * d)
    got = tpa.decode_out_proj_reference(ctx, tw, tb if with_bias else None)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want, np.float32)[:, 0],
                               atol=1e-5, rtol=1e-5)


H100_SMS = 132  # the H100 SXM's SM count


@pytest.mark.parametrize("k,n,itemsize", [
    (2048, 2048, 4), (2048, 2048, 2), (128, 256, 4), (1000, 512, 4),
    (4096, 1024, 2), (33, 64, 4), (4096, 8192, 4), (1, 8, 2),
    (5120, 5120, 4), (5120, 5120, 2), (12288, 1024, 4), (4097, 2048, 4)])
def test_out_proj_split_covers_k_exactly_once(k, n, itemsize):
    splits, rows = tpa.decode_out_proj_split(k, n, itemsize, H100_SMS)
    one_pass = tpa.OUT_PROJ_ROW_THREADS * tpa.OUT_PROJ_MAX_ROWS
    assert rows % tpa.OUT_PROJ_ROW_THREADS == 0
    assert 0 < rows
    assert rows <= one_pass or splits == tpa.OUT_PROJ_MAX_SPLITS
    assert 0 < splits <= tpa.OUT_PROJ_MAX_SPLITS  # one cluster
    seen = np.zeros(k, np.int64)
    for s in range(splits):
        lo, hi = s * rows, min(k, (s + 1) * rows)
        assert lo < hi  # no empty split
        seen[lo:hi] += 1
    assert np.all(seen == 1)


@pytest.mark.parametrize("itemsize,cols,want,blocks", [
    (4, 32, (4, 512), 256), (2, 64, (4, 512), 128)])
def test_out_proj_split_fills_one_wave_at_the_served_width(itemsize, cols,
                                                           want, blocks):
    # GPT-1.3B's projection, 2048 x 2048: nearly every one of the 132 SMs
    # holds as many blocks as fit at once, none waits for a second wave
    assert tpa.decode_out_proj_split(2048, 2048, itemsize, H100_SMS) == want
    assert want[0] * (2048 // cols) == blocks
    assert blocks <= tpa.decode_out_proj_wave(itemsize, H100_SMS) < \
        blocks + 2 * 8


def test_out_proj_split_passes_a_contraction_wider_than_a_cluster():
    # a 13B GPT's 5120-wide projection: eight splits of 640 rows, each
    # taken by the kernel in a pass of 512 rows and one of 128
    assert tpa.decode_out_proj_split(5120, 5120, 4, H100_SMS) == (8, 640)


# -- chip_smoke.py's bound ----------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("row,want_ms,want_by", [
    ("attention S=2048 causal", 0.104, "3xtf32"),
    ("decode_out_proj B=8 E=2048", 0.00505, "bytes"),
])
def test_chip_smoke_bound_takes_the_route_of_the_products(row, want_ms,
                                                          want_by):
    cs = _chip_smoke()
    if row.startswith("attention"):
        cost = cs.attention_fwd_cost(1, 2048, 16, 128, True)
    else:
        cost = cs.out_proj_cost(8, 2048, 2048)
    ms, by = cs.bound_ms(*cost)
    assert by == want_by
    assert ms == pytest.approx(want_ms, rel=5e-3)


def test_chip_smoke_bound_in_bf16_runs_at_the_bf16_rate():
    cs = _chip_smoke()
    nbytes, flops = cs.attention_fwd_cost(1, 2048, 16, 128, True, 2)
    ms, by = cs.bound_ms(nbytes, flops, "bf16")
    assert by == "bf16"
    assert ms == pytest.approx(flops / 989e12 * 1e3)


# -- chip_smoke.py's bf16 check of the forward -------------------------------

def _fwd_case(cs, s, seed, v_scale):
    """bf16 q, k, v as chip_smoke's bf16 forward checks make them (B=1,
    H=16, D=128, slices of one fused projection, v scaled), from a CPU
    generator."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v = cs._qkv(torch, gen, torch.device("cpu"), 1, s, s, 16, 128,
                      torch.bfloat16)
    v.mul_(v_scale)
    return q, k, v


def _f64_forward(q, k, v):
    """The causal forward in f64 from the same bf16 inputs: the value
    every f32 sum order approximates."""
    q, k, v = (t.double() for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    n = q.shape[1]
    s = s.masked_fill(torch.arange(n)[None, :] > torch.arange(n)[:, None],
                      -math.inf)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


@pytest.mark.parametrize("seed", [0, 3])
def test_bf16_forward_limit_after_rounding_refuses_the_exact_output(seed):
    """Why chip_smoke holds the forward's bf16 output to its 5e-3 before
    the rounding: at |out| >= 1 an ulp is 2^-7, so the exact output,
    rounded to bf16, lies an ulp from the plain version's rounded f32
    output in some element, beyond the limit; taken before the rounding,
    the limit passes it."""
    cs = _chip_smoke()
    q, k, v = _fwd_case(cs, 512, seed, 4.0)
    plain32, _ = tat.attention_reference(q.float(), k.float(), v.float(),
                                         causal=True)
    exact = _f64_forward(q, k, v).to(torch.bfloat16)
    tol = cs.BF16_ATOL["attention_fwd"]
    assert "attention_fwd" in cs.BF16_BEFORE_ROUNDING
    assert cs.max_err(exact, plain32.to(torch.bfloat16)) > tol
    assert cs.rounded_from(exact, plain32, tol)


@pytest.mark.parametrize("s,seed,v_scale,one_refused", [
    (512, 0, 4.0, True), (512, 1, 4.0, True), (200, 2, 4.0, True),
    (512, 0, 1.0, False)])
def test_bf16_forward_check_takes_two_term_p_refuses_one_term(
        s, seed, v_scale, one_refused):
    """The check passes the kernel's design (P as two bf16 terms) and,
    with v four times larger (chip_smoke's ``S=512 v x4`` case), refuses
    one bf16 term; on unit-variance values one term stays inside 5e-3
    before the rounding, which is why that case exists."""
    cs = _chip_smoke()
    q, k, v = _fwd_case(cs, s, seed, v_scale)
    plain32, _ = tat.attention_reference(q.float(), k.float(), v.float(),
                                         causal=True)
    tol = cs.BF16_ATOL["attention_fwd"]
    two = cs.bf16_terms_fwd(torch, 2, q, k, v, True)
    one = cs.bf16_terms_fwd(torch, 1, q, k, v, True)
    assert two.dtype == one.dtype == torch.bfloat16
    assert cs.rounded_from(two, plain32, tol)
    assert cs.rounded_from(one, plain32, tol) is not one_refused
    assert any(c[0] == "S=512 v x4" and c[4] == 4.0
               for c in cs.BF16_FWD_CASES)
