"""The split page walk of ``paged_decode``, rehearsed on the CPU.

The CUDA kernel (``csrc/paged_decode.cu``) runs only on the card. What
can be shown here:

- the partition (``paged_decode_split``): each of a sequence's
  ``ceil(len/page)`` pages once, in order, in splits that depend on the
  length and the page size alone;
- the kernel's arithmetic, a softmax partial per split merged in split
  order (``paged_decode_split_emulation``), against the JAX Pallas
  kernel in interpret mode and the port's dense reference, with fp32
  and int8 pools, at lengths 0, 1, exactly one split, one past a split
  and several splits: within 1e-5 (fp32 sums in other orders on both
  sides);
- poisoned pages the sequence does not own, table entries past its last
  split and rows past its length leave the result unchanged;
- ``chip_smoke.py``'s bytes bound of the int8 and bf16 rows.
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
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu.quantization.quant import quantize_kv as jquantize_kv

from paddle_tpu_torch.ops.kernels import paged_attention as tpa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
SPLIT = tpa.PAGED_SPLIT_TOKENS


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


# -- the partition ------------------------------------------------------------

@pytest.mark.parametrize("page", [8, 16, 64])
@pytest.mark.parametrize("length", [0, 1, 63, 64, 65, SPLIT - 1, SPLIT,
                                    SPLIT + 1, 1000, 2048, 4096])
def test_split_covers_each_page_once_in_order(length, page):
    splits = tpa.paged_decode_split(length, page)
    per = tpa.paged_decode_pages_per_split(page)
    pages = [p for first, end in splits for p in range(first, end)]
    assert pages == list(range(math.ceil(length / page)))
    for s, (first, end) in enumerate(splits):
        assert first == s * per and 0 < end - first <= per
    if length == 0:
        assert splits == []


def test_split_is_whole_pages_of_the_split_size():
    assert tpa.paged_decode_pages_per_split(64) * 64 == SPLIT
    assert tpa.paged_decode_split(SPLIT, 64) == [(0, SPLIT // 64)]
    assert tpa.paged_decode_split(SPLIT + 1, 64) == [
        (0, SPLIT // 64), (SPLIT // 64, SPLIT // 64 + 1)]
    # a page wider than a split is one page a split
    assert tpa.paged_decode_pages_per_split(2 * SPLIT) == 1


def test_split_stops_at_the_table_row():
    assert tpa.paged_decode_split(10 * 64, 64, max_pages=6) == \
        tpa.paged_decode_split(6 * 64, 64)


def _batch(rng, bsz, page, h, d, max_pages):
    lens = rng.integers(0, max_pages * page + 1, size=bsz).astype(np.int32)
    n_pool = bsz * max_pages
    table = rng.permutation(n_pool).astype(np.int32).reshape(bsz, max_pages)
    k = rng.standard_normal((n_pool + 1, page, h, d)).astype(np.float32)
    v = rng.standard_normal((n_pool + 1, page, h, d)).astype(np.float32)
    q = rng.standard_normal((bsz, h, d)).astype(np.float32)
    return q, k, v, table, lens


@pytest.mark.parametrize("bsz", [1, 8, 64])
def test_split_of_a_row_is_the_same_in_any_batch(bsz):
    """A row's partition and its emulated context are the same bits
    alone and in a batch of 1, 8 or 64."""
    rng = np.random.default_rng(bsz)
    page, h, d, mp = 16, 2, 64, 60
    q, k, v, table, lens = _batch(rng, bsz, page, h, d, mp)
    lens[0] = 3 * SPLIT + 5  # several splits in every batch
    tk, tv = _t(k), _t(v)
    got = tpa.paged_decode_split_emulation(_t(q), tk, tv, _t(table),
                                           _t(lens))
    for i in range(bsz):
        assert tpa.paged_decode_split(int(lens[i]), page, mp) == \
            tpa.paged_decode_split(int(lens[i]), page)
        alone = tpa.paged_decode_split_emulation(
            _t(q[i:i + 1]), tk, tv, _t(table[i:i + 1]), _t(lens[i:i + 1]))
        assert torch.equal(alone[0], got[i])


def test_merge_of_an_empty_partial_gives_no_nan():
    h, d = 2, 4
    empty = (torch.full((h,), -1e30), torch.zeros(h), torch.zeros(h, d))
    real = (torch.tensor([0.5, -3.0]), torch.tensor([2.0, 1.5]),
            torch.arange(h * d, dtype=torch.float32).reshape(h, d))
    for a, b in ((empty, real), (real, empty)):
        m, l, acc = tpa.paged_decode_merge(*a, *b)  # noqa: E741
        assert torch.equal(m, real[0]) and torch.equal(l, real[1])
        assert torch.equal(acc, real[2])
    m, l, acc = tpa.paged_decode_merge(*empty, *empty)  # noqa: E741
    assert torch.equal(l, empty[1]) and torch.equal(acc, empty[2])
    assert not torch.isnan(m).any()


# -- against the JAX kernel and the reference ---------------------------------

@pytest.fixture
def _interpret(monkeypatch):
    monkeypatch.setattr(jpa.pl, "pallas_call",
                        functools.partial(jpa.pl.pallas_call,
                                          interpret=True))
    yield


# lengths 0, 1, exactly one split, one past a split, several splits
LENS = (0, 1, SPLIT, SPLIT + 1, 3 * SPLIT + SPLIT // 2)


def _pools(rng, page, h, d, lens):
    mp = max(math.ceil(n / page) for n in lens)
    n_pool = len(lens) * mp
    k = rng.standard_normal((n_pool + 1, page, h, d)).astype(np.float32)
    v = rng.standard_normal((n_pool + 1, page, h, d)).astype(np.float32)
    table = rng.permutation(n_pool).astype(np.int32).reshape(len(lens), mp)
    return k, v, table


@pytest.mark.parametrize("pool", ["fp32", "int8"])
@pytest.mark.parametrize("page,h,d", [(64, 2, 64), (16, 1, 128)])
def test_emulation_matches_jax_kernel_and_reference(_interpret, pool, page,
                                                    h, d):
    rng = np.random.default_rng(page + d)
    k, v, table = _pools(rng, page, h, d, LENS)
    lens = np.array(LENS, np.int32)
    q = rng.standard_normal((len(LENS), 1, h, d)).astype(np.float32)
    jk, jv, jextra, textra = jnp.asarray(k), jnp.asarray(v), {}, {}
    if pool == "int8":
        jk, jks = jquantize_kv(jk)
        jv, jvs = jquantize_kv(jv)
        jextra = dict(k_scale=jks, v_scale=jvs)
        textra = dict(k_scale=_t(jks), v_scale=_t(jvs))
    tk, tv = _t(jk), _t(jv)
    with jfa.force_flash_for_aot():
        assert jpa.paged_attention_supported(q.shape, k.shape)
        want = np.asarray(jpa.paged_attention(
            jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(lens),
            **jextra))[:, 0]
    got = tpa.paged_decode_split_emulation(_t(q[:, 0]), tk, tv, _t(table),
                                           _t(lens), **textra)
    ref = tpa.paged_attention_reference(_t(q), tk, tv, _t(table), _t(lens),
                                        **textra)[:, 0]
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=TOL, rtol=TOL)
    assert np.all(got.numpy()[0] == 0.0)  # len 0 -> zeros, not NaN


def test_emulation_rounds_once_to_the_query_dtype():
    rng = np.random.default_rng(5)
    page, h, d = 64, 2, 64
    k, v, table = _pools(rng, page, h, d, LENS)
    lens = _t(np.array(LENS, np.int32))
    q = _t(rng.standard_normal((len(LENS), h, d)).astype(np.float32))
    kb, vb = _t(k).to(torch.bfloat16), _t(v).to(torch.bfloat16)
    got = tpa.paged_decode_split_emulation(q.to(torch.bfloat16), kb, vb,
                                           _t(table), lens)
    f32 = tpa.paged_decode_split_emulation(q.to(torch.bfloat16).float(),
                                           kb.float(), vb.float(),
                                           _t(table), lens)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, f32.to(torch.bfloat16))


# -- poisoned pages -----------------------------------------------------------

def _poisoned(k, v, table, lens, where, value):
    """Copies of the pools with ``value`` written where the walk must not
    read: pages no row owns, the pages the table names past each row's
    last split, or the rows past each length in its last page."""
    page = k.shape[1]
    k, v, table = k.copy(), v.copy(), table.copy()
    owned = {int(table[i, p]) for i, n in enumerate(lens)
             for p in range(math.ceil(n / page))}
    if where == "unowned pages":
        for p in set(range(k.shape[0])) - owned:
            k[p], v[p] = value, -value
    elif where == "past the last split":
        scratch = k.shape[0] - 1
        k[scratch], v[scratch] = value, -value
        for i, n in enumerate(lens):
            table[i, math.ceil(n / page):] = scratch
    else:  # rows past the length
        for i, n in enumerate(lens):
            if n % page:
                p = table[i, n // page]
                k[p, n % page:], v[p, n % page:] = value, -value
    return k, v, table


@pytest.mark.parametrize("where", ["unowned pages", "past the last split",
                                   "rows past the length"])
def test_poisoned_pages_do_not_change_the_result(where):
    rng = np.random.default_rng(7)
    page, h, d = 16, 2, 64
    lens = np.array([1, SPLIT + 1, 2 * SPLIT + 7], np.int32)
    k, v, table = _pools(rng, page, h, d, [n + page for n in lens])
    q = _t(rng.standard_normal((len(lens), h, d)).astype(np.float32))
    tl = _t(lens)
    base = tpa.paged_decode_split_emulation(q, _t(k), _t(v), _t(table), tl)
    # the split walk never reads them: NaN changes no bit
    pk, pv, pt = _poisoned(k, v, table, lens, where, np.nan)
    got = tpa.paged_decode_split_emulation(q, _t(pk), _t(pv), _t(pt), tl)
    assert torch.equal(got, base)
    # the dense reference reads and masks them: finite poison only
    ref = tpa.paged_attention_reference(q[:, None], _t(k), _t(v), _t(table),
                                        tl)[:, 0]
    pk, pv, pt = _poisoned(k, v, table, lens, where, 1e6)
    ref_p = tpa.paged_attention_reference(q[:, None], _t(pk), _t(pv),
                                          _t(pt), tl)[:, 0]
    np.testing.assert_allclose(ref_p.numpy(), ref.numpy(), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=TOL, rtol=TOL)


# -- chip_smoke.py's bound ----------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("pool,kv_bytes,q_bytes", [
    ("fp32", 4 * 128, 4), ("bf16", 2 * 128, 2), ("int8", 128 + 4, 4)])
def test_chip_smoke_paged_bytes(pool, kv_bytes, q_bytes):
    """K and V read once per (position, head): D values of the pool's
    width, plus a 4-byte scale for int8 pools; q read and the context
    written once; the table row and the length read once."""
    cs = _chip_smoke()
    B, H, D, mp, tokens = 8, 16, 128, 32, 4450
    want = (2 * tokens * H * kv_bytes + 2 * B * H * D * q_bytes
            + B * mp * 4 + B * 4)
    assert cs.paged_bytes(tokens, B, H, D, mp, pool) == want
