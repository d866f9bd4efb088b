"""The dQ and dK/dV passes of the tensor-core attention backward
(``csrc/attention_bwd.cu`` modes 0 and 1), emulated on the CPU down to
the warp's patch and its skip rule (``tests/attention_bwd_emulation.py``):
the dK/dV pass is the key-major walk without the dQ share (16 keys x one
32-query half a warp), the dQ pass the query-major walk of the forward
(16 queries x one 32-key half of every K tile a warp, the two halves'
partial sums added first then second). Held within 1e-5 of the plain
versions and of the JAX vjps (the Pallas kernels in interpret mode).
"""

import _torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import attention as tat
from attention_bwd_emulation import (GROUP, HALF, KT, dkv_patches,
                                     dq_patches, emulated_dkv, emulated_dq,
                                     patch_pairs, stats_walk)
from test_torch_attention_bwd import (  # noqa: F401 (_interpret)
    H, TOL, _close, _flash_case,
                                      _interpret, _jax_flash_vjp, _t)


@pytest.mark.parametrize("sq,sk", [(128, 128), (200, 200), (256, 256),
                                   (130, 200), (200, 70), (64, 300),
                                   (8, 8)])
@pytest.mark.parametrize("causal", [False, True])
def test_dq_and_dkv_walks_visit_each_visible_pair_once(sq, sk, causal):
    visible = patch_pairs((0, sq), (0, sk), sq, sk, causal)
    for patches, rows_cols in (
            (dkv_patches, lambda kt, qt, rg, qh: (
                (qt * KT + HALF * qh, qt * KT + HALF * (qh + 1)),
                (kt * KT + GROUP * rg, kt * KT + GROUP * (rg + 1)))),
            (dq_patches, lambda qt, kt, rg, kh: (
                (qt * KT + GROUP * rg, qt * KT + GROUP * (rg + 1)),
                (kt * KT + HALF * kh, kt * KT + HALF * (kh + 1))))):
        seen = []
        for patch in patches(sq, sk, causal):
            rows, cols = rows_cols(*patch)
            seen.extend(patch_pairs(rows, cols, sq, sk, causal))
        assert len(seen) == len(set(seen))
        assert set(seen) == visible, patches.__name__
    # causal: the blocks' walks shorten along each grid (the dK/dV pass's
    # K tiles, the dQ pass's Q tiles in launch order)
    if causal:
        kts = [kt for kt, _, _, _ in dkv_patches(sq, sk, causal)]
        walks = [kts.count(t) for t in dict.fromkeys(kts)]
        assert walks == sorted(walks, reverse=True)
        qts = [qt for qt, _ in stats_walk(sq, sk, causal)]
        walks = [qts.count(t) for t in dict.fromkeys(qts)]
        assert walks == sorted(walks, reverse=True)


def _cross_case(seed, sq, sk, d, causal, glse):
    """Inputs with Sq queries and Sk keys, the forward's lse and delta =
    rowsum(dO*O) - g_lse from the plain forward, as torch tensors."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, sq, H, d)).astype(np.float32)
    k, v = (rng.standard_normal((1, sk, H, d)).astype(np.float32)
            for _ in range(2))
    do = (0.1 * rng.standard_normal((1, sq, H, d))).astype(np.float32)
    g = ((0.1 * rng.standard_normal((1, sq, H))).astype(np.float32)
         if glse else np.zeros((1, sq, H), np.float32))
    tq, tk, tv, tdo = _t(q), _t(k), _t(v), _t(do)
    out, lse = tat.attention_reference(tq, tk, tv, causal=causal)
    delta = (tdo * out).sum(-1) - _t(g)
    return tq, tk, tv, tdo, lse, delta.contiguous()


# Sq != Sk and sizes that are not multiples of the 64-row tile: ragged
# last tiles, half tiles and patches past Sq or Sk
@pytest.mark.parametrize("sq,sk", [(128, 128), (200, 200), (130, 200),
                                   (200, 70)])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_emulated_dq_and_dkv_keep_fp32_accuracy(sq, sk, d, causal):
    args = _cross_case(600 + sq + sk + d + causal, sq, sk, d, causal,
                       glse=sq == sk)
    want = tat.attention_bwd_reference(*args, causal=causal)
    got = (emulated_dq(*args, causal),) + emulated_dkv(*args, causal)
    for g_, w in zip(got, want):
        torch.testing.assert_close(g_, w, atol=TOL, rtol=TOL)
    # one TF32 pass keeps about three digits: it misses the fp32 limit
    one = (emulated_dq(*args, causal, passes=1),) + emulated_dkv(
        *args, causal, passes=1)
    assert not all(torch.allclose(g_, w, atol=TOL, rtol=TOL)
                   for g_, w in zip(one, want))


# S=256 is two 128-row Q blocks: the JAX vjp runs the dQ and dK/dV
# kernels (#7, #8) in the Pallas interpreter
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("glse", [False, True])
def test_emulated_dq_and_dkv_match_jax_vjp(_interpret, d, causal, glse):
    (q, k, v, do, g), args = _flash_case(256, d, causal, glse)
    _, _, want = _jax_flash_vjp(q, k, v, do, g, causal)
    _close((emulated_dq(*args, causal),) + emulated_dkv(*args, causal),
           want)
