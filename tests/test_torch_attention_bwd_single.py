"""The single pass of the tensor-core attention backward
(``csrc/attention_bwd.cu`` modes 2 and 3), emulated on the CPU
(``tests/attention_bwd_emulation.py``): the key-major walk (a block per
K tile, the Q tiles that see it, each split into two 32-query halves
with their own dK/dV partial sums), S^T = K Q^T and dP^T = V dO^T with
P^T and dS^T as A operands, the per-K-tile dQ shares summed in tile
order, all five products (and the two of the folded statistics launch)
in 3xTF32. It is held within 1e-5 of the plain versions and of the JAX
vjps (the Pallas kernels in interpret mode).
"""

import _torch_threads  # noqa: F401

import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import folded_attention as jfo

from paddle_tpu_torch.ops.kernels import attention as tat
from attention_bwd_emulation import (KT, emulated_single_pass,
                                     emulated_stats, stats_walk, visible,
                                     walk)
from test_torch_attention_bwd import (  # noqa: F401 (_interpret)
    TOL, _close, _flash_case, _inputs,
                                      _interpret, _jax_flash_vjp, _t)


@pytest.mark.parametrize("sq,sk", [(128, 128), (200, 200), (256, 256),
                                   (130, 200), (200, 70)])
@pytest.mark.parametrize("causal", [False, True])
def test_single_pass_walk_visits_each_visible_tile_pair_once(sq, sk,
                                                             causal):
    pairs = list(walk(sq, sk, causal))
    assert len(pairs) == len(set(pairs))
    assert set(pairs) == visible(sq, sk, causal)
    # the blocks' walks shorten along the grid: tile 0 is launched first
    lengths = [sum(1 for kt, _ in pairs if kt == t)
               for t in range(-(-sk // KT))]
    if causal:
        assert lengths == sorted(lengths, reverse=True)
    # the statistics launch: every visible pair of each Q tile once, the
    # longest walks first
    stats = [(kt, qt) for qt, kt in stats_walk(sq, sk, causal)]
    assert len(stats) == len(set(stats))
    assert set(stats) == visible(sq, sk, causal)
    if causal:
        walks = [sum(1 for _, q_ in stats if q_ == qt)
                 for qt in dict.fromkeys(q_ for _, q_ in stats)]
        assert walks == sorted(walks, reverse=True)


# S=200 is not a multiple of the 64-row tile: the last Q tile's second
# half and the last K tile are ragged
@pytest.mark.parametrize("s", [128, 200])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("glse", [False, True])
def test_emulated_single_pass_keeps_fp32_accuracy(s, d, causal, glse):
    _, args = _flash_case(s, d, causal, glse)
    want = tat.attention_bwd_reference(*args, causal=causal)
    got = emulated_single_pass(*args, causal)
    for g_, w in zip(got, want):
        torch.testing.assert_close(g_, w, atol=TOL, rtol=TOL)
    # one TF32 pass keeps about three digits: it misses the fp32 limit
    one = emulated_single_pass(*args, causal, passes=1)
    assert not all(torch.allclose(g_, w, atol=TOL, rtol=TOL)
                   for g_, w in zip(one, want))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("glse", [False, True])
def test_emulated_single_pass_matches_jax_vjp(_interpret, d, causal, glse):
    (q, k, v, do, g), args = _flash_case(128, d, causal, glse)
    _, _, want = _jax_flash_vjp(q, k, v, do, g, causal)
    _close(emulated_single_pass(*args, causal), want)


@pytest.mark.parametrize("s", [128, 200])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_emulated_folded_keeps_fp32_accuracy(s, d, causal):
    q, k, v, do, _ = _inputs(400 + s + d + causal, s, d)
    tq, tk, tv, tdo = _t(q), _t(k), _t(v), _t(do)
    want_l = tat.attention_reference(tq, tk, tv, causal=causal)[1]
    want = tat.folded_bwd_reference(tq, tk, tv, tdo, causal=causal)
    lse, delta = emulated_stats(tq, tk, tv, tdo, causal)
    torch.testing.assert_close(lse, want_l, atol=TOL, rtol=TOL)
    got = emulated_single_pass(tq, tk, tv, tdo, lse, delta, causal)
    for g_, w in zip(got, want):
        torch.testing.assert_close(g_, w, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_emulated_folded_matches_jax_vjp(_interpret, d, causal):
    q, k, v, do, _ = _inputs(500 + d + causal, 128, d)
    with jfa.force_flash_for_aot():
        _, vjp = jax.vjp(functools.partial(jfo.folded_attention,
                                           causal=causal),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = _t(q), _t(k), _t(v), _t(do)
    lse, delta = emulated_stats(tq, tk, tv, tdo, causal)
    _close(emulated_single_pass(tq, tk, tv, tdo, lse, delta, causal), want)
