"""``ops/sequence.py``, ``framework/ragged.py`` and the CRF / segment /
misc ops of ``ops/decode_extra.py`` of the port against the JAX package,
and a small BiGRU-CRF tagger built on both sides.

The ops: every sweep case (``tools/eager_sweep.py``) through both
packages' public wrappers, values and dtypes exact except where
``_torch_tail_parity.LOOSE`` states a relative limit (1e-5 for the CRF
NLL and ``sequence_conv``), gradients within 10x the value limit. The
tagger (embedding -> 2-layer BiGRU -> ``static.nn.fc`` ->
``linear_chain_crf``) runs from the same weights in both packages: its
NLL within 1e-5 relative, every gradient within 1e-4 of its largest
entry, the Viterbi paths equal and ``chunk_eval``'s counts equal.
"""

import _torch_threads  # noqa: F401

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from _torch_eager_parity import covered, on_cpu, registry_names
from _torch_tail_parity import tail_parity
from paddle_tpu_torch.tools.eager_sweep import (decode_extra_cases,
                                                sequence_cases)

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


SEQ, DEC = sequence_cases(), decode_extra_cases()
CRF_NEW = {"linear_chain_crf", "crf_decoding", "segment_sum",
           "segment_mean", "segment_max", "segment_min", "segment_pool",
           "multiplex", "mv", "increment", "p_norm", "frobenius_norm",
           "mul"}


@pytest.mark.parametrize("case", SEQ, ids=[c[0] for c in SEQ])
def test_sequence_op_matches_jax(case):
    tail_parity(case)


@pytest.mark.parametrize("case", DEC, ids=[c[0] for c in DEC])
def test_decode_extra_op_matches_jax(case):
    tail_parity(case)


def test_every_op_is_covered_and_registered_as_in_jax():
    jnames, tnames = registry_names("sequence")
    assert tnames == jnames and covered(SEQ) == set(jnames)
    jnames, tnames = registry_names("decode_extra")
    assert tnames == jnames
    assert CRF_NEW <= covered(DEC) and CRF_NEW <= set(tnames)


def test_ragged_round_trip_matches_jax():
    from paddle_tpu.framework.ragged import RaggedTensor as JR
    from paddle_tpu_torch.framework.ragged import RaggedTensor as TR
    rows = [np.arange(3, dtype=np.float32), np.zeros(0, np.float32),
            np.ones(2, np.float32)]
    j, t = JR.from_rows(rows), TR.from_rows(rows)
    np.testing.assert_array_equal(t.values, j.values)
    np.testing.assert_array_equal(t.row_splits, j.row_splits)
    for m in (None, 2, 5):
        for a, b in zip(t.to_padded(m, pad_value=-1),
                        j.to_padded(m, pad_value=-1)):
            np.testing.assert_array_equal(a, b)
    import torch
    padded, lens = t.to_padded()
    back = TR.from_padded(torch.from_numpy(padded), torch.from_numpy(lens))
    np.testing.assert_array_equal(back.values, t.values)
    assert len(t.concat(t)) == 6


def test_sequence_pad_refuses_to_truncate():
    x = paddle.to_tensor(np.ones((2, 4, 1), np.float32))
    with pytest.raises(ValueError, match="padded_length"):
        paddle.sequence_pad(x, paddle.to_tensor(np.array([4, 1], np.int32)),
                            padded_length=2)
    out = paddle.sequence_pad(x, paddle.to_tensor(np.array([2, 1],
                                                           np.int32)),
                              padded_length=2)
    assert tuple(out.shape) == (2, 2, 1)


def test_viterbi_ties_take_the_first_maximum():
    """All-equal scores: every back-pointer is tag 0, as ``jnp.argmax``
    gives it; a last-maximum order would give K - 1."""
    em = np.zeros((2, 4, 3), np.float32)
    tr = np.zeros((5, 3), np.float32)
    got = paddle.crf_decoding(paddle.to_tensor(em), paddle.to_tensor(tr),
                              paddle.to_tensor(np.array([4, 2], np.int32)))
    want = pt.crf_decoding(pt.to_tensor(em), pt.to_tensor(tr),
                           pt.to_tensor(np.array([4, 2], np.int32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))
    assert got.numpy().tolist() == [[0, 0, 0, 0], [0, 0, 0, 0]]


# -- a BiGRU-CRF tagger on both sides -------------------------------------------

V, E, H, K, B, T = 50, 8, 6, 5, 4, 7


def _tagger_data():
    r = np.random.default_rng(11)
    lens = np.array([7, 3, 5, 1], np.int32)
    ids = r.integers(1, V, (B, T)).astype(np.int32)
    tags = r.integers(0, K, (B, T)).astype(np.int32)
    return ids, tags, lens


def _tagger(pkg, nn, sn, attr, ids, tags, lens, gru):
    x = pkg.to_tensor(ids)
    emb = sn.embedding(x, (V, E), param_attr=attr(name="emb"))
    h, _ = gru(emb)
    emission = sn.fc(h, K, num_flatten_dims=2, weight_attr=attr(name="fc_w"),
                     bias_attr=attr(name="fc_b"))
    trans = sn.fc(pkg.to_tensor(np.eye(K + 2, dtype=np.float32)), K,
                  weight_attr=attr(name="trans"), bias_attr=False)
    nll = pkg.linear_chain_crf(emission, trans, pkg.to_tensor(tags),
                               pkg.to_tensor(lens))
    path = pkg.crf_decoding(emission, trans, pkg.to_tensor(lens))
    return nll, path


def test_bigru_crf_tagger_matches_jax():
    import paddle_tpu.static as jst
    import paddle_tpu_torch.static as tst
    from paddle_tpu_torch.nn.layer import load_jax_state
    from paddle_tpu_torch.static.nn import load_jax_scope
    ids, tags, lens = _tagger_data()
    jgru = pt.nn.GRU(E, H, num_layers=2, direction="bidirect")
    tgru = paddle.nn.GRU(E, H, num_layers=2, direction="bidirect",
                         device="cpu")
    load_jax_state(tgru, {k: np.asarray(v.numpy()) for k, v in
                          jgru.state_dict().items()})
    with jst.scope_guard(jst.Scope()), tst.scope_guard(tst.Scope()):
        jnll, jpath = _tagger(pt, pt.nn, jst.nn, pt.ParamAttr, ids, tags,
                              lens, jgru)
        scope = jst.global_scope()
        load_jax_scope({n: np.asarray(scope.find_var(n).numpy())
                        for n in scope.local_var_names()})
        tnll, tpath = _tagger(paddle, paddle.nn, tst.nn, paddle.ParamAttr,
                              ids, tags, lens, tgru)
        np.testing.assert_allclose(tnll.numpy(), np.asarray(jnll.numpy()),
                                   rtol=1e-5)
        np.testing.assert_array_equal(tpath.numpy(),
                                      np.asarray(jpath.numpy()))
        jnll.sum().backward()
        tnll.sum().backward()
        for n in scope.local_var_names():
            jg = np.asarray(scope.find_var(n).grad.numpy())
            tg = tst.global_scope().find_var(n).grad.numpy()
            np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-4 * max(
                np.abs(jg).max(), 1e-6), err_msg=n)
        jgrads = {k: np.asarray(p.grad.numpy())
                  for k, p in jgru.named_parameters()}
        for k, p in tgru.named_parameters():
            np.testing.assert_allclose(
                p.grad.numpy(), jgrads[k], rtol=0,
                atol=1e-4 * max(np.abs(jgrads[k]).max(), 1e-6), err_msg=k)
        jc = pt.chunk_eval(jpath, pt.to_tensor(tags), pt.to_tensor(lens),
                           chunk_scheme="IOB", num_chunk_types=2)
        tc = paddle.chunk_eval(tpath, paddle.to_tensor(tags),
                               paddle.to_tensor(lens), chunk_scheme="IOB",
                               num_chunk_types=2)
        assert [float(v) for v in tc] == [float(v) for v in jc]
