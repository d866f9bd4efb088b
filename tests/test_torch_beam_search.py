"""The port's beam search against the JAX package's, on the CPU: the
beam ops of ``ops/decode_extra.py`` and ``BeamSearchDecoder`` /
``dynamic_decode`` of ``nn/decode.py``.

The beam ops must equal JAX's bit for bit on their integer outputs, ties
included: ``jax.lax.top_k`` puts the lowest index first among equal
values, and the port's stable descending sort must pick the same. One
case here is built so that a top-k breaking ties the other way fails it.
Scores are sums of the same fp32 operands in the same order, so they
are held equal too.

The decoder runs over a ``GRUCell`` with an embedding and a projection
(as ``tests/test_api_parity_tail.py`` and ``tests/test_book_models.py``
drive the JAX one), over a zero projection (every candidate tied), over
a projection that ends every beam at once (the early exit), and over a
2-layer Transformer decoder cell whose ``MultiHeadAttention.Cache``
states travel as tuples of tensors (and, in the port alone, from empty
caches). Ids and lengths equal JAX's on the
pinned seeds; scores, sums of up to 8 fp32 log-probs computed in other
orders, within 1e-5 absolute (measured below 2e-6).
"""

import _torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu.ops import decode_extra as jde
from paddle_tpu.tensor import Tensor

import jax.numpy as jnp
from paddle_tpu_torch.nn import common as tc
from paddle_tpu_torch.nn import decode as td
from paddle_tpu_torch.nn import rnn as trnn
from paddle_tpu_torch.nn import transformer as ttr
from paddle_tpu_torch.nn.layer import load_jax_state
from paddle_tpu_torch.ops import decode_extra as tde
from test_torch_transformer import jax_state

SCORE_ATOL = 1e-5


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


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(getattr(x, "value", x))


def _step_inputs(case, b=3, beam_in=4, v=6, seed=0):
    rng = np.random.default_rng(seed)
    logp = np.log(rng.dirichlet(np.ones(v), (b, beam_in))).astype(np.float32)
    scores = rng.standard_normal((b, beam_in)).astype(np.float32)
    finished = None
    if case == "zero_projection":
        # a zero projection: every token log(1/V), and equal scores
        logp[:] = np.float32(-np.log(v))
        scores[:] = 0.0
    elif case == "finished":
        finished = np.zeros((b, beam_in), bool)
        finished[0, :3] = True
        finished[1, 1] = True
        scores[0, :3] = -1.5  # three finished beams tie on end_token
    elif case == "first_step":
        logp, scores = logp[:, :1], np.zeros((b, 1), np.float32)
    return logp, scores, finished


def _jax_step(logp, scores, k, end_token=None, finished=None):
    top, parent, tok = jde.beam_search_step(
        jnp.asarray(logp), jnp.asarray(scores), k, end_token=end_token,
        finished=None if finished is None else jnp.asarray(finished))
    return tuple(np.asarray(x) for x in (top, parent, tok))


@pytest.mark.parametrize("case", ["random", "zero_projection", "finished",
                                  "first_step"])
def test_beam_search_step_equals_jax_bitwise(case):
    logp, scores, finished = _step_inputs(case)
    end = 2 if finished is not None else None
    want = _jax_step(logp, scores, 4, end_token=end, finished=finished)
    got = tde.beam_search_step(
        torch.from_numpy(logp), torch.from_numpy(scores), 4, end_token=end,
        finished=None if finished is None else torch.from_numpy(finished))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), w)
    assert got[1].dtype == torch.int32 and got[2].dtype == torch.int32


def _unstable_step(logp, scores, k):
    """A top-k that breaks ties the other way (highest index first), as
    an unstable sort may: the flat candidates sorted stably after
    reversing them."""
    b, beam_in, v = logp.shape
    flat = (scores[:, :, None] + logp).reshape(b, -1)
    top, rev = torch.sort(flat.flip(1), dim=1, descending=True, stable=True)
    idx = flat.shape[1] - 1 - rev[:, :k]
    return top[:, :k], idx // v, idx % v


def test_a_tie_order_other_than_jaxs_fails_the_tied_case():
    logp, scores, _ = _step_inputs("zero_projection")
    want = _jax_step(logp, scores, 4)
    _, parent, tok = _unstable_step(torch.from_numpy(logp),
                                    torch.from_numpy(scores), 4)
    assert not (np.array_equal(parent.numpy(), want[1]) and
                np.array_equal(tok.numpy(), want[2]))
    got = tde.beam_search_step(torch.from_numpy(logp),
                               torch.from_numpy(scores), 4)
    np.testing.assert_array_equal(got[2].numpy(), want[2])


def test_end_token_is_required_with_finished():
    logp, scores, finished = _step_inputs("finished")
    with pytest.raises(ValueError, match="end_token"):
        tde.beam_search_step(torch.from_numpy(logp),
                             torch.from_numpy(scores), 4,
                             finished=torch.from_numpy(finished))


def _tree(seed, t=6, b=3, beam=4, v=9):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, v, (t, b, beam)).astype(np.int32)
    parents = rng.integers(0, beam, (t, b, beam)).astype(np.int32)
    return ids, parents


def test_gather_tree_equals_jax_bitwise():
    ids, parents = _tree(1)
    want = np.asarray(jde.gather_tree(jnp.asarray(ids), jnp.asarray(parents)))
    got = tde.gather_tree(torch.from_numpy(ids), torch.from_numpy(parents))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ties", [False, True])
def test_beam_search_decode_equals_jax_bitwise(ties):
    ids, parents = _tree(2)
    scores = np.random.default_rng(3).standard_normal((3, 4)).astype(
        np.float32)
    if ties:
        scores[0] = 1.0  # the first beam wins among equals
        scores[2, 1:] = 2.0
    jseq, jbest = jde.beam_search_decode(jnp.asarray(ids),
                                         jnp.asarray(parents),
                                         jnp.asarray(scores))
    seq, best = tde.beam_search_decode(torch.from_numpy(ids),
                                       torch.from_numpy(parents),
                                       torch.from_numpy(scores))
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))
    np.testing.assert_array_equal(best.numpy(), np.asarray(jbest))
    jseq0, _ = jde.beam_search_decode(jnp.asarray(ids), jnp.asarray(parents))
    seq0, none = tde.beam_search_decode(torch.from_numpy(ids),
                                        torch.from_numpy(parents))
    assert none is None
    np.testing.assert_array_equal(seq0.numpy(), np.asarray(jseq0))


# -- BeamSearchDecoder / dynamic_decode ---------------------------------------

def _gru_pair(v, h, proj="seeded"):
    """A ``GRUCell``, an ``Embedding`` and a ``Linear`` from seed 0 in
    the JAX package, and the port's with their weights. ``proj``:
    "zero" zeroes the projection, "end" makes it pick token 2."""
    pt.seed(0)
    jparts = (jnn.GRUCell(h, h), jnn.Embedding(v, h), jnn.Linear(h, v))
    tparts = (trnn.GRUCell(h, h, device="cpu"),
              tc.Embedding(v, h, device="cpu"), tc.Linear(h, v, device="cpu"))
    for j, t in zip(jparts, tparts):
        state = jax_state(j)
        if t is tparts[2] and proj != "seeded":
            state = {k: np.zeros_like(a) for k, a in state.items()}
            if proj == "end":
                state["bias"][2] = 50.0
            j.set_state_dict({k: Tensor(a) for k, a in state.items()})
        load_jax_state(t, state)
    return jparts, tparts


def _decode(parts, wrap, init, beam, max_steps, **kw):
    cell, emb, proj = parts
    mod = jnn if wrap is Tensor else td
    dec = mod.BeamSearchDecoder(cell, start_token=1, end_token=2,
                                beam_size=beam, embedding_fn=emb,
                                output_fn=proj)
    return mod.dynamic_decode(dec, inits=wrap(init), max_step_num=max_steps,
                              **kw)


@pytest.mark.parametrize("proj", ["seeded", "zero", "end"])
def test_decoder_over_a_gru_cell_matches_jax(proj):
    """``tests/test_api_parity_tail.py``'s setup (V=7, H=8, beam 3, 5
    steps, zero states) with lengths, the projection as seeded, zero
    (all ties) and ending every beam at the first step."""
    jparts, tparts = _gru_pair(7, 8, proj)
    init = np.zeros((2, 8), np.float32)
    want = _decode(jparts, Tensor, init, 3, 5, return_length=True)
    got = _decode(tparts, torch.from_numpy, init, 3, 5, return_length=True)
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
    np.testing.assert_allclose(_np(got[1]), _np(want[1]),
                               atol=SCORE_ATOL, rtol=0)
    np.testing.assert_array_equal(_np(got[2]), _np(want[2]))
    assert got[2].dtype == torch.int32
    if proj == "end":
        # the first step's three beams: the end token and two others
        # 50 nats below, which end at the second step: the loop stops
        # there, not at 5
        assert tuple(got[0].shape) == (2, 2)


def test_decoder_from_an_encoder_state_matches_jax_time_major():
    """``tests/test_book_models.py``'s inference shape: V=64, H=32, beam
    3, 6 steps from a (random) encoder state, ids time-major."""
    jparts, tparts = _gru_pair(64, 32)
    init = np.random.default_rng(5).standard_normal((2, 32)).astype(
        np.float32)
    want = _decode(jparts, Tensor, init, 3, 6, output_time_major=True)
    got = _decode(tparts, torch.from_numpy, init, 3, 6,
                  output_time_major=True)
    assert tuple(got[0].shape) == (6, 2)
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
    np.testing.assert_allclose(_np(got[1]), _np(want[1]),
                               atol=SCORE_ATOL, rtol=0)


def test_decoder_keeps_state_container_types():
    """Nested tuple / list / dict states are tiled and reordered with
    their types kept."""
    seen = []

    def cell(inputs, states):
        seen.append(states)
        h = states["h"][0] + inputs[:, None].float()
        return h, {"h": (h, [h * 2])}

    dec = td.BeamSearchDecoder(cell, start_token=1, end_token=2,
                               beam_size=2)
    init = {"h": (torch.zeros(3, 5), [torch.zeros(3, 5)])}
    ids, scores = td.dynamic_decode(dec, inits=init, max_step_num=3)
    assert tuple(ids.shape) == (3, 3)
    for s in seen:
        assert type(s) is dict and type(s["h"]) is tuple and \
            type(s["h"][1]) is list and tuple(s["h"][0].shape) == (6, 5)
    tiled = td.BeamSearchDecoder.tile_beam_merge_with_batch(
        torch.arange(3.0)[:, None], 2)
    assert tiled[:, 0].tolist() == [0.0, 0.0, 1.0, 1.0, 2.0, 2.0]


def _sinusoid(n, d):
    pos = np.arange(n)[:, None]
    div = np.exp(np.arange(0, d, 2) * (-np.log(10000.0) / d))
    out = np.zeros((n, d), np.float32)
    out[:, 0::2], out[:, 1::2] = np.sin(pos * div), np.cos(pos * div)
    return out


class _DecoderCell:
    """A Transformer decoder as a beam-search cell: the states are the
    memory and each layer's self-attention cache as ``(k, v)`` tuples
    (batch first, so the decoder tiles and reorders them); the position
    comes from the cache length."""

    def __init__(self, decoder, table, cache_cls, wrap, cat_len):
        self.decoder, self.table = decoder, table
        self.cache_cls, self.wrap, self.cat_len = cache_cls, wrap, cat_len

    def __call__(self, x, states):
        memory, caches = states
        pos = self.cat_len(caches[0][0])
        x = x + self.wrap(self.table[pos:pos + 1])
        out, new = self.decoder(
            x.reshape((x.shape[0], 1, x.shape[1])), memory,
            cache=[(self.cache_cls(k, v),) for k, v in caches])
        out = out.reshape((out.shape[0], out.shape[2]))
        return out, (memory, tuple((c[0].k, c[0].v) for c in new))


def test_decoder_over_a_transformer_decoder_cell_matches_jax():
    v, d, beam, steps = 11, 16, 3, 8
    pt.seed(0)
    jdec = jnn.TransformerDecoder(
        jnn.TransformerDecoderLayer(d, 2, 32, dropout=0.0), 2)
    jemb, jproj = jnn.Embedding(v, d), jnn.Linear(d, v)
    for m in (jdec, jemb, jproj):
        m.eval()
    tdec = ttr.TransformerDecoder(
        ttr.TransformerDecoderLayer(d, 2, 32, dropout=0.0, device="cpu"), 2)
    temb, tproj = tc.Embedding(v, d, device="cpu"), tc.Linear(d, v,
                                                              device="cpu")
    for j, t in ((jdec, tdec), (jemb, temb), (jproj, tproj)):
        load_jax_state(t, jax_state(j))
        t.eval()
    table = _sinusoid(steps + 1, d)
    memory = np.random.default_rng(6).standard_normal((2, 5, d)).astype(
        np.float32)

    def run(mod, dec, emb, proj, wrap, cache_cls, cat_len):
        mem = wrap(memory)
        # the caches start from a one-token prefix (the start token at
        # position 0): the JAX decoder cannot tile an empty [B, 0, H, D]
        # cache (its reshape divides by the zero size); the port can
        bos = emb(wrap(np.ones((2,), np.int64)))
        cell = _DecoderCell(dec, table, cache_cls, wrap, cat_len)
        empty = tuple((c[0].k, c[0].v) for c in dec.gen_cache(mem))
        _, (_, caches) = cell(bos, (mem, empty))
        bs = mod.BeamSearchDecoder(cell, start_token=1, end_token=2,
                                   beam_size=beam, embedding_fn=emb,
                                   output_fn=proj)
        return mod.dynamic_decode(bs, inits=(mem, caches),
                                  max_step_num=steps, return_length=True)

    want = run(jnn, jdec, jemb, jproj, Tensor,
               jnn.MultiHeadAttention.Cache, lambda k: k.shape[1])
    with torch.no_grad():
        got = run(td, tdec, temb, tproj, torch.from_numpy,
                  ttr.MultiHeadAttention.Cache, lambda k: k.shape[1])
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
    np.testing.assert_allclose(_np(got[1]), _np(want[1]),
                               atol=SCORE_ATOL, rtol=0)
    np.testing.assert_array_equal(_np(got[2]), _np(want[2]))
