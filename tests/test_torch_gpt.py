"""The PyTorch port's GPT against the JAX package's, on the CPU.

The port loads the JAX model's ``checkpoint_state`` without renaming,
then the same numpy inputs go through both. Logits agree within 1e-4 in
fp32 (both on the CPU; sums in different orders), and greedy paged
decoding produces the same tokens.
"""

import _torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.tensor import Tensor

from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.nn.decode import fused_sample_token, sample_token


@pytest.fixture(scope="module")
def models():
    pt.seed(0)
    jm = jgpt.GPTForCausalLM(jgpt.gpt_tiny())
    jm.eval()
    tm = tgpt.GPTForCausalLM(tgpt.gpt_tiny(), device="cpu")
    tm.eval()
    tgpt.load_jax_state(tm, jgpt.checkpoint_state(jm))
    return jm, tm


def test_load_jax_state_and_checkpoint_state_round_trip(models):
    jm, tm = models
    want = jgpt.checkpoint_state(jm)
    got = tgpt.checkpoint_state(tm)
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        assert got[name].shape == arr.shape, name
        assert np.array_equal(got[name], arr), name
    fresh = tgpt.GPTForCausalLM(tgpt.gpt_tiny(), device="cpu")
    tgpt.load_jax_state(fresh, got)
    again = tgpt.checkpoint_state(fresh)
    assert all(np.array_equal(again[k], got[k]) for k in got)


def test_load_jax_state_rejects_mismatched_state(models):
    _, tm = models
    state = tgpt.checkpoint_state(tm)
    state.pop("gpt.ln_f.bias")
    with pytest.raises(KeyError):
        tgpt.load_jax_state(tm, state)
    state = tgpt.checkpoint_state(tm)
    state["gpt.ln_f.bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError):
        tgpt.load_jax_state(tm, state)


@pytest.mark.parametrize("seq", [7, 32])
def test_forward_logits_match_jax(models, seq):
    jm, tm = models
    ids = np.random.default_rng(seq).integers(0, 1024, (2, seq)).astype(
        np.int32)
    want = np.asarray(jm(Tensor(ids)).value)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def _paged_greedy(tm, prompt, steps, fused, quantized=False):
    cfg = tm.config
    page, mp = 8, 8
    caches = [tgpt.paged_cache_create(1, mp, page, cfg.num_heads,
                                      cfg.head_dim, torch.float32, mp,
                                      quantized=quantized)
              for _ in range(cfg.num_layers)]
    n = len(prompt)
    ids = torch.zeros((1, 16), dtype=torch.long)  # bucket-padded
    ids[0, :n] = torch.as_tensor(prompt)
    plen = torch.tensor([n], dtype=torch.int32)
    w, ty, bias = tm.head_params()
    out = []
    with torch.no_grad():
        hidden, caches = tm.decode_hidden(ids, caches, prefill_lens=plen,
                                          fused=fused)
        tok = fused_sample_token(hidden[:, n - 1], w, transpose_y=ty)
        for _ in range(steps):
            out.append(int(tok[0]))
            if fused:
                hidden, caches = tm.decode_hidden(tok[:, None].long(),
                                                  caches, fused=True)
                tok = fused_sample_token(hidden[:, -1], w, transpose_y=ty)
            else:
                logits, caches = tm(tok[:, None].long(), caches=caches)
                tok = sample_token(logits[:, -1])
    return out


@pytest.mark.parametrize("fused", [True, False])
def test_paged_prefill_and_decode_match_jax_greedy(models, fused):
    jm, tm = models
    prompt = np.random.default_rng(11).integers(0, 1024, 9).astype(np.int32)
    want = np.asarray(jm.generate(
        Tensor(prompt[None]), max_new_tokens=16, temperature=0.0,
        use_jit=True, kv_cache="paged", page_size=8).value)[0, 9:]
    got = _paged_greedy(tm, prompt, 16, fused)
    assert got == want.tolist()


def test_int8_pages_track_fp_pages(models):
    _, tm = models
    prompt = np.random.default_rng(12).integers(0, 1024, 9)
    fp = _paged_greedy(tm, prompt, 8, True)
    q8 = _paged_greedy(tm, prompt, 8, True, quantized=True)
    assert fp[0] == q8[0]  # the prefill attends unquantized k/v


def test_paged_kv_append_matches_jax():
    """Ragged append: padding and over-capacity positions go to the
    scratch page, lengths clamp at the table's capacity."""
    import jax.numpy as jnp
    rng = np.random.default_rng(13)
    n_pages, page, h, d, mp = 5, 4, 2, 8, 2
    table = np.array([[0, 1], [2, 3]], np.int32)
    lens = np.array([3, 6], np.int32)
    k = rng.standard_normal((2, 4, h, d)).astype(np.float32)
    v = rng.standard_normal((2, 4, h, d)).astype(np.float32)
    valid = np.array([4, 1], np.int32)
    for valid_len in (None, valid):
        jc = jgpt.paged_cache_create(2, n_pages, page, h, d, jnp.float32,
                                     mp, page_table=jnp.asarray(table),
                                     seq_lens=jnp.asarray(lens))
        jn = jgpt.paged_kv_append(
            jc, jnp.asarray(k), jnp.asarray(v),
            valid_len=None if valid_len is None else jnp.asarray(valid_len))
        tc = tgpt.paged_cache_create(2, n_pages, page, h, d, torch.float32,
                                     mp, page_table=torch.from_numpy(table),
                                     seq_lens=torch.from_numpy(lens))
        tn = tgpt.paged_kv_append(
            tc, torch.from_numpy(k), torch.from_numpy(v),
            valid_len=None if valid_len is None
            else torch.from_numpy(valid_len))
        assert tn.seq_lens.tolist() == np.asarray(jn.seq_lens).tolist()
        # real pages agree; the scratch page holds whatever landed last
        np.testing.assert_array_equal(tn.k_pages.numpy()[:n_pages],
                                      np.asarray(jn.k_pages)[:n_pages])
        np.testing.assert_array_equal(tn.v_pages.numpy()[:n_pages],
                                      np.asarray(jn.v_pages)[:n_pages])
        assert tn.k_pages is tc.k_pages  # updated in place


def test_configs_mirror_jax():
    for name in ("gpt_tiny", "gpt_125m", "gpt_350m", "gpt_1p3b"):
        j = getattr(jgpt, name)()
        t = getattr(tgpt, name)()
        for field in ("vocab_size", "hidden_size", "num_layers",
                      "num_heads", "max_seq_len", "layer_norm_epsilon",
                      "tie_word_embeddings", "dtype"):
            assert getattr(t, field) == getattr(j, field), (name, field)


@pytest.mark.parametrize("side", ["jax", "port"])
def test_positional_use_cache_follows_jax(models, side):
    """``GPTModel`` / ``GPTBlock`` / ``GPTAttention`` take JAX's order
    ``(x, position_ids / cache, ..., use_cache, prefill_lens, ...)``:
    ``gpt(ids, None, None, True)`` returns ``(hidden, caches)`` with one
    eager ``(k, v)`` pair a layer, and a second call continues from them.
    The port's hiddens are JAX's within 1e-4."""
    jm, tm = models
    ids = np.random.default_rng(3).integers(0, 1024, (1, 5)).astype(
        np.int32)
    nxt = np.array([[17]], np.int32)
    h, caches = jm.gpt(Tensor(ids), None, None, True)
    h2, caches2 = jm.gpt(Tensor(nxt), None, caches, True)
    jx = Tensor(np.asarray(jm.gpt.wte(Tensor(ids)).value))
    jblk = jm.gpt.h[0](jx, None, True)
    jatt = jm.gpt.h[0].attn(jx, None, True)
    assert len(caches) == len(caches2) == 2 and len(jblk) == len(jatt) == 2
    if side == "jax":
        return
    with torch.no_grad():
        th, tcaches = tm.gpt(torch.from_numpy(ids).long(), None, None, True)
        th2, tcaches2 = tm.gpt(torch.from_numpy(nxt).long(), None,
                               tcaches, True)
        tx = torch.from_numpy(np.array(jx.value))
        tblk = tm.gpt.h[0](tx, None, True)
        tatt = tm.gpt.h[0].attn(tx, None, True)
    assert len(tcaches) == len(tcaches2) == 2
    assert tuple(tcaches2[0][0].shape) == tuple(caches2[0][0].shape)
    for got, want in ((th, h), (th2, h2), (tblk[0], jblk[0]),
                      (tatt[0], jatt[0]), (tcaches2[1][1], caches2[1][1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(
            want.value if isinstance(want, Tensor) else want),
            atol=1e-4, rtol=1e-4)
