"""The port's ``nn/transformer.py`` against the JAX package's, on the CPU.

The JAX layers are built from seed 0 and their ``state_dict`` loads into
the port's layers with ``load_jax_state``; the same numpy inputs go
through both. Checked: ``MultiHeadAttention`` without a mask, with
additive and bool masks, as cross-attention with other key and value
widths, and with a cache; incremental decoding through ``gen_cache``
against one causal forward; pre-LN and post-LN encoder and decoder
layers and ``Transformer``; ``_clone_layer``'s fresh draws; and the
folded attention path at an unmasked S=256 against the JAX layer whose
SDPA runs the folded Pallas kernel in interpret mode.

Tolerance, stated: fp32 on both sides with sums in other orders, every
output of O(1): within 2e-5 absolute and 1e-5 relative (measured below
4e-6). The cached path against the full causal forward in the port: the
same products over fewer keys, within 1e-5. Gradients through the
folded Function against the plain math: within 1e-5 relative in L2 a
parameter.
"""

import _torch_threads  # noqa: F401

import functools

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import folded_attention as jfo
from paddle_tpu.tensor import Tensor

from paddle_tpu_torch.nn import transformer as tt
from paddle_tpu_torch.nn.layer import load_jax_state
from paddle_tpu_torch.ops import nn_functional as tnf
from paddle_tpu_torch.ops.kernels import attention as tat

ATOL = 2e-5
RTOL = 1e-5
CACHE_TOL = 1e-5
GRAD_REL = 1e-5
KEY_BIAS_ATOL = 1e-5


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


def jax_state(layer):
    """A JAX layer's ``state_dict`` as float32 numpy (bf16 widened)."""
    out = {}
    for k, v in layer.state_dict().items():
        a = np.asarray(v.value)
        out[k] = a.astype(np.float32) if a.dtype.name == "bfloat16" else a
    return out


def pair(jcls, tcls, *args, **kw):
    """The JAX layer from seed 0 and the port's with its weights, both
    in eval mode."""
    pt.seed(0)
    j = jcls(*args, **kw)
    j.eval()
    t = tcls(*args, device="cpu", **kw)
    t.eval()
    load_jax_state(t, jax_state(j))
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(getattr(x, "value", x))


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _masks(b, sq, sk, rng):
    """The masks a caller passes: None, BERT's additive padding mask
    [B, 1, 1, Sk], a causal additive [Sq, Sk] with -inf, a bool [B, 1,
    Sq, Sk] that keeps at least one key a row."""
    pad = np.zeros((b, 1, 1, sk), np.float32)
    pad[0, ..., sk - 3:] = -1e9
    causal = np.where(np.tril(np.ones((sq, sk), bool), k=sk - sq), 0.0,
                      -np.inf).astype(np.float32)
    keep = rng.random((b, 1, sq, sk)) < 0.7
    keep[..., 0] = True
    return {"none": None, "additive_padding": pad, "additive_causal": causal,
            "bool": keep}


@pytest.mark.parametrize("mask", ["none", "additive_padding",
                                  "additive_causal", "bool"])
def test_multi_head_attention_matches_jax(mask):
    rng = np.random.default_rng(1)
    j, t = pair(jnn.MultiHeadAttention, tt.MultiHeadAttention, 32, 4)
    x = _x(rng, 2, 7, 32)
    m = _masks(2, 7, 7, rng)[mask]
    want = j(Tensor(x), attn_mask=None if m is None else Tensor(m))
    got = t(torch.from_numpy(x),
            attn_mask=None if m is None else torch.from_numpy(m))
    close(got, want)


def test_cross_attention_with_other_key_and_value_widths_matches_jax():
    rng = np.random.default_rng(2)
    j, t = pair(jnn.MultiHeadAttention, tt.MultiHeadAttention, 32, 4,
                kdim=24, vdim=40)
    q, k, v = _x(rng, 2, 5, 32), _x(rng, 2, 9, 24), _x(rng, 2, 9, 40)
    m = _masks(2, 5, 9, rng)["additive_padding"]
    close(t(*map(torch.from_numpy, (q, k, v, m))),
          j(*map(Tensor, (q, k, v, m))))


def test_gen_cache_empty_and_projected_match_jax():
    rng = np.random.default_rng(3)
    j, t = pair(jnn.MultiHeadAttention, tt.MultiHeadAttention, 32, 4)
    mem = _x(rng, 2, 6, 32)
    empty = t.gen_cache(torch.from_numpy(mem))
    assert tuple(empty.k.shape) == (2, 0, 4, 8)
    assert empty.k.dtype == torch.float32
    jc = j.gen_cache(Tensor(mem), Tensor(mem))
    tc = t.gen_cache(torch.from_numpy(mem), torch.from_numpy(mem))
    close(tc.k, jc.k)
    close(tc.v, jc.v)
    # a forward with that cache attends over cache + the new keys
    x = _x(rng, 2, 3, 32)
    jo, jc2 = j(Tensor(x), cache=jc)
    to, tc2 = t(torch.from_numpy(x), cache=tc)
    close(to, jo)
    assert tuple(tc2.k.shape) == (2, 9, 4, 8)
    close(tc2.v, jc2.v)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_incremental_decode_equals_full_causal_forward(normalize_before):
    """A 2-layer decoder stepped one token at a time through
    ``gen_cache`` equals one forward under the causal mask, and the
    JAX decoder stepped the same way."""
    rng = np.random.default_rng(4 + normalize_before)
    kw = dict(dropout=0.0, normalize_before=normalize_before)
    pt.seed(0)
    jdec = jnn.TransformerDecoder(
        jnn.TransformerDecoderLayer(32, 4, 64, **kw), 2,
        jnn.LayerNorm(32) if normalize_before else None)
    jdec.eval()
    tdec = tt.TransformerDecoder(
        tt.TransformerDecoderLayer(32, 4, 64, device="cpu", **kw), 2,
        tnorm(32) if normalize_before else None)
    tdec.eval()
    load_jax_state(tdec, jax_state(jdec))
    tgt, mem = _x(rng, 2, 6, 32), _x(rng, 2, 5, 32)
    mask = tt.Transformer.generate_square_subsequent_mask(6, device="cpu")
    full = tdec(torch.from_numpy(tgt), torch.from_numpy(mem), tgt_mask=mask)
    tcache = tdec.gen_cache(torch.from_numpy(mem))
    jcache = jdec.gen_cache(Tensor(mem))
    steps_t, steps_j = [], []
    for i in range(6):
        o, tcache = tdec(torch.from_numpy(tgt[:, i:i + 1]),
                         torch.from_numpy(mem), cache=tcache)
        steps_t.append(o)
        jo, jcache = jdec(Tensor(tgt[:, i:i + 1]), Tensor(mem),
                          cache=jcache)
        steps_j.append(_np(jo))
    inc = torch.cat(steps_t, dim=1)
    close(inc, full, atol=CACHE_TOL, rtol=CACHE_TOL)
    close(inc, np.concatenate(steps_j, axis=1))
    assert tuple(tcache[0][0].k.shape) == (2, 6, 4, 8)


def tnorm(d):
    from paddle_tpu_torch.nn.norm import LayerNorm
    return LayerNorm(d, device="cpu")


@pytest.mark.parametrize("activation", ["relu", "gelu"])
@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_layer_and_encoder_match_jax(normalize_before, activation):
    rng = np.random.default_rng(6)
    j, t = pair(jnn.TransformerEncoderLayer, tt.TransformerEncoderLayer, 32,
                4, 64, dropout=0.0, activation=activation,
                normalize_before=normalize_before)
    x = _x(rng, 2, 7, 32)
    m = _masks(2, 7, 7, rng)["additive_padding"]
    close(t(torch.from_numpy(x), torch.from_numpy(m)),
          j(Tensor(x), Tensor(m)))
    pt.seed(0)
    jenc = jnn.TransformerEncoder(j, 3)
    jenc.eval()
    tenc = tt.TransformerEncoder(t, 3)
    tenc.eval()
    load_jax_state(tenc, jax_state(jenc))
    close(tenc(torch.from_numpy(x), torch.from_numpy(m)),
          jenc(Tensor(x), Tensor(m)))
    # the encoder's cached form: one step at a time over an empty cache
    cache = tenc.gen_cache(torch.from_numpy(x))
    out, cache = tenc(torch.from_numpy(x[:, :1]), cache=cache)
    jout, _ = jenc(Tensor(x[:, :1]), cache=jenc.gen_cache(Tensor(x)))
    close(out, jout)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_decoder_layer_matches_jax(normalize_before):
    rng = np.random.default_rng(7)
    j, t = pair(jnn.TransformerDecoderLayer, tt.TransformerDecoderLayer, 32,
                4, 64, dropout=0.0, normalize_before=normalize_before)
    tgt, mem = _x(rng, 2, 6, 32), _x(rng, 2, 8, 32)
    tmask = np.where(np.tril(np.ones((6, 6), bool)), 0.0,
                     -np.inf).astype(np.float32)
    mmask = _masks(2, 6, 8, rng)["additive_padding"]
    close(t(*map(torch.from_numpy, (tgt, mem, tmask, mmask))),
          j(*map(Tensor, (tgt, mem, tmask, mmask))))


@pytest.mark.parametrize("normalize_before", [False, True])
def test_transformer_matches_jax(normalize_before):
    rng = np.random.default_rng(8)
    kw = dict(d_model=32, nhead=4, num_encoder_layers=2,
              num_decoder_layers=2, dim_feedforward=64, dropout=0.0,
              normalize_before=normalize_before)
    pt.seed(0)
    j = jnn.Transformer(**kw)
    j.eval()
    t = tt.Transformer(device="cpu", **kw)
    t.eval()
    assert set(t.state_dict()) == set(j.state_dict())
    load_jax_state(t, jax_state(j))
    src, tgt = _x(rng, 2, 9, 32), _x(rng, 2, 6, 32)
    jmask = jnn.Transformer.generate_square_subsequent_mask(6)
    tmask = tt.Transformer.generate_square_subsequent_mask(6, device="cpu")
    np.testing.assert_array_equal(tmask.numpy(), _np(jmask))
    close(t(torch.from_numpy(src), torch.from_numpy(tgt), tgt_mask=tmask),
          j(Tensor(src), Tensor(tgt), tgt_mask=jmask))


def test_clone_layer_draws_fresh_parameters_from_the_generator():
    t = tt.Transformer(d_model=32, nhead=4, num_encoder_layers=3,
                       num_decoder_layers=2, dim_feedforward=64,
                       device="cpu")
    w = [lay.self_attn.q_proj.weight for lay in t.encoder.layers]
    assert not torch.equal(w[0], w[1]) and not torch.equal(w[1], w[2])
    assert t.encoder.layers[2]._config == t.encoder.layers[0]._config
    # seed 0 by default: the same model twice
    again = tt.Transformer(d_model=32, nhead=4, num_encoder_layers=3,
                           num_decoder_layers=2, dim_feedforward=64,
                           device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(t.parameters(), again.parameters()))
    # xavier_uniform weights, zero biases (JAX's defaults)
    lim = (6.0 / (32 + 64)) ** 0.5
    lin = t.encoder.layers[0].linear1
    assert float(lin.weight.detach().abs().max()) <= lim
    assert float(lin.bias.detach().abs().max()) == 0.0


def test_param_attr_objects_raise():
    """Weight attributes are ported: an attribute object without an
    ``initializer`` takes the default, as the JAX layer reads one
    (``xavier_uniform`` weights, zero biases), and a
    ``ParamAttr(initializer=...)`` takes effect in the port as in the
    JAX layer."""
    from paddle_tpu.nn import initializer as jinit
    from paddle_tpu_torch.nn import initializer as tinit
    m = tt.MultiHeadAttention(32, 4, weight_attr=object(),
                              bias_attr=object(), device="cpu")
    limit = np.sqrt(6.0 / (32 + 32))
    for lin in (m.q_proj, m.k_proj, m.v_proj, m.out_proj):
        w = lin.weight.detach().numpy()
        assert np.abs(w).max() <= limit and w.std() > 0.5 * limit / 2
        assert not lin.bias.detach().numpy().any()
    pt.seed(0)
    j = jnn.MultiHeadAttention(
        32, 4, weight_attr=jnn.ParamAttr(initializer=jinit.Constant(0.5)),
        bias_attr=jnn.ParamAttr(initializer=jinit.Constant(-0.25)))
    t = tt.MultiHeadAttention(
        32, 4, weight_attr=tinit.ParamAttr(initializer=tinit.Constant(0.5)),
        bias_attr=tinit.ParamAttr(initializer=tinit.Constant(-0.25)),
        device="cpu")
    want = jax_state(j)
    got = {k: v.detach().numpy() for k, v in t.state_dict().items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert float(t.q_proj.weight.detach()[0, 0]) == 0.5


# -- the folded attention path ------------------------------------------------

@pytest.fixture
def _interpret(monkeypatch):
    for mod in (jfa, jfo):
        monkeypatch.setattr(mod.pl, "pallas_call",
                            functools.partial(mod.pl.pallas_call,
                                              interpret=True))
    yield


@pytest.fixture
def _through_kernels(monkeypatch):
    """Route CPU tensors through the attention Functions (their plain
    versions run inside) outside ``plain_kernels`` and count the forward
    wrapper's calls."""
    calls = []
    real = tat.attention_fwd

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tnf, "_on_card", lambda t: not tnf.plain_mode())
    monkeypatch.setattr(tat, "attention_fwd", counted)
    return calls


def test_folded_path_at_unmasked_s256_matches_jax_folded_kernel(
        _interpret, _through_kernels):
    """An encoder layer at S=256, H=2, D=64 (H*D = 128 lanes): unmasked
    it takes the folded Function in the port and the folded Pallas
    kernel (interpret mode) in JAX; with a padding mask both take the
    plain math."""
    rng = np.random.default_rng(9)
    assert jfo.folded_attention_supported((1, 256, 2, 64), (1, 256, 2, 64),
                                          backend="tpu")
    j, t = pair(jnn.TransformerEncoderLayer, tt.TransformerEncoderLayer,
                128, 2, 256, dropout=0.0)
    x = _x(rng, 1, 256, 128)
    with jfa.force_flash_for_aot():
        want = j(Tensor(x))
    got = t(torch.from_numpy(x))
    assert len(_through_kernels) == 1
    close(got, want)
    m = _masks(1, 256, 256, rng)["additive_padding"]
    with jfa.force_flash_for_aot():
        want_m = j(Tensor(x), Tensor(m))
    got_m = t(torch.from_numpy(x), torch.from_numpy(m))
    assert len(_through_kernels) == 1  # the mask sent it to the plain math
    close(got_m, want_m)


def test_folded_path_gradients_equal_the_plain_path(_through_kernels):
    """The folded Function's backward (its plain version on the CPU)
    against autograd through the plain math, one encoder layer at
    S=256: every parameter's gradient within ``GRAD_REL`` in L2 (measured
    4.5e-7), the key bias's, which softmax cancels, within rounding size
    (``KEY_BIAS_ATOL``). Dropout in training mode takes the plain
    math."""
    rng = np.random.default_rng(10)
    t = tt.TransformerEncoderLayer(128, 2, 256, dropout=0.0, device="cpu",
                                   generator=torch.Generator()
                                   .manual_seed(0))
    x = torch.from_numpy(_x(rng, 1, 256, 128))
    w = torch.from_numpy(_x(rng, 1, 256, 128))

    def run():
        t.zero_grad()
        out = t(x)
        (out * w).sum().backward()
        return out.detach(), {n: p.grad.clone()
                              for n, p in t.named_parameters()}

    out_k, grads_k = run()
    assert len(_through_kernels) == 1
    with tnf.plain_kernels():
        out_p, grads_p = run()
    assert len(_through_kernels) == 1
    close(out_k, out_p)
    for n, g in grads_p.items():
        if n == "self_attn.k_proj.bias":
            assert float(grads_k[n].abs().max()) <= KEY_BIAS_ATOL
            continue
        rel = float((grads_k[n] - g).norm() / g.norm())
        assert rel <= GRAD_REL, (n, rel)
    t.self_attn.dropout = 0.1
    t.train()
    t(x)
    assert len(_through_kernels) == 1
