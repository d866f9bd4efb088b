"""The forward kernels as registered ops, on the CPU.

``paddle_tpu_torch::attention_fwd`` (TPU #4 / #5 / #9) and
``paddle_tpu_torch::fused_bottleneck`` (#11) are ops registered through
``torch.library``: ``opcheck`` holds their schema, fake implementation
and dispatch; the first call imports no ``torch._dynamo``; a module
calling each wrapper exports on the CPU with the op
node in its graph, survives ``torch.export.save`` / ``load``, and the
loaded program's output equals the plain version bitwise (the CPU
body is the plain version, so the tolerance is 0; measured 0). Traced
on fake CUDA tensors (no card here) the wrappers record the op with
the fake implementation, and the ``ctypes`` kernels (the backward
kernels #6-#8, #10 and the engine kernels #1-#3, ``adam_update``)
refuse to be traced. ResNet's fused pack is computed inside the graph
while exporting and never stored on the module.
"""

import _torch_threads  # noqa: F401

import io
import os
import subprocess
import sys

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import attention as tat
from paddle_tpu_torch.ops.kernels import fused_conv_block as FC
from paddle_tpu_torch.ops.kernels import fused_sample as tfs
from paddle_tpu_torch.ops.kernels import optimizer_update as tou
from paddle_tpu_torch.ops.kernels import paged_attention as tpa

ATTN_OP = torch.ops.paddle_tpu_torch.attention_fwd.default
FB_OP = torch.ops.paddle_tpu_torch.fused_bottleneck.default


class _Call(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _export(fn, *args):
    with torch.no_grad():
        return torch.export.export(_Call(fn), tuple(args), strict=False)


def _round_trip(ep):
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    buf.seek(0)
    return torch.export.load(buf)


def _targets(ep):
    return [n.target for n in ep.graph.nodes if n.op == "call_function"]


def _qkv(seed, b=1, s=128, h=2, d=64, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, s, h, d, generator=g).to(dtype) for _ in range(3)]


def _block(seed, n=1, h=5, w=6, c=32, m=8):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, h, w, c, generator=g)
    params = [torch.randn(c, m, generator=g), torch.randn(1, m, generator=g),
              torch.randn(9 * m, m, generator=g),
              torch.randn(1, m, generator=g),
              torch.randn(m, c, generator=g), torch.randn(1, c, generator=g)]
    return x, params


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("return_lse", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck_attention_fwd(causal, return_lse, dtype):
    q, k, v = _qkv(0, dtype=dtype)
    torch.library.opcheck(ATTN_OP, (q, k, v, causal, 0.125, return_lse))


@pytest.mark.parametrize("shape", [(1, 5, 6, 32, 8), (2, 4, 4, 20, 5)])
def test_opcheck_fused_bottleneck(shape):
    x, params = _block(1, *shape)
    torch.library.opcheck(FB_OP, (x, *params))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("return_lse", [True, False])
def test_attention_wrapper_exports_the_op_and_loads(causal, return_lse):
    q, k, v = _qkv(2)

    def fn(q, k, v):
        out, lse = tat.attention_fwd(q, k, v, causal=causal,
                                     return_lse=return_lse)
        return (out, lse) if return_lse else (out,)

    ep = _export(fn, q, k, v)
    assert _targets(ep).count(ATTN_OP) == 1
    loaded = _round_trip(ep)
    assert _targets(loaded).count(ATTN_OP) == 1
    q2, k2, v2 = _qkv(3)
    got = loaded.module()(q2, k2, v2)
    want_out, want_lse = tat.attention_reference(q2, k2, v2, causal=causal)
    assert torch.equal(got[0], want_out)
    if return_lse:
        assert torch.equal(got[1], want_lse)
    # the wrapper hands None back for return_lse=False (the op gives an
    # empty lse)
    out, lse = tat.attention_fwd(q2, k2, v2, causal=causal,
                                 return_lse=return_lse)
    assert torch.equal(out, want_out)
    assert (lse is None) == (not return_lse)


def test_attention_wrapper_exports_strided_views():
    """Slices of a fused [B, S, 3, H, D] projection go in as views."""
    g = torch.Generator().manual_seed(4)
    qkv = torch.randn(1, 128, 3, 2, 64, generator=g)

    def fn(qkv):
        return tat.attention_fwd(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                                 return_lse=False)[0]

    loaded = _round_trip(_export(fn, qkv)).module()
    qkv2 = torch.randn(1, 128, 3, 2, 64, generator=g)
    want, _ = tat.attention_reference(qkv2[:, :, 0], qkv2[:, :, 1],
                                      qkv2[:, :, 2])
    assert torch.equal(loaded(qkv2), want)


def test_fused_bottleneck_wrapper_exports_the_op_and_loads():
    x, params = _block(5)

    def fn(x, *p):
        return FC.fused_bottleneck_eval(x, *p)

    ep = _export(fn, x, *params)
    assert _targets(ep).count(FB_OP) == 1
    loaded = _round_trip(ep)
    x2, params2 = _block(6)
    got = loaded.module()(x2, *params2)
    assert torch.equal(got, FC.fused_bottleneck_reference(x2, *params2))


def test_first_call_imports_no_dynamo():
    """A registered op's first call costs no ``torch._dynamo`` import
    (``torch.library.custom_op`` wraps its kernels in
    ``torch._disable_dynamo``, whose first call imports it: 2.3 s on an
    8-core x86 CPU, in every process that launches a kernel)."""
    code = ("import sys, torch\n"
            "from paddle_tpu_torch.ops.kernels import attention as A\n"
            "from paddle_tpu_torch.ops.kernels import fused_conv_block as FC\n"
            "q = torch.randn(1, 128, 2, 64)\n"
            "A.attention_fwd(q, q, q)\n"
            "x = torch.randn(1, 5, 6, 32)\n"
            "FC.fused_bottleneck_eval(x, torch.randn(32, 8),"
            " torch.zeros(1, 8), torch.randn(72, 8), torch.zeros(1, 8),"
            " torch.randn(8, 32), torch.zeros(1, 32))\n"
            "assert 'torch._dynamo' not in sys.modules\n"
            "print('no dynamo')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=repo,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "no dynamo" in r.stdout


def test_cpu_calls_count_no_launch():
    kernels.reset_launch_counts()
    q, k, v = _qkv(7)
    tat.attention_fwd(q, k, v)
    x, params = _block(7)
    FC.fused_bottleneck_eval(x, *params)
    assert kernels.launch_counts()["attention_fwd"] == 0
    assert kernels.launch_counts()["fused_bottleneck"] == 0


def _fake_cuda(*specs):
    """Fake CUDA tensors, all of one fake mode: each spec a shape (fp32)
    or ``(shape, dtype)``."""
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        return [torch.empty(s[0], dtype=s[1], device="cuda")
                if isinstance(s[-1], torch.dtype) else
                torch.empty(s, device="cuda") for s in specs]


def test_fake_cuda_trace_records_the_registered_ops():
    """On (fake) CUDA tensors the wrappers reach the ops' fake
    implementations, so a program traced for the card holds the kernel
    nodes, never the plain math."""
    q, k, v = _fake_cuda(*[(1, 256, 2, 64)] * 3)
    ep = _export(lambda q, k, v: tat.attention_fwd(q, k, v)[0], q, k, v)
    assert _targets(ep).count(ATTN_OP) == 1
    assert not any("einsum" in str(t) or "softmax" in str(t)
                   for t in _targets(ep))
    c, m = 256, 64
    x, w1, b1, w2, b2, w3, b3 = _fake_cuda(
        (1, 28, 28, c), (c, m), (1, m), (9 * m, m), (1, m), (m, c), (1, c))
    ep = _export(FC.fused_bottleneck_eval, x, w1, b1, w2, b2, w3, b3)
    assert _targets(ep) == [FB_OP]


def test_fake_cuda_encoder_trace_holds_one_kernel_a_layer():
    """A BERT encoder at an unmasked S=256 (the folded gate) traced on
    fake CUDA weights: one ``attention_fwd`` node a layer."""
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.static.program import _Traced
    cfg = bert.BertConfig(vocab_size=64, hidden_size=128,
                          num_hidden_layers=2, num_attention_heads=2,
                          intermediate_size=256, max_position_embeddings=256,
                          hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0)
    enc = bert.BertModel(cfg, device="cpu").encoder
    enc.eval()
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        params = {n: torch.empty(p.shape, device="cuda")
                  for n, p in enc.named_parameters()}
        x = torch.empty(1, 256, 128, device="cuda")

    def fn(p, b, x):
        return torch.func.functional_call(enc, (p, b), (x,))

    with torch.no_grad():
        ep = torch.export.export(_Traced(fn), (params, {}, x), strict=False)
    assert _targets(ep).count(ATTN_OP) == cfg.num_hidden_layers


def _raises_on_trace(fn, *args):
    with pytest.raises(RuntimeError, match="cannot be exported"):
        _export(fn, *args)


@pytest.mark.parametrize("name", ["attention_bwd_dq", "attention_bwd_dkv",
                                  "attention_bwd_fused"])
def test_export_through_a_backward_kernel_raises(name):
    q, k, v, do, lse, delta = _fake_cuda(*[(1, 128, 2, 64)] * 4,
                                         (1, 128, 2), (1, 128, 2))
    _raises_on_trace(getattr(tat, name), q, k, v, do, lse, delta)


def test_export_through_the_folded_backward_raises():
    q, k, v, do = _fake_cuda(*[(1, 128, 2, 64)] * 4)
    _raises_on_trace(tat.folded_attention_bwd, q, k, v, do)


def test_export_through_the_engine_kernels_raises():
    q, kp, vp, table, lens = _fake_cuda(
        (2, 2, 64), (5, 8, 2, 64), (5, 8, 2, 64), ((2, 2), torch.int32),
        ((2,), torch.int32))
    _raises_on_trace(tpa.paged_decode, q, kp, vp, table, lens)
    ctx, w = _fake_cuda((2, 128), (128, 128))
    _raises_on_trace(tpa.decode_out_proj, ctx, w)
    h, wv = _fake_cuda((2, 128), (1000, 128))
    _raises_on_trace(tfs.fused_argmax, h, wv)


def test_adam_update_refuses_fake_tensors():
    p, g, m, v = _fake_cuda(*[(8,)] * 4)
    with pytest.raises(RuntimeError, match="cannot be exported"):
        tou.adam_update([p], [g], [m], [v], lr=1e-3, beta1=0.9,
                        beta2=0.999, eps=1e-8, step=1)


def test_the_backward_refuses_fake_tensors_outside_export():
    q, k, v, do, lse, delta = _fake_cuda(*[(1, 128, 2, 64)] * 4,
                                         (1, 128, 2), (1, 128, 2))
    with pytest.raises(RuntimeError, match="no registered op"):
        tat.attention_bwd_dq(q, k, v, do, lse, delta)


@pytest.fixture
def _fused_on_cpu(monkeypatch):
    """The fused gate admitting CPU tensors (the wrapper then runs the
    op's plain CPU body), opted in."""
    monkeypatch.setattr(FC, "_device_admits", lambda t: True)
    FC.enable_fused_conv_eval(True)
    yield
    FC.enable_fused_conv_eval(False)


def _packs(model):
    return [m._fused_pack for m in model.modules()
            if hasattr(m, "_fused_pack")]


def test_resnet_pack_is_not_cached_during_export(_fused_on_cpu):
    """ResNet-50 NHWC at 224x224 in eval: the five fused blocks' packs
    are computed inside the graph (five op nodes, the BN folds among the
    graph's ops) and none is stored on the module, even over a pack an
    eager call cached before; the loaded program equals the eager
    forward bitwise."""
    from paddle_tpu_torch.vision.models import resnet50
    model = resnet50(data_format="NHWC", device="cpu")
    model.eval()
    x = torch.randn(1, 3, 224, 224, generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        want = model(x)
    cached = [p for p in _packs(model) if p is not None]
    assert len(cached) == 5
    for blk in model.modules():
        if hasattr(blk, "_fused_pack"):
            blk._fused_pack = None
    ep = _export(model, x)
    assert _targets(ep).count(FB_OP) == 5
    assert all(p is None for p in _packs(model))
    # each fold reads the BN's variance through a sqrt in the graph
    assert _targets(ep).count(torch.ops.aten.sqrt.default) >= 15
    got = _round_trip(ep).module()(x)
    assert torch.equal(got, want)
