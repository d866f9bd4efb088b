"""The port's attention backward against the JAX package's.

The plain versions of the backward kernels (``attention_bwd_reference``
for the flash kernels #6-#8, ``folded_bwd_reference`` for the folded
kernel #10) and the autograd Functions around the kernels, called on
CPU tensors that require grad, are held against ``jax.vjp`` of
``flash_attention_lse`` and ``folded_attention`` on the same numpy
inputs and cotangents. The JAX kernels run as their own tests run them
on the CPU: through the Pallas interpreter. Tolerance 1e-5 in fp32:
both sides compute in fp32 on the CPU, with sums in different orders.

The tensor-core kernels (``csrc/attention_bwd.cu``) run only on the
card; their arithmetic is rehearsed by the emulation of
``tests/attention_bwd_emulation.py``: the single pass and the folded
statistics in ``test_torch_attention_bwd_single.py``, the dQ and dK/dV
passes in ``test_torch_attention_bwd_passes.py``. This file also holds
the wrappers' refusals and ``chip_smoke.py``'s readings of the build
report and of the bf16 checks.
"""

import _torch_threads  # noqa: F401

import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import folded_attention as jfo

from paddle_tpu_torch.ops.kernels import attention as tat
from paddle_tpu_torch.ops.kernels import launch_counts

TOL = 1e-5
H = 2


@pytest.fixture
def _interpret(monkeypatch):
    for mod in (jfa, jfo):
        monkeypatch.setattr(mod.pl, "pallas_call",
                            functools.partial(mod.pl.pallas_call,
                                              interpret=True))
    yield


def _t(x, grad=False):
    return torch.from_numpy(np.asarray(x).copy()).requires_grad_(grad)


def _inputs(seed, s, d, glse=True):
    """q, k, v ~ N(0, 1); the cotangents dO and g_lse ~ N(0, 0.1^2), the
    small end of what a loss hands back. (With dO ~ N(0, 1), dP = dO V^T
    reaches ~sqrt(d) and dP - delta cancels, so a rounding difference
    of the CPU GEMMs between runs can reach 5e-5 relative.)"""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((1, s, H, d)).astype(np.float32)
               for _ in range(3))
    do = (0.1 * rng.standard_normal((1, s, H, d))).astype(np.float32)
    g = ((0.1 * rng.standard_normal((1, s, H))).astype(np.float32)
         if glse else np.zeros((1, s, H), np.float32))
    return q, k, v, do, g


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=TOL, rtol=TOL)


def _jax_flash_vjp(q, k, v, do, g_lse, causal):
    def f(qq, kk, vv):
        return jfa.flash_attention_lse(qq, kk, vv, causal=causal,
                                       block_q=128, block_k=128)
    with jfa.force_flash_for_aot():
        (out, lse), vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v))
        grads = vjp((jnp.asarray(do), jnp.asarray(g_lse)))
    return out, lse, grads


def _flash_case(s, d, causal, glse):
    q, k, v, do, g = _inputs(300 + s + d + causal + 2 * glse, s, d, glse)
    tq, tk, tv, tdo = _t(q), _t(k), _t(v), _t(do)
    out, lse = tat.attention_reference(tq, tk, tv, causal=causal)
    delta = (tdo * out).sum(-1) - _t(g)
    return (q, k, v, do, g), (tq, tk, tv, tdo, lse, delta.contiguous())


# S=128 is one 128-row Q block (the fused pass, #6); S=256 is two (the
# dQ and dK/dV passes, #7 and #8)
@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("glse", [False, True])
def test_flash_backward_matches_jax_vjp(_interpret, s, d, causal, glse):
    q, k, v, do, g = _inputs(s + d + causal + 2 * glse, s, d, glse)
    jout, jlse, want = _jax_flash_vjp(q, k, v, do, g, causal)

    # the plain version, given the forward's lse and delta
    out, lse = tat.attention_reference(_t(q), _t(k), _t(v), causal=causal)
    delta = (_t(do) * out).sum(-1) - _t(g)
    _close(tat.attention_bwd_reference(_t(q), _t(k), _t(v), _t(do), lse,
                                       delta, causal=causal), want)

    # the autograd Function, both outputs differentiable; a lse that
    # takes no part in the loss gets a None cotangent (zeros)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    o, l_ = tat.flash_attention(tq, tk, tv, causal=causal, block_q=128,
                                block_k=128)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jout),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(l_.detach().numpy(), np.asarray(jlse),
                               atol=1e-4, rtol=1e-4)
    outputs, cots = ((o, l_), (_t(do), _t(g))) if glse else \
        ((o,), (_t(do),))
    _close(torch.autograd.grad(outputs, (tq, tk, tv), cots), want)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_folded_backward_matches_jax_vjp(_interpret, d, causal):
    q, k, v, do, _ = _inputs(d + causal, 128, d)
    with jfa.force_flash_for_aot():
        _, vjp = jax.vjp(functools.partial(jfo.folded_attention,
                                           causal=causal),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = vjp(jnp.asarray(do))
    _close(tat.folded_bwd_reference(_t(q), _t(k), _t(v), _t(do),
                                    causal=causal), want)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = tat.folded_attention(tq, tk, tv, causal=causal)
    _close(torch.autograd.grad(out, (tq, tk, tv), _t(do)), want)


def test_flash_lse_alone_backpropagates():
    """Only lse in the loss: the out cotangent is None and counts as
    zeros, so the gradient is that of logsumexp alone."""
    q, k, v, _, g = _inputs(11, 256, 64)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    _, lse = tat.flash_attention(tq, tk, tv, causal=True, block_q=128,
                                 block_k=128)
    got = torch.autograd.grad((lse * _t(g)).sum(), (tq, tk, tv))
    rq, rk, rv = _t(q, True), _t(k, True), _t(v, True)
    s = torch.einsum("bqhd,bkhd->bhqk", rq, rk) / 8.0
    s = s.masked_fill(~torch.ones(256, 256, dtype=torch.bool).tril(),
                      float("-inf"))
    ref = torch.logsumexp(s, -1).transpose(1, 2)
    want = torch.autograd.grad((ref * _t(g)).sum(), (rq, rk, rv),
                               allow_unused=True)
    _close(got[:2], [w.numpy() for w in want[:2]])
    assert float(got[2].abs().max()) == 0.0


def test_sdpa_training_reaches_the_autograd_functions(monkeypatch):
    """Under the kernel gates the training branch of
    ``scaled_dot_product_attention`` goes through the Functions (here
    their plain versions, CPU tensors) and differentiates into q, k, v
    of a fused QKV projection."""
    from paddle_tpu_torch.ops import nn_functional as tnf
    used = []

    def record(name, fn, *args, **kw):
        used.append(name)
        return fn(*args, **kw)

    for name in ("flash_attention", "folded_attention"):
        monkeypatch.setattr(tnf, name, functools.partial(
            record, name, getattr(tnf, name)))
    monkeypatch.setattr(tnf, "_on_card", lambda t: True)
    for s in (256, 512):
        qkv = torch.randn(1, s, 3, 2, 128, requires_grad=True)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        out = tnf.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               use_flash=True)
        assert type(out.grad_fn).__name__.endswith(
            "AttentionFunctionBackward")
        out.sum().backward()
        assert qkv.grad is not None and float(qkv.grad.abs().sum()) > 0
    assert used == ["folded_attention", "flash_attention"]


def test_backward_wrappers_on_cpu_are_plain_and_refuse_other_devices():
    q, k, v, do, g = _inputs(12, 128, 64)
    out, lse = tat.attention_reference(_t(q), _t(k), _t(v), causal=True)
    delta = ((_t(do) * out).sum(-1) - _t(g)).contiguous()
    args = (_t(q), _t(k), _t(v), _t(do), lse, delta, True)
    ref = tat.attention_bwd_reference(*args)
    assert all(torch.equal(a, b)
               for a, b in zip(tat.attention_bwd_fused(*args), ref))
    assert torch.equal(tat.attention_bwd_dq(*args), ref[0])
    assert all(torch.equal(a, b)
               for a, b in zip(tat.attention_bwd_dkv(*args), ref[1:]))
    fref = tat.folded_bwd_reference(*args[:4], True)
    assert all(torch.equal(a, b) for a, b in
               zip(tat.folded_attention_bwd(*args[:4], True), fref))
    counts = launch_counts()
    assert all(counts[n] == 0 for n in (
        "attention_bwd_fused", "attention_bwd_dq", "attention_bwd_dkv",
        "folded_attention_bwd"))
    meta = [torch.empty(1, 128, 2, 64, device="meta") for _ in range(4)]
    stats = torch.empty(1, 128, 2, device="meta")
    for fn in (tat.attention_bwd_fused, tat.attention_bwd_dq,
               tat.attention_bwd_dkv):
        with pytest.raises(ValueError, match="meta"):
            fn(*meta, stats, stats, True)
    with pytest.raises(ValueError, match="meta"):
        tat.folded_attention_bwd(*meta, True)


@pytest.mark.parametrize("fn", [tat.attention_bwd_dq, tat.attention_bwd_dkv])
@pytest.mark.parametrize("bad", ["q", "k", "v", "dO"])
def test_dq_and_dkv_refuse_misaligned_operands(monkeypatch, fn, bad):
    """The passes stage rows with 16-byte copies: a q, k, v or dO whose
    rows are not whole 16-byte steps (or that starts off a 16-byte
    boundary) is refused before any launch."""
    monkeypatch.setattr(tat, "_check_operands",
                        lambda name, q, k, v, dims, extra=(): q.device)
    def operand(name, offset):
        if name != bad:
            return torch.empty(1, 128, 2, 64, device="meta")
        if offset:  # starts 4 bytes in
            return torch.empty(1 + 128 * 2 * 64, device="meta")[1:].view(
                1, 128, 2, 64)
        return torch.empty(1, 128, 2, 66, device="meta")[..., :64]
    stats = torch.empty(1, 128, 2, device="meta")
    for offset in (False, True):
        ops = [operand(n, offset) for n in ("q", "k", "v", "dO")]
        with pytest.raises(ValueError, match=f"{bad} needs a 16-byte"):
            fn(*ops, stats, stats, True)


# -- chip_smoke.py's reading of the build's ptxas report ----------------------

def _ptxas_lines(kernel, dtype, d, regs, spill=0):
    """``ptxas -v``'s lines for one instantiation, as nvcc prints them."""
    arg = {"fp32": "f", "bf16": "13__nv_bfloat16", "fp16": "6__half"}[dtype]
    name = (f"_ZN49_GLOBAL__N__52f9eb2c_16_attention_bwd_cu_ccd79dfe"
            f"{len(kernel)}{kernel}I{arg}Li{d}EEEvPKT_")
    return (f"ptxas info    : Compiling entry function '{name}' for "
            f"'sm_90a'\nptxas info    : Function properties for {name}\n"
            f"    {2 * spill} bytes stack frame, {spill} bytes spill "
            f"stores, {spill} bytes spill loads\nptxas info    : Used "
            f"{regs} registers, used 1 barriers, 221184 bytes smem\n")


def _served(spill_at=None, skip=None):
    """The report of the served instantiations of the backward's
    tensor-core kernels (six each: fp32, bf16, fp16 x D 64, 128), one of
    them spilling 8 bytes (``spill_at``) or left out (``skip``)."""
    from test_torch_attention_fwd import _chip_smoke
    cs = _chip_smoke()
    return "".join(
        _ptxas_lines(k, dt, d, 200 + d // 64,
                     spill=8 if (k, dt, d) == spill_at else 0)
        for k in cs.BWD_TC_KERNELS
        for dt in cs.BWD_DTYPES for d in (64, 128)
        if (k, dt, d) != skip)


def test_ptxas_report_reads_registers_and_spills_per_kernel():
    from test_torch_attention_fwd import _chip_smoke
    cs = _chip_smoke()
    usage = cs.ptxas_usage(_served())
    assert cs.BWD_DTYPES == ("fp32", "bf16", "fp16")
    assert len(usage) == 6 * len(cs.BWD_TC_KERNELS) == 24
    assert all(u == {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                     "registers": u["registers"]} for u in usage.values())
    assert sorted({u["registers"] for u in usage.values()}) == [201, 202]


def test_chip_smoke_refuses_a_spilling_or_missing_single_pass_kernel():
    from test_torch_attention_fwd import _chip_smoke
    cs = _chip_smoke()
    rows = cs.bwd_ptxas(cs.ptxas_usage(_served()))
    assert sorted(rows) == sorted(
        f"{k} {dt} D={d}" for k in cs.BWD_TC_KERNELS
        for dt in ("fp32", "bf16", "fp16") for d in (64, 128))
    for kernel in cs.BWD_TC_KERNELS:
        spilling = _served((kernel, "fp32", 128))
        with pytest.raises(AssertionError, match="spills"):
            cs.bwd_ptxas(cs.ptxas_usage(spilling))
        for dt in ("bf16", "fp16"):
            missing = _served(skip=(kernel, dt, 64))
            with pytest.raises(AssertionError, match="no lines"):
                cs.bwd_ptxas(cs.ptxas_usage(missing))


def test_chip_smoke_records_a_failed_closeness_check_and_goes_on(capsys):
    from test_torch_attention_fwd import _chip_smoke
    cs = _chip_smoke()
    want = torch.tensor([1.0, 2.0, 4.0])
    assert cs.check_close("near", want + 1e-6, want, 1e-4) < 1e-4
    assert cs.FAILED_CHECKS == []
    got = torch.tensor([1.0, 2.0, 4.0078125])
    assert cs.check_close("one ulp apart", got, want, 2.5e-3, 0.0) == \
        pytest.approx(0.0078125)
    assert cs.FAILED_CHECKS == [
        "one ulp apart: max abs err 0.00781 over atol 0.0025 rtol 0.0"]
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["check"] == "one ulp apart" and line["ok"] is False


def test_chip_smoke_bf16_apart_counts_the_elements_that_differ():
    from test_torch_attention_fwd import _chip_smoke
    cs = _chip_smoke()
    want = torch.tensor([1.0, 2.0, 4.0, 0.5], dtype=torch.bfloat16)
    got = torch.tensor([1.0, 2.0, 4.03125, 0.5], dtype=torch.bfloat16)
    assert cs.bf16_apart(got, want) == [0.03125, 0.25]
    assert cs.bf16_apart(want, want) == [0.0, 0.0]


# -- chip_smoke.py's bf16 check of the single pass ---------------------------

def _card_case(cs, s, d, seed):
    """bf16 inputs as chip_smoke's backward phase makes them (B=2, H=16,
    causal, no lse cotangent), from a CPU generator."""
    gen = torch.Generator().manual_seed(seed)
    return cs._bwd_inputs(torch, gen, torch.device("cpu"), 2, s,
                          torch.bfloat16, True, False, D=d)


def _f64_grads(name, q, k, v, do, lse, delta):
    """The causal gradient in f64 from the same bf16 inputs: the value
    that every f32 sum order approximates."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    n = q.shape[1]
    s = s.masked_fill(torch.arange(n)[None, :] > torch.arange(n)[:, None],
                      -math.inf)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    if name == "folded_attention_bwd":
        p = torch.softmax(s, dim=-1)
        dl = (p * dp).sum(dim=-1, keepdim=True)
    else:
        p = torch.exp(s - lse.double().transpose(1, 2)[..., None])
        dl = delta.double().transpose(1, 2)[..., None]
    ds = p * (dp - dl) * scale
    return {"dq": torch.einsum("bhqk,bkhd->bqhd", ds, k),
            "dk": torch.einsum("bhqk,bqhd->bkhd", ds, q),
            "dv": torch.einsum("bhqk,bqhd->bkhd", p, do)}


@pytest.mark.parametrize("name,s,seed", [("attention_bwd_fused", 512, 1),
                                         ("folded_attention_bwd", 256, 2)])
def test_bf16_limit_after_rounding_refuses_the_exact_gradient(name, s, seed):
    """Why chip_smoke holds the single pass's bf16 outputs to BF16_ATOL
    before the rounding: the exact gradient, rounded to bf16, lies one
    ulp from the plain version's rounded f32 result in some element
    larger than 0.5, beyond the limit; taken before the rounding, the
    limit passes it."""
    from test_torch_attention_fwd import _chip_smoke
    cs = _chip_smoke()
    ins = _card_case(cs, s, 128, seed)
    _, plain32 = cs._bwd_call(name, *(t.float() for t in ins), True)
    exact = _f64_grads(name, *ins)
    tol = cs.BF16_ATOL[name]
    after = [cs.max_err(exact[key].to(torch.bfloat16),
                        plain32[key].to(torch.bfloat16)) for key in exact]
    assert max(after) > tol
    assert all(cs.rounded_from(exact[key].to(torch.bfloat16), plain32[key],
                               tol) for key in exact)


@pytest.mark.parametrize("name,s,seed", [
    ("attention_bwd_fused", 512, 1), ("folded_attention_bwd", 256, 2),
    ("attention_bwd_fused", 200, 3), ("folded_attention_bwd", 200, 3),
    ("attention_bwd_dq", 512, 1), ("attention_bwd_dkv", 512, 1),
    ("attention_bwd_dq", 200, 3), ("attention_bwd_dkv", 200, 3)])
def test_bf16_check_before_rounding_takes_two_term_p_refuses_one_term(
        name, s, seed):
    """The check tells the kernel's design (P and dS as two bf16 terms)
    from one bf16 term on the card check's causal shapes; each holds
    only the gradients the kernel returns."""
    from test_torch_attention_fwd import _chip_smoke
    cs = _chip_smoke()
    ins = _card_case(cs, s, 128, seed)
    _, plain32 = cs._bwd_call(name, *(t.float() for t in ins), True)
    tol = cs.BF16_ATOL[name]
    two = cs.bf16_terms_bwd(torch, name, 2, *ins, True)
    one = cs.bf16_terms_bwd(torch, name, 1, *ins, True)
    assert set(two) == set(one) == set(plain32) == set(cs.BWD_OUTPUTS[name])
    assert all(cs.rounded_from(two[key], plain32[key], tol) for key in two)
    assert not all(cs.rounded_from(one[key], plain32[key], tol)
                   for key in one)


def test_rounded_from_allows_the_other_rounding_only_near_a_midpoint(capsys):
    from test_torch_attention_fwd import _chip_smoke
    cs = _chip_smoke()
    bf = torch.bfloat16
    # 1.0039 lies 2.6e-5 below the midpoint of 1 and 1.0078125
    near = torch.tensor([1.0039, 3.0])
    assert cs.rounded_from(torch.tensor([1.0, 3.0], dtype=bf), near, 2.5e-3)
    assert cs.rounded_from(torch.tensor([1.0078125, 3.0], dtype=bf), near,
                           2.5e-3)
    assert not cs.rounded_from(torch.tensor([1.015625, 3.0], dtype=bf),
                               near, 2.5e-3)
    assert not cs.rounded_from(torch.tensor([1.0, 3.015625], dtype=bf),
                               near, 2.5e-3)
    assert cs.check_rounded_from("far", torch.tensor([1.0, 3.015625],
                                                     dtype=bf), near,
                                 2.5e-3) == pytest.approx(0.015625)
    assert len(cs.FAILED_CHECKS) == 1 and cs.FAILED_CHECKS[0].startswith(
        "far: not the rounding of a value within 0.0025")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["check"] == "far" and line["before_rounding"] is True
