"""``ops/kernels/optimizer_update.py``: the plain version of the
``adam_update`` kernel against the JAX Adam rule, the wrapper's list
handling and checks, and ``chip_smoke.py``'s bytes bound for it.

The kernel (``csrc/adam_update.cu``) runs only on the card, where
``chip_smoke.py`` holds it bitwise to the plain version. Here the plain
version meets the JAX package's ``_apply_flat`` (``Adam._update`` with
each weight decay) on the same numpy inputs for 3 steps.

Tolerances, stated: fp32 within rtol 1e-6 / atol 1e-7 (the same
operations; the JAX bias correction's pow and XLA's division may differ
by an ulp). bf16 storage: the port rounds to bf16 after every eager op,
XLA rounds once per fused loop, so a moment lies within a few bf16 ulps
of itself (rtol 2^-5) or, where ``b1 * m`` and ``(1 - b1) * g`` cancel,
of the largest moment (atol 2^-6 of it); a parameter, which moves by
~lr a step, within one ulp of its own size (rtol 2^-7).
"""

import _torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu import optimizer as jopt

from paddle_tpu_torch.ops.kernels import optimizer_update as OU
from test_torch_attention_fwd import _chip_smoke

LR, WD = 1e-3, 0.05
SHAPES = ((7, 9), (16,), (1,), (300,))
VARIANTS = {"fp32": (np.float32, torch.float32, torch.float32),
            "bf16": (jnp.bfloat16, torch.bfloat16, torch.bfloat16),
            "bf16 params fp32 slots": (jnp.bfloat16, torch.bfloat16,
                                       torch.float32)}
DECAYS = {"none": (jopt.Adam, 0.0, OU.DECAY_NONE),
          "L2": (jopt.Adam, WD, OU.DECAY_L2),
          "decoupled": (jopt.AdamW, WD, OU.DECAY_DECOUPLED)}


def _inputs(seed, torch_dtype):
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[(0.1 * rng.standard_normal(s)).astype(np.float32)
              for s in SHAPES] for _ in range(3)]
    # the inputs as the stored dtype holds them, on both sides
    cast = (lambda a: torch.from_numpy(a).to(torch_dtype).float().numpy())
    return [cast(p) for p in params], [[cast(g) for g in gs]
                                       for gs in grads]


@pytest.mark.parametrize("decay", list(DECAYS))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_plain_version_matches_the_jax_adam_rule(variant, decay):
    jdt, pdt, sdt = VARIANTS[variant]
    jcls, wd, mode = DECAYS[decay]
    params, grads = _inputs(1, pdt)
    jo = jcls(learning_rate=LR, weight_decay=wd,
              multi_precision=sdt != pdt)
    jv = [jnp.asarray(p, jdt) for p in params]
    js = [jo._init_state(v) for v in jv]
    tp = [torch.from_numpy(p.copy()).to(pdt) for p in params]
    tm = [torch.zeros(p.shape, dtype=sdt) for p in tp]
    tv = [torch.zeros(p.shape, dtype=sdt) for p in tp]
    for step, gs in enumerate(grads, start=1):
        jv, js = jo._apply_flat(jv, [jnp.asarray(g, jdt) for g in gs], js,
                                LR, step)
        OU.adam_update(tp, [torch.from_numpy(g).to(pdt) for g in gs], tm,
                       tv, lr=LR, beta1=0.9, beta2=0.999, eps=1e-8,
                       step=step, weight_decay=wd, decay=mode)
    fp32 = variant == "fp32"
    # the moments see a bf16 rounding of their own, or of an L2 gradient
    bf16_slots = sdt == torch.bfloat16 or (pdt == torch.bfloat16
                                           and mode == OU.DECAY_L2)
    for i in range(len(SHAPES)):
        assert tp[i].dtype == pdt and tm[i].dtype == sdt
        np.testing.assert_allclose(
            tp[i].float().numpy(), np.asarray(jv[i], np.float32),
            rtol=1e-6 if fp32 else 2.0 ** -7, atol=1e-7)
        for got, slot in ((tm[i], "moment1"), (tv[i], "moment2")):
            want = np.asarray(js[i][slot], np.float32)
            if bf16_slots:
                rtol, atol = 2.0 ** -5, 2.0 ** -6 * float(np.abs(want).max())
            else:
                rtol, atol = 1e-6, 1e-12
            np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                                       atol=atol)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_one_call_over_a_list_gives_the_bits_of_one_call_a_tensor(variant):
    _, pdt, sdt = VARIANTS[variant]
    params, grads = _inputs(2, pdt)
    lists = []
    for _ in range(2):
        lists.append(([torch.from_numpy(p.copy()).to(pdt) for p in params],
                      [torch.zeros(p.shape, dtype=sdt) for p in params],
                      [torch.zeros(p.shape, dtype=sdt) for p in params]))
    for step, gs in enumerate(grads, start=1):
        g = [torch.from_numpy(x).to(pdt) for x in gs]
        hyper = dict(lr=LR, beta1=0.9, beta2=0.999, eps=1e-8, step=step,
                     weight_decay=WD, decay=OU.DECAY_DECOUPLED)
        p, m, v = lists[0]
        OU.adam_update(p, g, m, v, **hyper)
        for i, (pi, mi, vi) in enumerate(zip(*lists[1])):
            OU.adam_update([pi], [g[i]], [mi], [vi], **hyper)
    for a, b in zip(lists[0], lists[1]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert OU.adam_update.launches == 0


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """On a device other than the CPU the wrapper checks before it
    launches: CUDA tensors only, one dtype pair of ``KERNEL_DTYPES``,
    matching shapes and list lengths."""
    def meta(shape=(4,), dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    hyper = dict(lr=LR, beta1=0.9, beta2=0.999, eps=1e-8, step=1)
    with pytest.raises(ValueError, match="CUDA"):
        OU.adam_update([meta()], [meta()], [meta()], [meta()], **hyper)
    with pytest.raises(TypeError, match="not taken"):
        OU.adam_update([meta(dtype=torch.float16)], [meta()], [meta()],
                       [meta()], **hyper)
    with pytest.raises(ValueError, match="lengths"):
        OU.adam_update([meta()], [], [meta()], [meta()], **hyper)
    OU.adam_update([], [], [], [], **hyper)  # nothing to do
    assert (torch.bfloat16, torch.float32) in OU.KERNEL_DTYPES
    assert (torch.float32, torch.bfloat16) not in OU.KERNEL_DTYPES


def test_bias_corrections_are_float32():
    bc1, bc2 = OU.bias_corrections(0.9, 0.999, 3)
    assert bc1.dtype == np.float32 and bc2.dtype == np.float32
    assert bc1 == np.float32(1) - np.float32(0.9) ** np.float32(3)


def test_chip_smoke_adam_bound_counts_each_byte_once():
    """p, g, m, v read and p, m, v written: 28 bytes an element in fp32,
    14 in bf16, 22 for bf16 parameters with fp32 slots; a GPT-1.3B
    block's 50.3M fp32 elements take 0.421 ms at 3.35 TB/s."""
    cs = _chip_smoke()
    assert [cs.adam_bytes(1, p, s) for p, s in ((4, 4), (2, 2), (2, 4))] \
        == [28, 14, 22]
    n = sum(int(np.prod(s)) for s in cs.ADAM_BLOCK_SHAPES)
    assert n == 50358272
    ms, by = cs.bound_ms(cs.adam_bytes(n, 4, 4), 0.0)
    assert by == "bytes" and ms == pytest.approx(0.42090, rel=1e-4)
    assert cs.KERNEL_META["adam_update"][0] == \
        "paddle_tpu_torch/csrc/adam_update.cu"


def test_chip_smoke_train_flops_of_the_headline_step():
    """The model FLOPs MFU divides by: 3 x (24 E^2 L + 2 E V per token
    plus 4 E per visible pair and layer) at GPT-1.3B, V=32768, B=2,
    S=2048."""
    cs = _chip_smoke()
    flops = cs.train_flops(2, 2048, 24, 2048, 32768)
    per_token = 24 * 24 * 2048 ** 2 + 2 * 2048 * 32768
    attention = 2 * 24 * 4 * 2048 * (2048 * 2049 // 2)
    assert flops == 3 * (4096 * per_token + attention) == 33811190513664
