#!/usr/bin/env python3
"""Drive the PyTorch port (``paddle_tpu_torch``) on one NVIDIA GPU.

Phases, in order; each prints one JSON line. A closeness check that
fails prints its own line and the script goes on, so one disagreement
hides no later phase; after the last phase the failed checks are
listed and the script exits 1 without its result lines. Any other
failure exits non-zero at once:

1. device  — ``torch.cuda.is_available()``, the card's name and power
   limit from nvidia-smi, the torch / CUDA versions.
2. build   — the CUDA kernels from ``paddle_tpu_torch/csrc`` with
   ``nvcc`` (one process per source, started together); ``ptxas -v``
   prints every kernel's registers, spills and shared memory to stderr,
   and the build line carries those of the backward's tensor-core
   kernels and of the fused bottleneck, whose served instantiations must
   not spill.
3. kernels — each kernel against its plain PyTorch version on the card
   at the serving, training and ResNet paths' shapes, in fp32 and bf16,
   with its tolerance, each check on inputs from its own generator
   (paged_decode also against its split emulation, and bit for bit
   alone against batched and against NaN where it must not read; the
   fused bottleneck also against the emulation of its tiles, at the
   ResNet-50 shapes and at N=1 blocks of a 896x896 input; adam_update,
   the port's own kernel, bitwise against the eager chain it replaced
   over 3 steps in each storage variant and decay, and one call over a
   list bitwise against one call a tensor); its
   median time over 20 launches (CUDA events, L2 flushed and a device
   spin queued before each launch, so the host's work stays out of the
   window), the plain version's, one PyTorch yardstick call's, and the
   least time the card could take: the larger of the bytes at 3.35 TB/s
   and the products on the tensor cores (fp32 as 3xTF32, three TF32
   products at 495 TFLOP/s; bf16 at 989 TFLOP/s).
4. engine  — GPT-1.3B (seed-0 random weights, fp32) through the paged
   continuous-batching engine: the kernel path against the plain path
   on prefill and decode, then 8 requests whose prompts span every
   prefill bucket, with the serving kernels' launch counts read from
   that run; then the engine's other two kernel paths
   (``fused_step=False`` and ``kv_int8``), each against its plain run.
5. server  — the newline-JSON server on localhost with the same model:
   4 generate requests (2 streaming), health, stats, drain, leak_check.
6. train   — GPT-1.3B training (fp32, dropout 0, ``AdamW(1e-4)``):
   one forward+backward at full depth, B=2, S=2048, through the kernels
   against the plain versions (loss and every parameter's gradient);
   ``TrainStep.multi_step`` over 6 steps on a repeated batch (losses,
   ms per step, tokens/s, peak memory, the backward kernels' launch
   counts, ``adam_update`` among them), one step repeated bitwise from
   one state and once more under ``fuse_optimizer`` (the same bits, one
   ``adam_update`` launch a dtype group); then steps at S=512 and S=256
   and with remat + chunked loss, with and without
   ``remat_save_attention`` (4 layers) against their plain steps, each
   then timed over 5 steps; then the three remat settings' gradients
   (saved attention bitwise remat's), forward launches and memory.
6b. train_bf16 — the JAX headline step (``bench.py:119-138``) at full
   depth: GPT-1.3B, V=32768, the bf16 recipe, bf16 Adam slots, B=2,
   S=2048: one forward+backward against the plain path within limits
   derived from bf16's unit roundoff, ``multi_step`` over 6 steps (ms,
   tokens/s, peak memory, MFU against 989 TFLOP/s), a bitwise repeat, a
   ``fuse_optimizer`` step and a profiled step.
7. resnet  — ResNet-50 eval inference (NHWC, 224x224, N=128, fp32,
   seed-0 weights, seeded BN statistics) on the fused-bottleneck kernel
   path, the plain path and the ``fuse_conv_bn`` path: logits against
   the plain path, 5 kernel launches per forward, ms per forward,
   imgs/s, peak memory, N=1 latency, and a profiled forward of the
   kernel and plain paths.

Then, if no check failed, a ``kernels`` line, the nvidia-smi line, and
last ``{"ok": true, "device": {...}}``.

Run: ``python3 chip_smoke.py`` from the repository root, on a machine
with one CUDA GPU and ``nvcc``. It takes no arguments.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
TF32_FLOPS = 495e12         # dense TF32 on the tensor cores
BF16_FLOPS = 989e12         # dense bf16 on the tensor cores
# route of a function's products -> (flops each costs, peak, bound_by):
# an fp32 product to fp32 accuracy on the tensor cores is three TF32
# products (3xTF32: hi*hi + hi*lo + lo*hi)
PRODUCT_ROUTES = {"fp32": (3.0, TF32_FLOPS, "3xtf32"),
                  "bf16": (1.0, BF16_FLOPS, "bf16")}

# tolerances, stated: fp32 sums run in another order in the kernel than
# in the plain version (atol/rtol 1e-4); argmax must be index-exact;
# the whole model's hidden states and logits within 1e-3 relative
ATTN_TOL = 1e-4
PAGED_TOL = 1e-4
PROJ_TOL = 1e-4
BWD_TOL = 1e-4
MODEL_REL_TOL = 1e-3
# training, kernel path against plain path: the loss within 1e-5
# relative, every parameter's gradient within 1e-3 relative in L2 norm
LOSS_REL_TOL = 1e-5
GRAD_REL_TOL = 1e-3
TRAIN_LR = 1e-4
# bf16 storage (f32 accumulation), absolute: about 2.5x the largest
# error an H100 showed on seeded inputs (paged_decode 7.6e-6,
# decode_out_proj 3.9e-3, attention_fwd 2.0e-3, attention_bwd_fused
# 9.8e-4, folded_attention_bwd 2.0e-3); the outputs are rounded to bf16
# from f32 sums taken in another order. The dQ and dK/dV passes take the
# limit of the folded kernel, which computes the same products on the
# same S=512 inputs. paged_decode's 2e-5 is below one bf16 ulp
# at its outputs' size, so its limit is at least BF16_ULPS ulps of the
# largest plain output (``bf16_limit``); so is fused_bottleneck's, whose
# output is rounded to bf16 once more after the residual
BF16_ULPS = 2
BF16_ATOL = {"paged_decode": 2e-5, "decode_out_proj": 1e-2,
             "attention_fwd": 5e-3,
             "attention_bwd_fused": 2.5e-3, "attention_bwd_dq": 5e-3,
             "attention_bwd_dkv": 5e-3, "folded_attention_bwd": 5e-3}
# The tensor-core kernels' bf16 outputs take their BF16_ATOL before the
# rounding (``check_rounded_from``): each must be the bf16 rounding of a
# value within the limit of the plain version's f32 result. Held after
# the rounding, a limit below one bf16 ulp of the larger outputs passes
# only a sum in the plain version's own order: the exact (f64) result
# rounded to bf16 misses it (tests/test_torch_attention_bwd.py, and
# tests/test_torch_attention_fwd.py for the forward, whose 5e-3 is below
# one ulp at |out| >= 1), and a tensor-core sum has another order. A
# plain emulation of one-term bf16 P (and dS) must fail the check in at
# least one case of each kernel (``bf16_terms_fwd``, ``bf16_terms_bwd``).
BF16_BEFORE_ROUNDING = ("attention_fwd", "attention_bwd_fused",
                        "folded_attention_bwd", "attention_bwd_dq",
                        "attention_bwd_dkv")

# (kernel, source, TPU kernel it replaces)
KERNEL_META = {
    "paged_decode": ("paddle_tpu_torch/csrc/paged_decode.cu",
                     "paddle_tpu/ops/pallas/paged_attention.py:227"),
    "decode_out_proj": ("paddle_tpu_torch/csrc/decode_out_proj.cu",
                        "paddle_tpu/ops/pallas/paged_attention.py:287"),
    "fused_argmax": ("paddle_tpu_torch/csrc/fused_argmax.cu",
                     "paddle_tpu/ops/pallas/fused_sample.py:241"),
    "attention_fwd": ("paddle_tpu_torch/csrc/attention_fwd.cu",
                      "paddle_tpu/ops/pallas/flash_attention.py:414"),
    "attention_bwd_fused": ("paddle_tpu_torch/csrc/attention_bwd.cu",
                            "paddle_tpu/ops/pallas/flash_attention.py:462"),
    "attention_bwd_dq": ("paddle_tpu_torch/csrc/attention_bwd.cu",
                         "paddle_tpu/ops/pallas/flash_attention.py:496"),
    "attention_bwd_dkv": ("paddle_tpu_torch/csrc/attention_bwd.cu",
                          "paddle_tpu/ops/pallas/flash_attention.py:515"),
    "folded_attention_bwd": ("paddle_tpu_torch/csrc/attention_bwd.cu",
                             "paddle_tpu/ops/pallas/folded_attention.py:176"),
    "fused_bottleneck": ("paddle_tpu_torch/csrc/fused_bottleneck.cu",
                         "paddle_tpu/ops/pallas/fused_conv_block.py:143"),
    # the port's own kernel: no TPU kernel; it replaces the JAX Adam
    # rule that XLA fuses into the jitted step
    "adam_update": ("paddle_tpu_torch/csrc/adam_update.cu",
                    "paddle_tpu/optimizer/optimizer.py:420"),
}
# the kernels each main path launches; their counts are read from it
SERVING_KERNELS = ("paged_decode", "decode_out_proj", "fused_argmax",
                   "attention_fwd")
TRAINING_KERNELS = ("attention_bwd_fused", "attention_bwd_dq",
                    "attention_bwd_dkv", "folded_attention_bwd")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, flops: float, dtype: str = "fp32"):
    """The least time the card could take: ``(ms, bound_by)``, the larger
    of ``nbytes`` at the memory rate and ``flops`` of ``dtype`` products
    on the tensor cores (``PRODUCT_ROUTES``)."""
    cost, peak, route = PRODUCT_ROUTES[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = cost * flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, route)


def attention_fwd_cost(B, S, H, D, causal, itemsize=4):
    """(bytes, flops) of one attention forward at [B, S, H, D]: q, k, v
    read and out written once, the f32 lse written; 2 flops per
    multiply-add of QK^T and PV over the visible (query, key) pairs."""
    pairs = S * (S + 1) // 2 if causal else S * S
    return (4 * B * S * H * D * itemsize + B * S * H * 4,
            4 * B * H * D * pairs)


# bytes of one pool value and of the query / context element, by pool
PAGED_POOLS = {"fp32": (4, 4), "bf16": (2, 2), "int8": (1, 4)}


def paged_bytes(tokens, B, H, D, max_pages, pool):
    """Bytes of one paged_decode call: K and V read once per (position,
    head), D values of the pool's width plus a 4-byte scale for int8
    pools; q read and the context written once in the query's dtype
    (bf16 with bf16 pools, fp32 otherwise); the page table and the
    lengths read once."""
    kv, qo = PAGED_POOLS[pool]
    per_row = D * kv + (4 if pool == "int8" else 0)
    return (2 * tokens * H * per_row + 2 * B * H * D * qo
            + B * max_pages * 4 + B * 4)


def out_proj_cost(B, K, N, act_size=4, w_size=4):
    """(bytes, flops) of ``ctx [B, K] @ W [K, N] + bias``: ctx, W and
    bias read once, out written once."""
    return ((B * K + B * N) * act_size + (K * N + N) * w_size,
            2 * B * K * N)


SPIN_CAP_MS = 50.0


class Timer:
    """Median ms of ``fn`` over ``iters`` launches, each bracketed by
    CUDA events, with the L2 cache flushed before every launch (the
    serving path meets each weight cold). The flush reads a 64 MB
    buffer, so the L2 holds clean lines: a flush by writing left 50 MB
    of dirty lines whose write-back landed in the next window (3-5 us
    on a 16.8 MB read). Device time only: after the flush a device-side
    spin (``torch.cuda._sleep``) longer than twice ``fn``'s host time (at
    most ``SPIN_CAP_MS``) is queued before the start event, so the
    launches are queued before the device reaches it and the wrapper's
    checks and allocations stay out of the window."""

    def __init__(self, torch, device):
        self.torch = torch
        self.flush = torch.ones(16 << 20, dtype=torch.float32, device=device)
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        torch.cuda._sleep(1 << 20)
        e.record()
        e.synchronize()
        self.cycles_per_ms = (1 << 20) / max(s.elapsed_time(e), 1e-3)

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        host_ms = 0.0
        for _ in range(warmup):
            t0 = time.perf_counter()
            fn()
            host_ms = max(host_ms, (time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        spin = int(self.cycles_per_ms * min(SPIN_CAP_MS,
                                            2.0 * host_ms + 0.05))
        times = []
        for _ in range(iters):
            self.flush.sum()
            torch.cuda._sleep(spin)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        times.sort()
        return times[len(times) // 2]


def check_gen(torch, dev, name: str):
    """The generator of one named check, seeded from its name: each check
    draws its own inputs, so adding or reordering checks changes no other
    check's inputs."""
    return torch.Generator(device=dev).manual_seed(zlib.crc32(name.encode()))


def bf16_limit(floor: float, want) -> float:
    """``floor``, or ``BF16_ULPS`` bf16 ulps (8 significant bits) of the
    largest magnitude of the plain output ``want``, whichever is
    larger."""
    top = float(want.float().abs().max().item())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0
    return max(floor, BF16_ULPS * ulp)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max().item())


# the closeness checks that failed; main exits 1 after the last phase
# if any did
FAILED_CHECKS = []


def check_close(name, got, want, tol, rtol=None):
    """The max abs error of ``got`` against ``want``; where ``got`` lies
    outside ``tol`` (atol) and ``rtol`` (default ``tol``) the check is
    printed and recorded in ``FAILED_CHECKS``."""
    import torch
    rtol = tol if rtol is None else rtol
    err = max_err(got, want)
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=rtol):
        FAILED_CHECKS.append(f"{name}: max abs err {err:.3g} over atol "
                             f"{tol} rtol {rtol}")
        emit({"check": name, "ok": False, "max_abs_err": err, "atol": tol,
              "rtol": rtol})
    return err


def rounded_from(got, want32, tol) -> bool:
    """Whether every element of ``got`` (bf16) is the rounding of a value
    within ``tol`` of ``want32``, an f32 result before its rounding: it
    lies between the roundings of ``want32 - tol`` and ``want32 + tol``.
    Where ``want32`` is not within ``tol`` of a rounding midpoint, only
    the plain version's own rounding passes."""
    lo = (want32.double() - tol).to(got.dtype)
    hi = (want32.double() + tol).to(got.dtype)
    return bool(((got >= lo) & (got <= hi)).all().item())


def check_rounded_from(name, got, want32, tol):
    """``check_close`` with ``tol`` taken before the rounding
    (``rounded_from``); returns the max abs error against the rounded
    ``want32``."""
    err = max_err(got, want32.to(got.dtype))
    if not rounded_from(got, want32, tol):
        FAILED_CHECKS.append(f"{name}: not the rounding of a value within "
                             f"{tol} of the plain f32 result (max abs err "
                             f"{err:.3g} after rounding)")
        emit({"check": name, "ok": False, "max_abs_err": err, "atol": tol,
              "before_rounding": True})
    return err


# -- phase 1 -----------------------------------------------------------------

def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    info = {"phase": "device", "ok": True,
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "nvidia_smi": line, "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "python": sys.version.split()[0]}
    emit(info)
    return line


# -- phase 2 -----------------------------------------------------------------

# the backward's tensor-core kernels (csrc/attention_bwd.cu: the single
# pass and the statistics launch of modes 2, 3, the dQ pass of mode 0,
# the dK/dV pass of mode 1): each served instantiation, {fp32, bf16} x
# {D=64, 128}, must not spill
BWD_TC_KERNELS = ("attention_bwd_fused_kernel", "attention_bwd_stats_kernel",
                  "attention_bwd_dq_kernel", "attention_bwd_dkv_kernel")


def ptxas_usage(text: str):
    """Registers, stack frame and spill bytes of every kernel entry in
    ``ptxas -v`` output, by mangled name."""
    usage = {}
    name = None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([A-Za-z0-9_]+)'?", line)
        if m:
            name = m.group(1)
            usage.setdefault(name, {})
            continue
        if name is None:
            continue
        for key, pat in (("stack", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"),
                         ("registers", r"Used (\d+) registers")):
            hit = re.search(pat, line)
            if hit:
                usage[name][key] = int(hit.group(1))
    return usage


def bwd_ptxas(usage):
    """``ptxas -v``'s registers and spills of the backward's tensor-core
    kernels, keyed ``kernel dtype D``; raises if one is missing or
    spills."""
    rows = {}
    for mangled, u in usage.items():
        kernel = next((k for k in BWD_TC_KERNELS if k in mangled), None)
        if kernel is None:
            continue
        dtype = "bf16" if "bfloat16" in mangled else "fp32"
        d = re.search(r"Li(\d+)E", mangled).group(1)
        rows[f"{kernel} {dtype} D={d}"] = u
    want = [f"{k} {dt} D={d}" for k in BWD_TC_KERNELS
            for dt in ("fp32", "bf16") for d in (64, 128)]
    missing = [w for w in want if w not in rows]
    if missing:
        raise AssertionError(f"ptxas -v shows no lines for {missing}")
    spills = {k: u for k, u in rows.items()
              if u.get("spill_stores", 0) or u.get("spill_loads", 0)}
    if spills:
        raise AssertionError(f"backward kernel spills: {spills}")
    return rows


def fb_ptxas(usage):
    """``ptxas -v``'s registers and spills of the fused bottleneck's two
    instantiations (fp32, bf16); raises if one is missing or spills."""
    rows = {}
    for mangled, u in usage.items():
        if "bottleneck_kernel" in mangled:
            rows["bf16" if "bfloat16" in mangled else "fp32"] = u
    if sorted(rows) != ["bf16", "fp32"]:
        raise AssertionError(f"ptxas -v shows {sorted(rows)} of "
                             f"bottleneck_kernel, not fp32 and bf16")
    spills = {k: u for k, u in rows.items()
              if u.get("spill_stores", 0) or u.get("spill_loads", 0)}
    if spills:
        raise AssertionError(f"fused_bottleneck spills: {spills}")
    return rows


def phase_build():
    from paddle_tpu_torch.ops.kernels import _build
    t0 = time.monotonic()
    path = _build.build(verbose=True)
    _build.lib()
    seconds = round(time.monotonic() - t0, 3)
    with open(_build.ptxas_report_path()) as f:
        usage = ptxas_usage(f.read())
    emit({"phase": "build", "ok": True, "lib": os.path.relpath(path, HERE),
          "seconds": seconds,
          "bwd_ptxas": bwd_ptxas(usage), "fb_ptxas": fb_ptxas(usage)})


# -- phase 3 -----------------------------------------------------------------

def check_equal(name, got, want):
    """Where ``got`` and ``want`` are not the same bits, the check is
    printed and recorded in ``FAILED_CHECKS``."""
    import torch
    if not torch.equal(got, want):
        err = max_err(got, want)
        FAILED_CHECKS.append(f"{name}: not bitwise equal (max abs err "
                             f"{err:.3g})")
        emit({"check": name, "ok": False, "max_abs_err": err,
              "bitwise": True})


# the table shape: the engine's 8 slots at lengths from empty to a full
# 2048-token row, GPT-1.3B's heads
PAGED_SHAPE = dict(B=8, H=16, D=128, page=64, max_pages=32,
                   lens=(0, 1, 37, 64, 100, 700, 1500, 2048))


def paged_cases(split):
    """paged_decode checks beyond the table shape, not timed: (label, H,
    D, page, max_pages, lens). A head dim of 64 at page 16; a 64-page
    (4096-token) table, more splits than the engine's 32-page rows; a
    sequence of exactly one split of ``split`` positions; one a token
    past a split."""
    return (("D=64 page=16", 16, 64, 16, 64, (0, 17, split, 1000)),
            ("64-page table", 16, 128, 64, 64, (4096, 3001, 1, 0)),
            ("one split", 16, 128, 64, 32, (split,)),
            ("one past a split", 16, 128, 64, 32, (split + 1,)))


def _paged_inputs(torch, gen, dev, H, D, page, max_pages, lens):
    """q [B, H, D], fp32 pools of B * max_pages pages and the scratch
    page, a page table that is a random permutation of the pool, and the
    lengths."""
    B = len(lens)
    P = B * max_pages
    perm = torch.randperm(P, generator=gen, device=dev).to(torch.int32)
    kf = torch.randn((P + 1, page, H, D), generator=gen, device=dev)
    vf = torch.randn((P + 1, page, H, D), generator=gen, device=dev)
    q = torch.randn((B, H, D), generator=gen, device=dev)
    return (q, kf, vf, perm.reshape(B, max_pages).contiguous(),
            torch.tensor(lens, dtype=torch.int32, device=dev))


def _paged_pools(torch, q, kf, vf, pool):
    """(q, k pages, v pages, k scale, v scale) of one pool type: fp32;
    bf16 pools with a bf16 query; int8 pools (quantize_kv) with an fp32
    query."""
    from paddle_tpu_torch.quantization.quant import quantize_kv
    if pool == "fp32":
        return q, kf, vf, None, None
    if pool == "bf16":
        bf = torch.bfloat16
        return q.to(bf), kf.to(bf), vf.to(bf), None, None
    kq, ks = quantize_kv(kf)
    vq, vs = quantize_kv(vf)
    return q, kq, vq, ks, vs


def _paged_check(torch, name, q, kp, vp, table, lens, ksc, vsc):
    """paged_decode against the plain version and the split emulation:
    fp32 queries within ``PAGED_TOL``; bf16 each sequence within the
    ``bf16_limit`` of its own plain output (absolute), so the long
    sequences, whose contexts are small, are not held to the limit of
    the short ones; len 0 exact zeros, no non-finite value. Returns
    (output, max abs error against the plain version)."""
    from paddle_tpu_torch.ops.kernels.paged_attention import (
        paged_attention_reference, paged_decode,
        paged_decode_split_emulation)
    got = paged_decode(q, kp, vp, table, lens, k_scale=ksc, v_scale=vsc)
    want = paged_attention_reference(q[:, None], kp, vp, table, lens,
                                     k_scale=ksc, v_scale=vsc)[:, 0]
    emu = paged_decode_split_emulation(q, kp, vp, table, lens, k_scale=ksc,
                                       v_scale=vsc)
    torch.cuda.synchronize()
    empty = lens == 0
    if empty.any() and got[empty].abs().max().item() != 0.0:
        raise AssertionError(f"{name}: len 0 must give zeros")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    if q.dtype != torch.bfloat16:
        err = check_close(name, got, want, PAGED_TOL)
        check_close(f"{name} vs split emulation", got, emu, PAGED_TOL)
        return got, err
    err = 0.0
    for i in range(q.shape[0]):
        tol = bf16_limit(BF16_ATOL["paged_decode"], want[i])
        err = max(err, check_close(f"{name} row {i}", got[i], want[i], tol,
                                   0.0))
        check_close(f"{name} row {i} vs split emulation", got[i], emu[i],
                    tol, 0.0)
    return got, err


def _paged_invariance(torch, name, got, q, kp, vp, table, lens, ksc, vsc):
    """The batched call twice gives the same bits, and each sequence
    decoded alone with its own table row gives its row's bits."""
    from paddle_tpu_torch.ops.kernels.paged_attention import paged_decode
    check_equal(f"{name} repeat", paged_decode(
        q, kp, vp, table, lens, k_scale=ksc, v_scale=vsc), got)
    for i in range(q.shape[0]):
        alone = paged_decode(q[i:i + 1], kp, vp, table[i:i + 1],
                             lens[i:i + 1], k_scale=ksc, v_scale=vsc)
        check_equal(f"{name} row {i} alone", alone[0], got[i])


def _paged_poisoned(kf, vf, table, lens):
    """Copies of the inputs with NaN where the walk must not read: the
    rows past each length in its last page, and the scratch page, which
    every table entry past a sequence's last page now names."""
    page = kf.shape[1]
    kp, vp, tp = kf.clone(), vf.clone(), table.clone()
    scratch = kf.shape[0] - 1
    kp[scratch] = float("nan")
    vp[scratch] = float("nan")
    for i, n in enumerate(lens.tolist()):
        used = -(-n // page)
        tp[i, used:] = scratch
        if n % page:
            pg = int(tp[i, n // page])
            kp[pg, n % page:] = float("nan")
            vp[pg, n % page:] = float("nan")
    return kp, vp, tp


def kernel_paged(torch, timer, dev, gen, records):
    """paged_decode at the table shape with fp32, bf16 and int8 pools
    against the plain version and the split emulation, batch-invariant
    bit for bit, unchanged by NaN where it must not read; the cases of
    ``paged_cases``; timed per pool beside its bytes bound, with the
    device kernels of one call counted under ``torch.profiler``."""
    from paddle_tpu_torch.ops.kernels import paged_attention as tpa
    paged_attention_reference = tpa.paged_attention_reference
    paged_decode = tpa.paged_decode
    sh = PAGED_SHAPE
    B, H, D, page, max_pages = (sh["B"], sh["H"], sh["D"], sh["page"],
                                sh["max_pages"])
    q32, kf, vf, table, lens = _paged_inputs(torch, gen, dev, H, D, page,
                                             max_pages, sh["lens"])
    errs = {}
    pools = {}
    for pool in PAGED_POOLS:
        args = _paged_pools(torch, q32, kf, vf, pool)
        pools[pool] = args
        name = f"paged_decode {pool}"
        got, errs[pool] = _paged_check(torch, name, *args[:3], table, lens,
                                       *args[3:])
        _paged_invariance(torch, name, got, *args[:3], table, lens,
                          *args[3:])
        if pool == "fp32":
            base = got
    kp, vp, tp = _paged_poisoned(kf, vf, table, lens)
    check_equal("paged_decode fp32 NaN past the length",
                paged_decode(q32, kp, vp, tp, lens), base)
    del kp, vp
    cases = []
    for label, h, d, pg, mp, lens_c in paged_cases(tpa.PAGED_SPLIT_TOKENS):
        cgen = check_gen(torch, dev, f"paged_decode {label}")
        qc, kc, vc, tc, lc = _paged_inputs(torch, cgen, dev, h, d, pg, mp,
                                           lens_c)
        for pool in PAGED_POOLS:
            args = _paged_pools(torch, qc, kc, vc, pool)
            name = f"paged_decode {label} {pool}"
            got, err = _paged_check(torch, name, *args[:3], tc, lc,
                                    *args[3:])
            if pool != "bf16":
                errs[pool] = max(errs[pool], err)
            _paged_invariance(torch, name, got, *args[:3], tc, lc, *args[3:])
            cases.append(name)
    tokens = int(lens.sum().item())
    flops = 4 * tokens * H * D
    rows = {}
    for pool, (q, kp, vp, ksc, vsc) in pools.items():
        ms = timer(lambda: paged_decode(q, kp, vp, table, lens, k_scale=ksc,
                                        v_scale=vsc))
        plain_ms = timer(lambda: paged_attention_reference(
            q[:, None], kp, vp, table, lens, k_scale=ksc, v_scale=vsc))
        b, by = bound_ms(paged_bytes(tokens, B, H, D, max_pages, pool),
                         flops, "bf16" if pool == "bf16" else "fp32")
        prof = profile_once(torch, lambda: paged_decode(
            q, kp, vp, table, lens, k_scale=ksc, v_scale=vsc))
        rows[pool] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                          bound_share=b / ms, max_abs_err=errs[pool],
                          launches_per_call=prof["kernels"],
                          kernels_in_call=[n for n, _ in
                                           prof["top_kernels_ms"]])
    fp32 = rows["fp32"]
    records["paged_decode"] = dict(
        max_abs_err=fp32["max_abs_err"], ms=fp32["ms"],
        plain_ms=fp32["plain_ms"], bound_ms=fp32["bound_ms"],
        bound_by=fp32["bound_by"], library_ms=None,
        shape=f"B={B} H={H} D={D} page={page} lens={lens.tolist()} fp32")
    emit({"phase": "kernels", "kernel": "paged_decode", "ok": True,
          **records["paged_decode"], "tol": PAGED_TOL,
          "launches_per_call": fp32["launches_per_call"],
          "split_tokens_input": tpa.PAGED_SPLIT_TOKENS, "pools": rows,
          "cases": [f"paged_decode {p}" for p in PAGED_POOLS] + cases,
          "checks": "plain version, split emulation, repeat and each row "
                    "alone bitwise, NaN past the length bitwise"})


# decode_out_proj: the engine's slot counts (1, 8, 64) and one past a
# chunk of 8 batch rows (9); fp32 ctx with fp32 and bf16 W
OUT_PROJ_BATCHES = (1, 8, 9, 64)
OUT_PROJ_TIMED = (8, 64)
# a 13B GPT's width, past the 4096 rows one cluster covers in one pass,
# at a slot count and at one past a group of 64 rows
OUT_PROJ_WIDE = (5120, (8, 65))


def out_proj_cases(torch, decode_out_proj, decode_out_proj_reference,
                   ctx, w32, bias32, errs):
    """decode_out_proj on ``ctx`` with fp32 and bf16 W, with and without
    bias, twice with the same bits, against its plain version within
    ``PROJ_TOL`` (the plain version up-casts bf16 W to fp32 exactly, and
    ctx is fp32, so both run in f32); the largest error per W dtype into
    ``errs``."""
    B, E = ctx.shape
    for tag, w, bias in (("fp32", w32, bias32),
                         ("bf16 W", w32.to(torch.bfloat16),
                          bias32.to(torch.bfloat16))):
        for bb in (bias, None):
            got = decode_out_proj(ctx, w, bb)
            again = decode_out_proj(ctx, w, bb)
            want = decode_out_proj_reference(ctx, w, bb)
            torch.cuda.synchronize()
            name = (f"decode_out_proj B={B} E={E} {tag} "
                    f"{'bias' if bb is not None else 'no bias'}")
            if not torch.equal(got, again):
                raise AssertionError(f"{name}: two runs differ")
            errs[tag] = max(errs[tag], check_close(name, got, want, PROJ_TOL))


def kernel_out_proj(torch, timer, dev, gen, records):
    """decode_out_proj against its plain version at E=2048 for every B in
    ``OUT_PROJ_BATCHES`` and at ``OUT_PROJ_WIDE`` (``out_proj_cases``);
    timed at E=2048, B=8 (the row) and B=64 beside ``addmm``."""
    from paddle_tpu_torch.ops.kernels.paged_attention import (
        decode_out_proj, decode_out_proj_reference)
    E = 2048
    w32 = torch.randn((E, E), generator=gen, device=dev) * 0.02
    bias32 = torch.randn((E,), generator=gen, device=dev)
    errs = {"fp32": 0.0, "bf16 W": 0.0}
    ctxs = {}
    for B in OUT_PROJ_BATCHES:
        ctxs[B] = torch.randn((B, E), generator=gen, device=dev)
        out_proj_cases(torch, decode_out_proj, decode_out_proj_reference,
                       ctxs[B], w32, bias32, errs)
    wide, wide_batches = OUT_PROJ_WIDE
    wgen = check_gen(torch, dev, f"decode_out_proj E={wide}")
    ww = torch.randn((wide, wide), generator=wgen, device=dev) * 0.02
    wb = torch.randn((wide,), generator=wgen, device=dev)
    for B in wide_batches:
        out_proj_cases(torch, decode_out_proj, decode_out_proj_reference,
                       torch.randn((B, wide), generator=wgen, device=dev),
                       ww, wb, errs)
    del ww
    per_shape = []
    # what one PyTorch call that only reads W takes under this timer
    read_ms = timer(lambda: w32.sum())
    for B in OUT_PROJ_TIMED:
        ctx = ctxs[B]
        ms = timer(lambda: decode_out_proj(ctx, w32, bias32))
        plain_ms = timer(lambda: decode_out_proj_reference(ctx, w32, bias32))
        lib_ms = timer(lambda: torch.addmm(bias32, ctx, w32))
        b, by = bound_ms(*out_proj_cost(B, E, E))
        rec = dict(B=B, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=b, bound_by=by, w_sum_ms=read_ms)
        per_shape.append(rec)
        emit({"phase": "kernels", "kernel": "decode_out_proj", "ok": True,
              "shape": f"B={B} E={E} fp32", **rec})
    first = per_shape[0]
    records["decode_out_proj"] = dict(
        max_abs_err=errs["fp32"], ms=first["ms"],
        plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
        bound_by=first["bound_by"], library_ms=first["library_ms"],
        shape=f"B=8 E={E} fp32", per_shape=per_shape)
    emit({"phase": "kernels", "kernel": "decode_out_proj", "ok": True,
          "max_abs_err": errs["fp32"], "tol": PROJ_TOL,
          "bf16_w_max_abs_err": errs["bf16 W"], "bf16_w_tol": PROJ_TOL,
          "library": "torch.addmm",
          "cases": [f"B={B} E={E}" for B in OUT_PROJ_BATCHES]
          + [f"B={B} E={wide}" for B in wide_batches]})


def kernel_argmax(torch, timer, dev, gen, records):
    from paddle_tpu_torch.ops.kernels.fused_sample import (
        fused_argmax, fused_argmax_reference)
    B, D = 8, 2048
    for V in (50304, 50257):  # the served vocab, and a partial last tile
        h = torch.randn((B, D), generator=gen, device=dev)
        w = torch.randn((V, D), generator=gen, device=dev) * 0.02
        bias = torch.randn((V,), generator=gen, device=dev) * 0.1
        # planted tie on row 0: two identical winning vocab rows
        t1, t2 = 1234, 40000
        w[t1] = h[0] / h[0].norm() * 5.0
        w[t2] = w[t1]
        # planted NaN on row 1: the first NaN index must win over a
        # later NaN and over any number
        n1, n2 = 777, 30000
        for tag, ww, bb, ty in (
                ("vocab_major", w, None, True),
                ("vocab_major+bias", w, bias, True),
                ("feature_major", w.t().contiguous(), None, False),
                ("feature_major+bias", w.t().contiguous(), bias, False)):
            vd = 0 if ty else 1
            ww_nan = ww.clone()
            if ty:
                ww_nan[n1, 0] = float("nan")
                ww_nan[n2, 0] = float("nan")
            else:
                ww_nan[0, n1] = float("nan")
                ww_nan[0, n2] = float("nan")
            for wname, wt in (("clean", ww), ("nan", ww_nan)):
                got = fused_argmax(h, wt, bb, transpose_y=ty)
                want = fused_argmax_reference(h, wt, vd, bias=bb)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"fused_argmax V={V} {tag} {wname}: "
                        f"{got.tolist()} != {want.tolist()}")
                if wname == "clean" and bb is None and \
                        int(got[0]) != t1:
                    raise AssertionError(
                        f"fused_argmax tie: {int(got[0])} != {t1}")
                if wname == "nan" and int(got[0]) != n1:
                    raise AssertionError(
                        f"fused_argmax NaN: {int(got[0])} != {n1}")
    V = 50304
    h = torch.randn((B, D), generator=gen, device=dev)
    w = torch.randn((V, D), generator=gen, device=dev) * 0.02
    ms = timer(lambda: fused_argmax(h, w, None, transpose_y=True))
    plain_ms = timer(lambda: fused_argmax_reference(h, w, 0))
    lib_ms = timer(lambda: torch.argmax(h @ w.t(), dim=-1))
    nbytes = (V * D + B * D) * 4 + B * 4
    b, by = bound_ms(nbytes, 2 * B * V * D)
    records["fused_argmax"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b,
        bound_by=by, library_ms=lib_ms,
        shape=f"B={B} D={D} V={V} [V,D] fp32")
    emit({"phase": "kernels", "kernel": "fused_argmax", "ok": True,
          **records["fused_argmax"], "tol": "index-exact",
          "library": "torch.argmax(h @ W.T)",
          "cases": "V in (50304, 50257) x both layouts x bias x "
                   "{clean with planted tie, planted NaN}"})


# attention_fwd checks beyond the timed causal D=128 sequence lengths:
# (label, B, Sq, Sk, H, D, causal); every head dim the wrapper admits,
# ragged lengths that no tile divides, Sq != Sk
ATTN_CASES = (
    ("D=64 S=512", 2, 512, 512, 16, 64, True),
    ("D=64 S=512 non-causal", 2, 512, 512, 16, 64, False),
    ("D=256 S=512", 1, 512, 512, 8, 256, True),
    ("D=256 S=512 non-causal", 1, 512, 512, 8, 256, False),
    ("D=256 S=200", 1, 200, 200, 8, 256, True),
    ("ragged S=200", 2, 200, 200, 16, 128, True),
    ("ragged S=200 non-causal", 2, 200, 200, 16, 128, False),
    ("Sq=200 Sk=333", 1, 200, 333, 16, 128, True),
    ("Sq=200 Sk=333 non-causal", 1, 200, 333, 16, 128, False),
    ("D=64 S=77", 1, 77, 77, 4, 64, True),
    ("S=2048 non-causal", 1, 2048, 2048, 16, 128, False),
)


def _qkv(torch, gen, dev, B, Sq, Sk, H, D, dtype=None):
    """q, k, v as slices of fused projections (the model's strides)."""
    if Sq == Sk:
        qkv = torch.randn((B, Sq, 3, H, D), generator=gen, device=dev)
        qkv = qkv.to(dtype) if dtype is not None else qkv
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    q = torch.randn((B, Sq, H, D), generator=gen, device=dev)
    kv = torch.randn((B, Sk, 2, H, D), generator=gen, device=dev)
    if dtype is not None:
        q, kv = q.to(dtype), kv.to(dtype)
    return q, kv[:, :, 0], kv[:, :, 1]


def _attn_check(torch, tag, q, k, v, causal, tol, rtol=None):
    """The kernel against its plain version (out and lse), twice with
    the same bits, and without the lse; returns the largest error. A
    bf16 ``out`` takes ``tol`` before its rounding (``check_rounded_from``
    against the plain version's f32 result, ``BF16_BEFORE_ROUNDING``)."""
    from paddle_tpu_torch.ops.kernels.attention import (
        attention_fwd, attention_reference)
    want_o, want_l = attention_reference(q, k, v, causal=causal)
    if q.dtype == torch.bfloat16:
        want_o, _ = attention_reference(q.float(), k.float(), v.float(),
                                        causal=causal)
    got_o, got_l = attention_fwd(q, k, v, causal=causal)
    again_o, again_l = attention_fwd(q, k, v, causal=causal)
    bare_o, _ = attention_fwd(q, k, v, causal=causal, return_lse=False)
    torch.cuda.synchronize()
    if not (torch.isfinite(got_o).all() and torch.isfinite(got_l).all()):
        raise AssertionError(f"attention_fwd {tag}: non-finite output")
    if not (torch.equal(got_o, again_o) and torch.equal(got_l, again_l)
            and torch.equal(got_o, bare_o)):
        raise AssertionError(f"attention_fwd {tag}: two runs differ")
    name = f"attention_fwd {tag} out"
    if q.dtype == torch.bfloat16:
        out_err = check_rounded_from(name, got_o, want_o, tol)
    else:
        out_err = check_close(name, got_o, want_o, tol, rtol)
    return max(out_err, check_close(f"attention_fwd {tag} lse", got_l,
                                    want_l, tol, rtol))


def kernel_attention(torch, timer, dev, gen, records):
    """attention_fwd (tensor cores: 3xTF32 in fp32) against its plain
    version in fp32 within ``ATTN_TOL``: causal D=128 at the serving and
    training path's lengths (timed beside SDPA), then ``ATTN_CASES``;
    every case twice with the same bits. Then bf16 at S=2048 timed
    beside SDPA in bf16 (checked in ``kernels_bf16``)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels.attention import (
        attention_fwd, attention_reference)
    B, H, D = 1, 16, 128
    per_shape = []
    errs = []
    for S in (128, 256, 512, 1024, 2048):
        q, k, v = _qkv(torch, gen, dev, B, S, S, H, D)
        errs.append(_attn_check(torch, f"S={S}", q, k, v, True, ATTN_TOL))
        ms = timer(lambda: attention_fwd(q, k, v, causal=True))
        plain_ms = timer(lambda: attention_reference(q, k, v, causal=True),
                         iters=20)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        b, by = bound_ms(*attention_fwd_cost(B, S, H, D, True))
        rec = dict(S=S, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=b, bound_by=by)
        per_shape.append(rec)
        emit({"phase": "kernels", "kernel": "attention_fwd", "ok": True,
              "shape": f"B={B} S={S} H={H} D={D} causal fp32", **rec})
    for label, b_, sq, sk, h_, d_, causal in ATTN_CASES:
        g2 = check_gen(torch, dev, f"attention_fwd {label}")
        q, k, v = _qkv(torch, g2, dev, b_, sq, sk, h_, d_)
        errs.append(_attn_check(torch, label, q, k, v, causal, ATTN_TOL))
    # bf16 at the training length, timed beside SDPA in bf16
    g2 = check_gen(torch, dev, "attention_fwd bf16 timing")
    q, k, v = _qkv(torch, g2, dev, B, 2048, 2048, H, D, torch.bfloat16)
    ms = timer(lambda: attention_fwd(q, k, v, causal=True))
    plain_ms = timer(lambda: attention_reference(q, k, v, causal=True))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib_ms = timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    b, by = bound_ms(*attention_fwd_cost(B, 2048, H, D, True, 2), "bf16")
    rec = dict(S=2048, dtype="bf16", ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=b, bound_by=by)
    per_shape.append(rec)
    emit({"phase": "kernels", "kernel": "attention_fwd", "ok": True,
          "shape": f"B={B} S=2048 H={H} D={D} causal bf16", **rec})
    last = per_shape[-2]
    records["attention_fwd"] = dict(
        max_abs_err=max(errs), ms=last["ms"], plain_ms=last["plain_ms"],
        bound_ms=last["bound_ms"], bound_by=last["bound_by"],
        library_ms=last["library_ms"],
        shape=f"B={B} S=2048 H={H} D={D} causal fp32",
        per_shape=per_shape)
    emit({"phase": "kernels", "kernel": "attention_fwd", "ok": True,
          "max_abs_err": max(errs), "tol": ATTN_TOL,
          "library": "F.scaled_dot_product_attention",
          "cases": [f"S={s_} causal D=128" for s_ in
                    (128, 256, 512, 1024, 2048)]
          + [c[0] for c in ATTN_CASES]})


# (label, S, D, causal, scale of v) of the bf16 forward checks; H=16,
# B=1. On unit-variance inputs one-term bf16 P lies within 3.6e-3 of the
# plain f32 output before the rounding (CPU draws), inside the 5e-3
# limit; with v four times larger (|out| up to ~12, as a model's values
# can be) it lies beyond it, so that case shows the check telling one
# term from two.
BF16_FWD_CASES = (("S=512", 512, 128, True, 1.0),
                  ("S=2048", 2048, 128, True, 1.0),
                  ("S=512 non-causal", 512, 128, False, 1.0),
                  ("D=64 S=200", 200, 64, True, 1.0),
                  ("D=256 S=512", 512, 256, True, 1.0),
                  ("S=512 v x4", 512, 128, True, 4.0))


def bf16_terms_fwd(torch, terms, q, k, v, causal):
    """The plain forward with P carried as ``terms`` bf16 terms into
    P.V, f32 otherwise (scores, max, row sum and the division by it):
    what a kernel with one- or two-term bf16 P computes. Returns ``out``
    rounded to the inputs' dtype."""
    from paddle_tpu_torch.ops.kernels import attention as A
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = A._scores(q, k, causal, scale)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    den = p.sum(dim=-1, keepdim=True)
    hi = p.to(torch.bfloat16).float()
    if terms == 2:
        hi = hi + (p - hi).to(torch.bfloat16).float()
    out = torch.einsum("bhqk,bkhd->bqhd", hi / den, v.float())
    return out.to(q.dtype)


def kernels_bf16(torch, dev):
    """bf16 storage through every kernel (f32 accumulation) against the
    plain versions on the same bf16 inputs, within ``BF16_ATOL`` (no
    relative term; paged_decode at least ``BF16_ULPS`` ulps of its
    output); argmax index-exact. Each check draws from its own
    generator."""
    from paddle_tpu_torch.ops.kernels.fused_sample import (
        fused_argmax, fused_argmax_reference)
    from paddle_tpu_torch.ops.kernels.attention import attention_reference
    from paddle_tpu_torch.ops.kernels.paged_attention import (
        decode_out_proj, decode_out_proj_reference,
        paged_attention_reference, paged_decode)
    bf = torch.bfloat16
    tol = BF16_ATOL
    errs = {}
    H, D, page, B, mp = 16, 128, 64, 4, 8
    lens = torch.tensor([0, 5, 64, 500], dtype=torch.int32, device=dev)
    table = torch.arange(B * mp, dtype=torch.int32,
                         device=dev).reshape(B, mp)
    gen = check_gen(torch, dev, "bf16 paged_decode")
    kp = torch.randn((B * mp + 1, page, H, D), generator=gen,
                     device=dev).to(bf)
    vp = torch.randn((B * mp + 1, page, H, D), generator=gen,
                     device=dev).to(bf)
    q = torch.randn((B, H, D), generator=gen, device=dev).to(bf)
    want = paged_attention_reference(q[:, None], kp, vp, table, lens)[:, 0]
    limits = {"paged_decode": bf16_limit(tol["paged_decode"], want)}
    errs["paged_decode"] = check_close(
        "paged_decode bf16", paged_decode(q, kp, vp, table, lens), want,
        limits["paged_decode"], 0.0)
    gen = check_gen(torch, dev, "bf16 decode_out_proj")
    ctx = torch.randn((B, 2048), generator=gen, device=dev).to(bf)
    w = (torch.randn((2048, 2048), generator=gen, device=dev)
         * 0.02).to(bf)
    got = decode_out_proj(ctx, w)
    if not torch.equal(got, decode_out_proj(ctx, w)):
        raise AssertionError("decode_out_proj bf16: two runs differ")
    errs["decode_out_proj"] = check_close(
        "decode_out_proj bf16", got, decode_out_proj_reference(ctx, w),
        tol["decode_out_proj"], 0.0)
    gen = check_gen(torch, dev, "bf16 fused_argmax")
    h = torch.randn((B, 2048), generator=gen, device=dev).to(bf)
    wv = (torch.randn((50304, 2048), generator=gen, device=dev)
          * 0.02).to(bf)
    got = fused_argmax(h, wv, None, transpose_y=True)
    want = fused_argmax_reference(h.float(), wv.float(), 0)
    if not torch.equal(got, want):
        raise AssertionError(f"fused_argmax bf16: {got.tolist()} != "
                             f"{want.tolist()}")
    ta = tol["attention_fwd"]
    errs["attention_fwd"] = 0.0
    refused = []
    for label, S, D_, causal, v_scale in BF16_FWD_CASES:
        gen = check_gen(torch, dev, "bf16 attention_fwd" +
                        ("" if label == "S=512" else f" {label}"))
        qq, kk, vv = _qkv(torch, gen, dev, 1, S, S, H, D_, bf)
        vv.mul_(v_scale)  # a power of two: exact in bf16
        errs["attention_fwd"] = max(
            errs["attention_fwd"],
            _attn_check(torch, f"bf16 {label}", qq, kk, vv, causal, ta,
                        0.0))
        want32, _ = attention_reference(qq.float(), kk.float(), vv.float(),
                                        causal=causal)
        if not rounded_from(bf16_terms_fwd(torch, 1, qq, kk, vv, causal),
                            want32, ta):
            refused.append(label)
    if not refused:
        raise AssertionError("attention_fwd: the bf16 check passes one-term "
                             "bf16 P in every case")
    emit({"phase": "kernels_bf16", "ok": True, "atol": dict(tol, **limits),
          "max_abs_err": errs, "fused_argmax": "index-exact",
          "attention_fwd_before_rounding": True,
          "attention_fwd_one_term_refused": refused})


def bf16_apart(got, want):
    """How far two bf16 outputs lie apart: the max abs difference and the
    share of elements that differ."""
    return [max_err(got, want), float((got != want).float().mean().item())]


# (label, kernels, B, S, causal, with an lse cotangent, D); H=16. The
# first three are the training path's shapes (GPT-1.3B at B=2); S=200 is
# ragged (a last tile of 8 rows); S=1024 at D=64 is the widest shape the
# folded gate admits (timed too, with the dQ and dK/dV passes).
BWD_CASES = (
    ("S=2048 causal", ("attention_bwd_dq", "attention_bwd_dkv"), 2, 2048,
     True, False, 128),
    ("S=512 causal", ("attention_bwd_fused",), 2, 512, True, False, 128),
    ("S=256 causal", ("folded_attention_bwd",), 2, 256, True, False, 128),
    ("S=512 non-causal", TRAINING_KERNELS, 1, 512, False, False, 128),
    ("S=512 causal, lse cotangent", ("attention_bwd_fused",
                                     "attention_bwd_dq",
                                     "attention_bwd_dkv"), 1, 512, True,
     True, 128),
    ("S=200 causal", TRAINING_KERNELS, 2, 200, True, False, 128),
    ("S=1024 causal D=64", ("folded_attention_bwd", "attention_bwd_dq",
                            "attention_bwd_dkv"), 2, 1024, True, False, 64),
)
# the rows timed: each kernel at its training-path shape, and the folded,
# dQ and dK/dV kernels at D=64
BWD_TIMED = ("S=2048 causal", "S=512 causal", "S=256 causal",
             "S=1024 causal D=64")
# flops per (query, key) pair and head-dim element: 2 per multiply-add
# of each product the function needs (S = QK^T, dP = dO V^T, then dQ;
# dV and dK; all three)
BWD_FLOPS = {"attention_bwd_dq": 6, "attention_bwd_dkv": 8,
             "attention_bwd_fused": 10, "folded_attention_bwd": 10}
# [B, S, H, D] rows read and written, and f32 [B, S, H] rows read
# (lse, delta), by each function
BWD_ROWS = {"attention_bwd_dq": (4, 1, 2), "attention_bwd_dkv": (4, 2, 2),
            "attention_bwd_fused": (4, 3, 2),
            "folded_attention_bwd": (4, 3, 0)}
# the gradients each function returns
BWD_OUTPUTS = {"attention_bwd_dq": ("dq",), "attention_bwd_dkv": ("dk", "dv"),
               "attention_bwd_fused": ("dq", "dk", "dv"),
               "folded_attention_bwd": ("dq", "dk", "dv")}


def _bwd_inputs(torch, gen, dev, B, S, dtype, causal, with_glse,
                H=16, D=128):
    """q, k, v as slices of one fused [B, S, 3, H, D] projection (the
    model's strides), dO, and the flash entries' lse and delta =
    rowsum(dO*O) - g_lse from the plain forward on the same inputs."""
    from paddle_tpu_torch.ops.kernels.attention import attention_reference
    qkv = torch.randn((B, S, 3, H, D), generator=gen, device=dev).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.randn((B, S, H, D), generator=gen, device=dev).to(dtype)
    out, lse = attention_reference(q, k, v, causal=causal)
    delta = (do.float() * out.float()).sum(-1)
    if with_glse:
        delta = delta - torch.randn((B, S, H), generator=gen, device=dev)
    return q, k, v, do, lse, delta.contiguous()


def _bwd_call(name, q, k, v, do, lse, delta, causal):
    """The kernel ``name`` and its plain version on the same inputs, as
    dicts {"dq"/"dk"/"dv": tensor}."""
    from paddle_tpu_torch.ops.kernels import attention as A
    if name == "folded_attention_bwd":
        got = A.folded_attention_bwd(q, k, v, do, causal)
        want = A.folded_bwd_reference(q, k, v, do, causal)
    else:
        want = A.attention_bwd_reference(q, k, v, do, lse, delta, causal)
        got = getattr(A, name)(q, k, v, do, lse, delta, causal)
        if name == "attention_bwd_dq":
            got, want = (got,), want[:1]
        elif name == "attention_bwd_dkv":
            want = want[1:]
    keys = BWD_OUTPUTS[name]
    return dict(zip(keys, got)), dict(zip(keys, want))


def bf16_terms_bwd(torch, name, terms, q, k, v, do, lse, delta, causal):
    """The plain version of ``name`` with P carried as ``terms`` bf16
    terms into the products (dS = P (dP - delta) scale inherits its
    error), f32 otherwise: what a kernel with one- or two-term bf16 P/dS
    computes. Returns the gradients ``name`` returns (``BWD_OUTPUTS``),
    {"dq"/"dk"/"dv": tensor}, in the inputs' dtype."""
    from paddle_tpu_torch.ops.kernels import attention as A
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = A._scores(q, k, causal, scale)
    if name == "folded_attention_bwd":
        p = torch.softmax(s, dim=-1)
        dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
        d = (p * dp).sum(dim=-1, keepdim=True)
    else:
        p = torch.exp(s - lse.transpose(1, 2)[..., None])
        d = delta.transpose(1, 2)[..., None]
    hi = p.to(torch.bfloat16).float()
    if terms == 2:
        hi = hi + (p - hi).to(torch.bfloat16).float()
    grads = dict(zip(("dq", "dk", "dv"),
                     A._grads_from_p(q, k, v, do, hi, d, scale)))
    return {key: grads[key] for key in BWD_OUTPUTS[name]}


def _sdpa_bwd_ms(torch, timer, q, k, v, do, causal):
    """The library yardstick: the backward of
    ``F.scaled_dot_product_attention`` on the same tensors ([B, H, S, D]
    copies), with the first backend that takes them."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt, kt, vt = (t.transpose(1, 2).detach().contiguous().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                out = F.scaled_dot_product_attention(qt, kt, vt,
                                                     is_causal=causal)
            torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
        except RuntimeError:
            continue
        ms = timer(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                               retain_graph=True))
        return ms, backend.name
    raise AssertionError("no SDPA backend ran the yardstick")


def kernel_attention_bwd(torch, timer, dev, records):
    """The four backward kernels against their plain versions in fp32
    (atol/rtol ``BWD_TOL``) and bf16 (``BF16_ATOL``, absolute; before the
    rounding for ``BF16_BEFORE_ROUNDING``, where one-term bf16 P/dS
    (``bf16_terms_bwd``) must fail in some case) on ``BWD_CASES``; each
    run twice must give the same bits (no float atomics). On the bf16
    inputs the fp32 kernel runs too and its outputs, rounded to bf16, are
    held against the plain version's (``bf16_apart``: the part of the
    bf16 error that no choice of bf16 operands inside the kernel removes;
    reported, not checked). Then each
    is timed at its training-path shape (the first three cases, fp32),
    and the folded kernel at D=64 S=1024, with one profiled call's
    launches."""
    errs = {torch.float32: {}, torch.bfloat16: {}}
    apart = {}
    failed = set()
    one_term_refused = {}
    timed = []
    for label, names, B, S, causal, with_glse, D in BWD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            gen = check_gen(torch, dev, f"attention_bwd {label} {dtype}")
            ins = _bwd_inputs(torch, gen, dev, B, S, dtype, causal,
                              with_glse, D=D)
            for name in names:
                got, want = _bwd_call(name, *ins, causal)
                again, _ = _bwd_call(name, *ins, causal)
                if dtype == torch.bfloat16:
                    got32, want32 = _bwd_call(
                        name, *(t.float() for t in ins), causal)
                torch.cuda.synchronize()
                n_failed = len(FAILED_CHECKS)
                for key, g in got.items():
                    tag = f"{name} {label} {dtype} {key}"
                    if not torch.isfinite(g).all():
                        raise AssertionError(f"{tag}: non-finite output")
                    if not torch.equal(g, again[key]):
                        raise AssertionError(f"{tag}: two runs differ")
                    if dtype == torch.float32:
                        e = check_close(tag, g, want[key], BWD_TOL)
                    elif name in BF16_BEFORE_ROUNDING:
                        e = check_rounded_from(tag, g, want32[key],
                                               BF16_ATOL[name])
                    else:
                        e = check_close(tag, g, want[key],
                                        BF16_ATOL[name], 0.0)
                    if dtype == torch.bfloat16:
                        a = apart.setdefault(name, {
                            "kernel": [0.0, 0.0],
                            "fp32_kernel_rounded": [0.0, 0.0]})
                        for part, out in (("kernel", g), (
                                "fp32_kernel_rounded",
                                got32[key].to(dtype))):
                            a[part] = [max(x, y) for x, y in zip(
                                a[part], bf16_apart(out, want[key]))]
                    errs[dtype][name] = max(errs[dtype].get(name, 0.0), e)
                if len(FAILED_CHECKS) > n_failed:
                    failed.add(name)
                if dtype == torch.bfloat16 and name in BF16_BEFORE_ROUNDING:
                    one = bf16_terms_bwd(torch, name, 1, *ins, causal)
                    if not all(rounded_from(one[key], want32[key],
                                            BF16_ATOL[name]) for key in one):
                        one_term_refused.setdefault(name, []).append(label)
                if dtype == torch.float32 and label in BWD_TIMED:
                    timed.append((name, label, B, S, causal, ins))
    for name in TRAINING_KERNELS:
        if name not in one_term_refused:
            raise AssertionError(f"{name}: the bf16 check passes one-term "
                                 f"bf16 P/dS in every case")
    for name, label, B, S, causal, ins in timed:
        from paddle_tpu_torch.ops.kernels import attention as A
        q, k, v, do, lse, delta = ins
        fn = getattr(A, name)
        if name == "folded_attention_bwd":
            call = lambda: fn(q, k, v, do, causal)  # noqa: E731
            plain_ms = timer(lambda: A.folded_bwd_reference(q, k, v, do,
                                                            causal))
        else:
            call = lambda: fn(q, k, v, do, lse, delta, causal)  # noqa: E731
            plain_ms = timer(lambda: A.attention_bwd_reference(
                q, k, v, do, lse, delta, causal))
        ms = timer(call)
        lib_ms, backend = _sdpa_bwd_ms(torch, timer, q, k, v, do, causal)
        H, D = q.shape[2], q.shape[3]
        pairs = S * (S + 1) // 2 if causal else S * S
        rd, wr, st = BWD_ROWS[name]
        nbytes = (rd + wr) * B * S * H * D * 4 + st * B * S * H * 4
        b, by = bound_ms(nbytes, BWD_FLOPS[name] * B * H * pairs * D)
        rec = dict(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                   library_ms=lib_ms,
                   shape=f"B={B} S={S} H={H} D={D} {label} fp32",
                   per_launch_ms=profile_once(torch, call)["top_kernels_ms"])
        if name in records:  # a second timed shape of the kernel
            records[name].setdefault("per_shape", []).append(rec)
        else:
            records[name] = dict(max_abs_err=errs[torch.float32][name],
                                 **rec)
        emit({"phase": "kernels", "kernel": name, "ok": name not in failed,
              **rec, "max_abs_err": errs[torch.float32][name],
              "tol": BWD_TOL,
              "bf16_max_abs_err": errs[torch.bfloat16][name],
              "bf16_atol": BF16_ATOL[name],
              "bf16_before_rounding": name in BF16_BEFORE_ROUNDING,
              "bf16_one_term_refused": one_term_refused.get(name),
              "bf16_apart": apart[name],
              "library": f"SDPA backward ({backend}), dQ+dK+dV",
              "cases": [c[0] for c in BWD_CASES if name in c[1]]})


# (label, N, H, W, C, M): the two shapes ResNet-50's main path gives the
# kernel at 224x224 and N=128 (layer1 and layer2), small ones whose tiles
# have masked edges (M=8 C=32, a non-square 6x5 plane), and at N=1 the
# layer2, layer3 and layer4 blocks of a 896x896 input, which the gate
# admits and the first, FMA kernel could not place in 227 KB
FB_CASES = (
    ("layer1 56x56", 128, 56, 56, 256, 64),
    ("layer2 28x28", 128, 28, 28, 512, 128),
    ("M=8 C=32 28x28", 2, 28, 28, 32, 8),
    ("6x5", 2, 6, 5, 32, 8),
    ("896 layer2 112x112", 1, 112, 112, 512, 128),
    ("896 layer3 56x56", 1, 56, 56, 1024, 256),
    ("896 layer4 28x28", 1, 28, 28, 2048, 512),
)
FB_TOL = 1e-4


def _fb_params(torch, gen, dev, c, m, dtype):
    """Packed weights of the Kaiming scale a folded block has, and f32
    biases: ``(w1 [C, M], b1, w2 [9M, M], b2, w3 [M, C], b3)``."""
    def draw(shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale
    return (draw((c, m), (2.0 / c) ** 0.5).to(dtype), draw((1, m), 0.1),
            draw((9 * m, m), (2.0 / (9 * m)) ** 0.5).to(dtype),
            draw((1, m), 0.1), draw((m, c), (1.0 / m) ** 0.5).to(dtype),
            draw((1, c), 0.1))


def _fb_chain(torch, w1, b1, w2, b2, w3, b3):
    """The library yardstick: the unfused block on the same folded
    weights, three ``F.conv2d`` (cuDNN, NHWC memory) with the bias, relu
    and residual epilogues, in the weights' dtype. Returns ``fn(x)``."""
    import torch.nn.functional as F
    c, m = w1.shape
    k1 = w1.t().reshape(m, c, 1, 1).contiguous()
    k2 = w2.reshape(3, 3, m, m).permute(3, 2, 0, 1).contiguous()
    k3 = w3.t().reshape(c, m, 1, 1).contiguous()
    bb1, bb2, bb3 = (b[0].to(w1.dtype) for b in (b1, b2, b3))

    def fn(x):
        xc = x.permute(0, 3, 1, 2)
        y1 = torch.relu(F.conv2d(xc, k1, bb1))
        y2 = torch.relu(F.conv2d(y1, k2, bb2, padding=1))
        return torch.relu(F.conv2d(y2, k3, bb3) + xc).permute(0, 2, 3, 1)
    return fn


def _fb_config(torch, FC, dev, n, h, w, c, m, dtype):
    """The kernel's launch configuration for these inputs (the wrapper's
    own choice) and its inputs to the line. The blocks an SM holds by the
    CUDA occupancy API must be the configuration's (the tile choice
    weighs them): fewer raises."""
    cfg = FC.fused_bottleneck_config(
        h, w, c, m, dtype, n,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    blocks = FC.fused_bottleneck_occupancy(cfg.smem, dtype)
    if blocks < cfg.blocks_per_sm:
        raise AssertionError(f"fused_bottleneck {h}x{w} M={m} {dtype}: the "
                             f"card holds {blocks} blocks an SM, the tile "
                             f"choice assumed {cfg.blocks_per_sm}")
    return cfg, dict(tile_rows=cfg.tr, tile_cols=cfg.tc, strips=cfg.strips,
                     col_tiles=cfg.col_tiles, smem_bytes=cfg.smem,
                     blocks_per_sm_input=cfg.blocks_per_sm,
                     blocks_per_sm=blocks, halo_share_input=cfg.halo_share)


def kernel_fused_bottleneck(torch, timer, dev, records):
    """The fused bottleneck on ``FB_CASES`` and the delta image of
    ``tests/test_fused_conv_block.py`` (edge columns), against its plain
    version and against the plain emulation of its tiles
    (``fused_bottleneck_strip_emulation``, the same configuration): fp32
    within atol/rtol ``FB_TOL``, twice with the same bits; bf16 within
    ``BF16_ULPS`` ulps of the largest output (absolute). Timed at the two
    ResNet-50 shapes in fp32 and bf16 beside the plain version and the
    unfused cuDNN chain in the same dtype, with its device kernels a call
    counted under ``torch.profiler``."""
    from paddle_tpu_torch.ops.kernels import fused_conv_block as FC
    cases = list(FB_CASES) + [("delta 4x4", 1, 4, 4, 32, 8)]
    errs = {"fp32": 0.0, "bf16": 0.0}
    bf16_limits = {}
    configs = {}
    per_shape = []
    for label, n, h, w, c, m in cases:
        gen = check_gen(torch, dev, f"fused_bottleneck {label}")
        params32 = _fb_params(torch, gen, dev, c, m, torch.float32)
        if label.startswith("delta"):
            x32 = torch.zeros((n, h, w, c), device=dev)
            x32[0, 1, 0] = 1.0
            x32[0, 2, 3] = -1.0
        else:
            x32 = torch.randn((n, h, w, c), generator=gen, device=dev)
        for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            x = x32.to(dtype)
            params = tuple(p.to(dtype) if i % 2 == 0 else p
                           for i, p in enumerate(params32))
            cfg, inputs = _fb_config(torch, FC, dev, n, h, w, c, m, dtype)
            configs[f"{label} {tag}"] = inputs
            got = FC.fused_bottleneck_eval(x, *params)
            want = FC.fused_bottleneck_reference(x, *params)
            tiles = FC.fused_bottleneck_strip_emulation(x, *params,
                                                        config=cfg)
            torch.cuda.synchronize()
            name = f"fused_bottleneck {label} {tag}"
            if not torch.isfinite(got).all():
                raise AssertionError(f"{name}: non-finite output")
            if tag == "fp32":
                e = check_close(name, got, want, FB_TOL)
                check_close(f"{name} vs tile emulation", got, tiles, FB_TOL)
                if not torch.equal(got, FC.fused_bottleneck_eval(x, *params)):
                    raise AssertionError(f"{name}: two runs differ")
            else:
                lim = bf16_limit(0.0, want)
                bf16_limits[label] = lim
                e = check_close(name, got, want, lim, 0.0)
                check_close(f"{name} vs tile emulation", got, tiles,
                            bf16_limit(0.0, tiles), 0.0)
            errs[tag] = max(errs[tag], e)
        if n != RESNET_BATCH:  # only the main path's shapes are timed
            continue
        for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            x = x32.to(dtype)
            params = tuple(p.to(dtype) if i % 2 == 0 else p
                           for i, p in enumerate(params32))
            chain = _fb_chain(torch, *params)
            want = FC.fused_bottleneck_reference(x, *params)
            if tag == "fp32":
                chain_err = check_close(f"cuDNN chain {label}", chain(x),
                                        want, FB_TOL)
            else:  # a yardstick of speed, rounded in its own places
                chain_err = max_err(chain(x), want)
            ms = timer(lambda: FC.fused_bottleneck_eval(x, *params))
            plain_ms = timer(lambda: FC.fused_bottleneck_reference(x, *params))
            lib_ms = timer(lambda: chain(x))
            item = x.element_size()
            nbytes = (2 * x.numel() + 2 * c * m + 9 * m * m) * item \
                + (2 * m + c) * 4
            b, by = bound_ms(nbytes, 2 * n * h * w * (2 * c * m + 9 * m * m),
                             tag)
            prof = profile_once(
                torch, lambda: FC.fused_bottleneck_eval(x, *params),
                (("fused_bottleneck", ("bottleneck_kernel",)),))
            rec = dict(label=label, dtype=tag, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=b, bound_by=by,
                       bound_share=b / ms, chain_max_abs_err=chain_err,
                       launches_per_call=prof["kernels"],
                       kernels_in_call=[k for k, _ in prof["top_kernels_ms"]],
                       **configs[f"{label} {tag}"])
            per_shape.append(rec)
            emit({"phase": "kernels", "kernel": "fused_bottleneck", "ok": True,
                  "shape": f"N={n} H={h} W={w} C={c} M={m} {tag}", **rec})
    first = per_shape[0]
    records["fused_bottleneck"] = dict(
        max_abs_err=errs["fp32"], ms=first["ms"], plain_ms=first["plain_ms"],
        bound_ms=first["bound_ms"], bound_by=first["bound_by"],
        library_ms=first["library_ms"], shape="N=128 56x56 C=256 M=64 fp32",
        per_shape=per_shape)
    emit({"phase": "kernels", "kernel": "fused_bottleneck", "ok": True,
          "max_abs_err": errs["fp32"], "tol": FB_TOL,
          "bf16_max_abs_err": errs["bf16"], "bf16_atol": bf16_limits,
          "library": "chain of 3 F.conv2d (cuDNN) + bias/relu/residual "
                     "epilogues, not one call",
          "cases": [c[0] for c in cases], "configs": configs,
          "checks": "plain version, tile emulation, fp32 repeat bitwise"})


# GPT-1.3B's parameter shapes of one block (E=2048: ln_1, qkv_proj,
# out_proj, ln_2, fc_in, fc_out, weights and biases; 50.3M elements),
# and a ragged list: a bias, an odd length, an empty tensor, a small
# matrix
ADAM_BLOCK_SHAPES = ((2048,), (2048,), (2048, 6144), (6144,), (2048, 2048),
                     (2048,), (2048,), (2048,), (2048, 8192), (8192,),
                     (8192, 2048), (2048,))
ADAM_RAGGED_SHAPES = ((2048,), (1001,), (0,), (3, 5))
# (label, param dtype, slot dtype): the kernel's three storage variants
ADAM_VARIANTS = (("fp32", "float32", "float32"),
                 ("bf16", "bfloat16", "bfloat16"),
                 ("bf16 params fp32 slots", "bfloat16", "float32"))
ADAM_STEPS = 3
ADAM_LR, ADAM_WD = 1e-4, 0.01


def adam_bytes(n, p_size, s_size):
    """Bytes of one update of ``n`` elements: p, g, m, v read once, p, m,
    v written once (the gradient has the parameter's dtype)."""
    return n * (3 * p_size + 4 * s_size)


def _adam_state(torch, gen, dev, shapes, pdt, sdt):
    """Seeded parameters (N(0, 0.02)), zero moments, and ``ADAM_STEPS``
    gradient lists (N(0, 1e-3))."""
    params = [(torch.randn(s, generator=gen, device=dev) * 0.02).to(pdt)
              for s in shapes]
    grads = [[(torch.randn(s, generator=gen, device=dev) * 1e-3).to(pdt)
              for s in shapes] for _ in range(ADAM_STEPS)]
    m = [torch.zeros(s, dtype=sdt, device=dev) for s in shapes]
    v = [torch.zeros(s, dtype=sdt, device=dev) for s in shapes]
    return params, grads, m, v


def kernel_adam(torch, timer, dev, records):
    """adam_update (the port's own kernel) against its plain version, the
    eager chain, on the card: each storage variant (``ADAM_VARIANTS``) x
    each decay (AdamW's decoupled, Adam's L2, none), on a GPT-1.3B
    block's shapes plus a ragged list, ``ADAM_STEPS`` steps: parameters
    and both moments bitwise equal; the list in one call against one call
    a tensor: bitwise equal, one launch against one a non-empty tensor.
    Then each variant timed on the block's shapes (AdamW) beside the
    plain chain and ``torch.optim.AdamW(foreach=True)`` over the same
    list, with the device kernels of one call under ``torch.profiler``."""
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import optimizer_update as OU
    if _build.lib().pt_adam_update_max_tensors() != OU.MAX_TENSORS:
        raise AssertionError("adam_update: the wrapper's MAX_TENSORS is not "
                             "the kernel's")
    decays = (("AdamW", OU.DECAY_DECOUPLED), ("Adam L2", OU.DECAY_L2),
              ("no decay", OU.DECAY_NONE))
    shapes = ADAM_BLOCK_SHAPES + ADAM_RAGGED_SHAPES
    live = sum(1 for s in shapes if math.prod(s) > 0)
    checks = []
    for label, pname, sname in ADAM_VARIANTS:
        pdt, sdt = getattr(torch, pname), getattr(torch, sname)
        for dname, decay in decays:
            tag = f"adam_update {label} {dname}"
            gen = check_gen(torch, dev, tag)
            p, grads, m, v = _adam_state(torch, gen, dev, shapes, pdt, sdt)
            lists = {"kernel": (p, m, v),
                     "plain": tuple([t.clone() for t in ts]
                                    for ts in (p, m, v)),
                     "per tensor": tuple([t.clone() for t in ts]
                                         for ts in (p, m, v))}
            launched = {}
            for step in range(1, ADAM_STEPS + 1):
                hyper = dict(lr=ADAM_LR, beta1=0.9, beta2=0.999, eps=1e-8,
                             step=step, weight_decay=ADAM_WD, decay=decay)
                g = grads[step - 1]
                OU.adam_update_reference(*lists["plain"][:1], g,
                                         *lists["plain"][1:], **hyper)
                before = OU.adam_update.launches
                OU.adam_update(lists["kernel"][0], g, *lists["kernel"][1:],
                               **hyper)
                launched["list"] = OU.adam_update.launches - before
                before = OU.adam_update.launches
                for i in range(len(shapes)):
                    pt_, mt, vt = (ts[i] for ts in lists["per tensor"])
                    OU.adam_update([pt_], [g[i]], [mt], [vt], **hyper)
                launched["per tensor"] = OU.adam_update.launches - before
            torch.cuda.synchronize()
            for other in ("plain", "per tensor"):
                for what, got, want in zip(("param", "moment1", "moment2"),
                                           lists["kernel"], lists[other]):
                    for i, (a, b) in enumerate(zip(got, want)):
                        check_equal(f"{tag} {what} {i} vs {other}", a, b)
            if launched != {"list": 1, "per tensor": live}:
                FAILED_CHECKS.append(f"{tag}: launches {launched}, want 1 "
                                     f"for the list and {live} one by one")
            checks.append(tag)
    # more tensors than one launch's table: two launches, same bits
    tag = "adam_update fp32 AdamW, MAX_TENSORS + 88 tensors"
    gen = check_gen(torch, dev, tag)
    many = [(1 + (37 * i) % 301,) for i in range(OU.MAX_TENSORS + 88)]
    p, grads, m, v = _adam_state(torch, gen, dev, many, torch.float32,
                                 torch.float32)
    ref = [[t.clone() for t in ts] for ts in (p, m, v)]
    hyper = dict(lr=ADAM_LR, beta1=0.9, beta2=0.999, eps=1e-8, step=1,
                 weight_decay=ADAM_WD, decay=OU.DECAY_DECOUPLED)
    before = OU.adam_update.launches
    OU.adam_update(p, grads[0], m, v, **hyper)
    if OU.adam_update.launches - before != 2:
        FAILED_CHECKS.append(f"{tag}: {OU.adam_update.launches - before} "
                             f"launches, want 2")
    OU.adam_update_reference(ref[0], grads[0], ref[1], ref[2], **hyper)
    for what, got, want in zip(("param", "moment1", "moment2"), (p, m, v),
                               ref):
        check_equal(f"{tag} {what}", torch.cat(got), torch.cat(want))
    checks.append(tag)
    del p, grads, m, v, ref
    per_variant = []
    n = sum(math.prod(s) for s in ADAM_BLOCK_SHAPES)
    for label, pname, sname in ADAM_VARIANTS:
        pdt, sdt = getattr(torch, pname), getattr(torch, sname)
        gen = check_gen(torch, dev, f"adam_update timing {label}")
        p, grads, m, v = _adam_state(torch, gen, dev, ADAM_BLOCK_SHAPES,
                                     pdt, sdt)
        g = grads[0]
        hyper = dict(lr=ADAM_LR, beta1=0.9, beta2=0.999, eps=1e-8, step=1,
                     weight_decay=ADAM_WD, decay=OU.DECAY_DECOUPLED)
        ms = timer(lambda: OU.adam_update(p, g, m, v, **hyper))
        plain_ms = timer(lambda: OU.adam_update_reference(p, g, m, v,
                                                          **hyper))
        lib_ms = None
        if pdt == sdt:  # torch.optim keeps the moments in the param dtype
            lp = [t.clone().requires_grad_() for t in p]
            for t, gt in zip(lp, g):
                t.grad = gt.clone()
            opt = torch.optim.AdamW(lp, lr=ADAM_LR, weight_decay=ADAM_WD,
                                    foreach=True)
            lib_ms = timer(opt.step)
            del lp, opt
        calls, windows = 3, 1

        def three():
            for _ in range(calls):
                OU.adam_update(p, g, m, v, **hyper)

        prof = profile_once(torch, three)
        if prof["kernels"] == 0:  # a window the profiler recorded nothing
            windows += 1          # in (seen once, run 1): once more
            prof = profile_once(torch, three)
        if prof["kernels"] != calls:
            FAILED_CHECKS.append(f"adam_update {label}: {prof['kernels']} "
                                 f"device kernels in {calls} calls")
        b, by = bound_ms(adam_bytes(n, p[0].element_size(),
                                    m[0].element_size()), 0.0)
        per_variant.append(dict(variant=label, ms=ms, plain_ms=plain_ms,
                                library_ms=lib_ms, bound_ms=b, bound_by=by,
                                launches_per_call=prof["kernels"] / calls,
                                profile_windows=windows))
        emit({"phase": "kernels", "kernel": "adam_update", "ok": True,
              "shape": f"GPT-1.3B block, {len(ADAM_BLOCK_SHAPES)} tensors, "
                       f"{n} elements, {label}", **per_variant[-1]})
        del p, grads, m, v, g
    first = per_variant[0]
    records["adam_update"] = dict(
        max_abs_err=0.0, ms=first["ms"], plain_ms=first["plain_ms"],
        bound_ms=first["bound_ms"], bound_by=first["bound_by"],
        library_ms=first["library_ms"], per_variant=per_variant)
    emit({"phase": "kernels", "kernel": "adam_update", "ok": True,
          "checks": checks, "steps": ADAM_STEPS, "bitwise": True,
          "max_tensors_a_launch": OU.MAX_TENSORS,
          "library": "torch.optim.AdamW(foreach=True)"})


def phase_kernels(torch, dev, records):
    timer = Timer(torch, dev)
    # the window's own floor: one launch that does almost nothing
    tiny = torch.zeros(1, device=dev)
    emit({"phase": "timer", "ok": True, "flush": "read 64 MB",
          "spin_cycles_per_ms": timer.cycles_per_ms,
          "one_element_add_ms": timer(lambda: tiny.add_(1.0))})
    for fn in (kernel_paged, kernel_out_proj, kernel_argmax,
               kernel_attention):
        fn(torch, timer, dev, check_gen(torch, dev, fn.__name__), records)
    kernels_bf16(torch, dev)
    kernel_attention_bwd(torch, timer, dev, records)
    kernel_fused_bottleneck(torch, timer, dev, records)
    kernel_adam(torch, timer, dev, records)
    torch.cuda.synchronize()


# -- phase 4 -----------------------------------------------------------------

def rel_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max().item()
                 / max(b.float().abs().max().item(), 1e-30))


def path_outputs(torch, model, prompt, plain: bool, first_token=None,
                 fused: bool = True, quantized: bool = False):
    """Prefill ``prompt`` into a fresh paged cache and decode one token,
    through the kernels or (``plain``) their plain versions, as the
    engine does with ``fused_step=fused`` and ``kv_int8=quantized``.
    Returns (prefill hidden, last-row logits, first token, decode
    hidden, decode logits)."""
    from paddle_tpu_torch.models.gpt import paged_cache_create
    from paddle_tpu_torch.nn.decode import fused_sample_token, sample_token
    from paddle_tpu_torch.ops.nn_functional import plain_kernels
    cfg = model.config
    dev = model.device
    page = 64
    mp = -(-cfg.max_seq_len // page)
    n = len(prompt)
    caches = [paged_cache_create(1, mp, page, cfg.num_heads, cfg.head_dim,
                                 torch.float32, mp, quantized=quantized,
                                 device=dev)
              for _ in range(cfg.num_layers)]
    ids = torch.tensor(prompt, dtype=torch.int64, device=dev)[None]
    plen = torch.tensor([n], dtype=torch.int32, device=dev)
    ctx = plain_kernels() if plain else contextlib.nullcontext()
    w, ty, bias = model.head_params()
    with ctx, torch.no_grad():
        hidden, caches = model.decode_hidden(ids, caches, prefill_lens=plen,
                                             fused=fused)
        last = hidden[:, n - 1].contiguous()
        logits = model.logits(last)
        if fused:
            tok = fused_sample_token(last, w, 0.0, transpose_y=ty,
                                     bias=bias)
        else:
            tok = sample_token(logits, 0.0)
        if first_token is not None:
            tok = first_token
        h2, _ = model.decode_hidden(tok[:, None].long(), caches,
                                    fused=fused)
        last2 = h2[:, -1].contiguous()
        logits2 = model.logits(last2)
    return hidden[:, :n], logits, tok, last2, logits2


def run_engine(torch, model, prompts, max_new, plain: bool,
               **engine_kw):
    from paddle_tpu_torch.inference import create_decode_engine
    from paddle_tpu_torch.ops.nn_functional import plain_kernels
    eng = create_decode_engine(model, device=model.device, num_slots=8,
                               page_size=64, num_pages=96, **engine_kw)
    ctx = plain_kernels() if plain else contextlib.nullcontext()
    with ctx:
        rids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        res = eng.run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    eng.check_no_leak()
    outs = [res[r][len(p):].tolist() for r, p in zip(rids, prompts)]
    decode_ms = sorted(e["decode_ms"] for e in eng.step_timeline()
                       if "decode_ms" in e)
    info = {"wall_s": wall, "steps": eng.steps,
            "decode_step_ms_median": decode_ms[len(decode_ms) // 2],
            "prefill_launches": eng.programs_launched.get("prefill", 0),
            "tokens_per_s": sum(len(o) for o in outs) / wall}
    eng.close()
    return outs, info


def profile_decode_steps(torch, model):
    """Device time vs host time of steady decode steps at 8 slots
    (torch.profiler; the eager launch overhead of this slice)."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.inference import create_decode_engine
    eng = create_decode_engine(model, device=model.device, num_slots=8,
                               page_size=64)
    gen = torch.Generator().manual_seed(1)
    for n in (300, 500, 700, 900, 1100, 1300, 1500, 1700):
        eng.submit(torch.randint(0, model.config.vocab_size, (n,),
                                 generator=gen).numpy(), max_new_tokens=40)
    for _ in range(6):  # admissions + warm decode steps
        eng.step()
    torch.cuda.synchronize()
    steps = 10
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3 / steps
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) is not None
               and str(e.device_type).endswith("CUDA")]
    dev_us = sum(e.time_range.elapsed_us() for e in kernels)
    paged_us = sum(e.time_range.elapsed_us() for e in kernels
                   if "paged_decode" in e.name)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    eng.close()
    return {"decode_step_wall_ms": wall_ms,
            "device_kernel_ms_per_step": dev_us / 1e3 / steps,
            "device_kernels_per_step": len(kernels) / steps,
            "paged_decode_ms_per_step": paged_us / 1e3 / steps,
            "idle_share": (1.0 - (dev_us / 1e3 / steps) / wall_ms)
            if wall_ms else None,
            "top_kernels_ms_per_step": [
                [name[:60], us / 1e3 / steps] for name, us in top]}


def phase_engine(torch, dev, records, launches):
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_1p3b
    from paddle_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    t0 = time.monotonic()
    model = GPTForCausalLM(gpt_1p3b(), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(0))
    model.eval()
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    V = model.config.vocab_size
    gen = torch.Generator().manual_seed(0)

    # kernel path vs plain path on the card: prefill buckets reaching
    # folded (128), flash single-block (512) and flash streaming (1024)
    parity = []
    for n in (128, 512, 1024):
        prompt = torch.randint(0, V, (n,), generator=gen).tolist()
        hk, lk, tk, h2k, l2k = path_outputs(torch, model, prompt, False)
        hp, lp, tp, h2p, l2p = path_outputs(torch, model, prompt, True,
                                            first_token=tk)
        rec = {"bucket": n, "prefill_hidden_rel": rel_err(hk, hp),
               "prefill_logits_rel": rel_err(lk, lp),
               "decode_hidden_rel": rel_err(h2k, h2p),
               "decode_logits_rel": rel_err(l2k, l2p),
               "first_token_equal": bool(torch.equal(tk, tp))}
        parity.append(rec)
        for key in ("prefill_hidden_rel", "prefill_logits_rel",
                    "decode_hidden_rel", "decode_logits_rel"):
            if not rec[key] <= MODEL_REL_TOL:
                raise AssertionError(f"engine parity bucket {n}: {key} "
                                     f"{rec[key]:.3g} > {MODEL_REL_TOL}")
    emit({"phase": "engine_parity", "ok": True, "tol_rel": MODEL_REL_TOL,
          "cases": parity})

    # the main path: every prefill bucket, page recycling (96 pages:
    # the 8th request waits for pages freed by the first seven)
    lengths = (40, 100, 200, 400, 900, 1500, 2000, 600)
    prompts = [torch.randint(0, V, (n,), generator=gen).numpy()
               for n in lengths]
    max_new = 32
    reset_launch_counts()
    outs, info = run_engine(torch, model, prompts, max_new, plain=False)
    counts = launch_counts()
    launches.update({name: counts[name] for name in SERVING_KERNELS})
    for name in SERVING_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"serving path")
    for name in TRAINING_KERNELS + ("fused_bottleneck",):
        if counts[name] != 0:
            raise AssertionError(f"kernel {name} launched {counts[name]} "
                                 f"times while serving")
    for o in outs:
        if len(o) != max_new or not all(0 <= t < V for t in o):
            raise AssertionError(f"bad generation {o[:8]}...")
    outs_plain, info_plain = run_engine(torch, model, prompts, max_new,
                                        plain=True)
    agree = sum(a == b for oa, ob in zip(outs, outs_plain)
                for a, b in zip(oa, ob)) / float(len(lengths) * max_new)
    first_agree = sum(oa[0] == ob[0] for oa, ob in
                      zip(outs, outs_plain)) / float(len(lengths))
    prof = profile_decode_steps(torch, model)
    emit({"phase": "engine", "ok": True, "model": "gpt_1p3b",
          "model_build_s": build_s, "prompt_lengths": list(lengths),
          "max_new_tokens": max_new, "launches": dict(launches),
          "kernel_path": info, "plain_path": info_plain,
          "token_agreement": agree, "first_token_agreement": first_agree,
          "decode_profile": prof,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    engine_variants(torch, model, gen)
    return model


def engine_variants(torch, model, gen):
    """The engine's two other kernel paths, each against its plain run
    on the card: ``fused_step=False`` (unfused paged attention, the
    out-projection as a GEMM, argmax over the logits; the fused
    kernels must stay at 0 launches) and ``kv_int8`` (int8 pages
    through the fused path)."""
    from paddle_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    V = model.config.vocab_size
    variants = (
        ("fused_step=False", dict(fused_step=False),
         ("paged_decode", "attention_fwd"),
         ("decode_out_proj", "fused_argmax")),
        ("kv_int8", dict(kv_int8=True), SERVING_KERNELS, ()),
    )
    max_new = 8
    for tag, kw, used, unused in variants:
        fused = kw.get("fused_step", True)
        int8 = kw.get("kv_int8", False)
        prompt = torch.randint(0, V, (512,), generator=gen).tolist()
        hk, lk, tk, h2k, l2k = path_outputs(torch, model, prompt, False,
                                            fused=fused, quantized=int8)
        hp, lp, tp, h2p, l2p = path_outputs(torch, model, prompt, True,
                                            first_token=tk, fused=fused,
                                            quantized=int8)
        rec = {"prefill_hidden_rel": rel_err(hk, hp),
               "prefill_logits_rel": rel_err(lk, lp),
               "decode_hidden_rel": rel_err(h2k, h2p),
               "decode_logits_rel": rel_err(l2k, l2p)}
        for key, val in rec.items():
            if not val <= MODEL_REL_TOL:
                raise AssertionError(f"{tag} parity: {key} {val:.3g} > "
                                     f"{MODEL_REL_TOL}")
        prompts = [torch.randint(0, V, (n,), generator=gen).numpy()
                   for n in (100, 600, 1100)]
        reset_launch_counts()
        outs, info = run_engine(torch, model, prompts, max_new,
                                plain=False, **kw)
        counts = launch_counts()
        for name in used:
            if counts[name] <= 0:
                raise AssertionError(f"{tag}: kernel {name} was not "
                                     f"launched")
        for name in unused:
            if counts[name] != 0:
                raise AssertionError(f"{tag}: kernel {name} launched "
                                     f"{counts[name]} times off its path")
        for o in outs:
            if len(o) != max_new or not all(0 <= t < V for t in o):
                raise AssertionError(f"{tag}: bad generation {o}")
        outs_plain, _ = run_engine(torch, model, prompts, max_new,
                                   plain=True, **kw)
        agree = sum(a == b for oa, ob in zip(outs, outs_plain)
                    for a, b in zip(oa, ob)) / float(len(prompts) * max_new)
        emit({"phase": "engine_variant", "ok": True, "variant": tag,
              "tol_rel": MODEL_REL_TOL, "parity_bucket": 512, **rec,
              "first_token_equal": bool(torch.equal(tk, tp)),
              "prompt_lengths": [len(p) for p in prompts],
              "launches": counts, "token_agreement": agree,
              "decode_step_ms_median": info["decode_step_ms_median"]})


# -- phase 5 -----------------------------------------------------------------

def phase_server(torch, dev, model):
    from paddle_tpu_torch.serving.server import ServingServer, client_request
    V = model.config.vocab_size
    gen = torch.Generator().manual_seed(2)
    server = ServingServer(model, device=dev, num_slots=8, page_size=64,
                           num_pages=96)
    port = server.start()
    replies = [None] * 4
    streamed = [[] for _ in range(4)]
    lengths = (50, 300, 700, 1200)

    def one(i):
        prompt = torch.randint(0, V, (lengths[i],), generator=gen).tolist()
        replies[i] = client_request(
            "127.0.0.1", port,
            {"op": "generate", "prompt": prompt, "max_new_tokens": 16,
             "stream": i < 2}, timeout_s=300,
            on_token=streamed[i].append)

    try:
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        for i, r in enumerate(replies):
            if not r or not r.get("done") or len(r["generated"]) != 16:
                raise AssertionError(f"generate {i}: {r}")
            if i < 2 and streamed[i] != r["generated"]:
                raise AssertionError(f"stream {i} != reply")
        health = client_request("127.0.0.1", port, {"op": "health"})
        stats = client_request("127.0.0.1", port, {"op": "stats"})
        drain = client_request("127.0.0.1", port, {"op": "drain"})
        late = client_request("127.0.0.1", port,
                              {"op": "generate", "prompt": [1, 2, 3]})
        leak = client_request("127.0.0.1", port, {"op": "leak_check"})
        if health.get("status") != "ok" or "stats" not in stats or \
                not drain.get("ok") or \
                late.get("error") != "ServerDraining" or \
                not leak.get("ok"):
            raise AssertionError(f"server ops: {health} {drain} {late} "
                                 f"{leak}")
        emit({"phase": "server", "ok": True,
              "ttft_ms": [r["stats"].get("ttft_s", 0) * 1e3
                          for r in replies],
              "tokens_out": [len(r["generated"]) for r in replies],
              "health": {k: health[k] for k in ("status", "free_pages",
                                                "num_pages", "steps")},
              "leak_check": leak.get("ok")})
    finally:
        server.stop()


# -- phase 6 -----------------------------------------------------------------

def _train_model(torch, dev, **cfg_kw):
    """GPT-1.3B as ``bench.py`` trains it (fp32, dropout 0), seed-0
    weights; ``cfg_kw`` overrides fields (depth, remat, loss chunks)."""
    import dataclasses
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_1p3b
    cfg = dataclasses.replace(gpt_1p3b(dropout=0.0, attn_dropout=0.0),
                              **cfg_kw)
    return GPTForCausalLM(cfg, device=dev,
                          generator=torch.Generator(device=dev)
                          .manual_seed(0))


def _loss_and_grads(torch, model, ids, plain: bool):
    """One forward+backward of the next-token loss through the kernels
    or (``plain``) their plain versions; returns (loss, {name: grad})."""
    from paddle_tpu_torch.ops.nn_functional import plain_kernels
    model.train()
    model.zero_grad(set_to_none=True)
    with plain_kernels(plain):
        loss = model(ids, labels=ids)
        loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads


def _grad_rel(got, want):
    """Relative L2 error of every parameter's gradient."""
    return {n: float((got[n].float() - w.float()).norm()
                     / w.float().norm().clamp_min(1e-30))
            for n, w in want.items()}


def _check_train_parity(tag, loss_k, loss_p, errs):
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    worst = max(errs, key=errs.get)
    if not loss_rel <= LOSS_REL_TOL:
        raise AssertionError(f"{tag}: loss {float(loss_k)} vs plain "
                             f"{float(loss_p)} ({loss_rel:.3g} relative)")
    if not errs[worst] <= GRAD_REL_TOL:
        raise AssertionError(f"{tag}: gradient of {worst} off by "
                             f"{errs[worst]:.3g} relative")
    return {"loss_kernel": float(loss_k), "loss_plain": float(loss_p),
            "loss_rel": loss_rel, "grad_rel_max": errs[worst],
            "grad_rel_max_param": worst}


def _snapshot(torch, step):
    """Copies of the parameters, the optimizer's state (updated in place
    by each step) and the step's generator."""
    opt = {k: v.clone() if torch.is_tensor(v) else v
           for k, v in step.optimizer.state_dict().items()}
    return ({n: p.detach().clone()
             for n, p in step.model.named_parameters()},
            opt, step.generator.get_state())


def _restore(torch, step, snap):
    params, opt_state, gen_state = snap
    with torch.no_grad():
        for n, p in step.model.named_parameters():
            p.copy_(params[n])
    step.optimizer.set_state_dict(opt_state)
    step.generator.set_state(gen_state)


def _step_vs_plain(torch, step, ids):
    """One ``TrainStep`` through the kernels, then the same step from
    the same state through the plain versions; returns the parity
    record and the kernel step's launch counts."""
    from paddle_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from paddle_tpu_torch.ops.nn_functional import plain_kernels
    snap = _snapshot(torch, step)
    reset_launch_counts()
    loss_k = step(ids)
    torch.cuda.synchronize()
    counts = launch_counts()
    grads_k = {n: p.grad.clone() for n, p in step.model.named_parameters()}
    _restore(torch, step, snap)
    with plain_kernels():
        loss_p = step(ids)
    errs = _grad_rel(grads_k, {n: p.grad for n, p in
                               step.model.named_parameters()})
    return _check_train_parity("train step", loss_k, loss_p, errs), counts


# kernel-name substrings -> the group a train step's device time is
# summed under (first match wins)
TRAIN_KERNEL_GROUPS = (
    ("attention kernels", ("attention_fwd", "attention_bwd", "dq_reduce")),
    ("adam_update", ("adam_update",)),
    ("GEMM", ("gemm", "cutlass", "xmma", "nvjet")),
    ("softmax / CE", ("softmax", "nll", "gather", "scatter")),
    ("layer norm", ("layer_norm",)),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise",)),
)


def profile_once(torch, fn, groups=TRAIN_KERNEL_GROUPS):
    """One call of ``fn`` under ``torch.profiler``: wall time, device
    kernel time by group (``groups``: name substrings, first match wins)
    and by kernel, launches, and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) is not None
               and str(e.device_type).endswith("CUDA")]
    by_name, by_group = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        low = e.name.lower()
        group = next((g for g, keys in groups
                      if any(k in low for k in keys)), "other")
        by_group[group] = by_group.get(group, 0.0) + us
    dev_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_kernel_ms": dev_ms,
            "kernels": len(kernels),
            "idle_share": 1.0 - dev_ms / wall_ms,
            "by_group_ms": {g: us / 1e3 for g, us in sorted(
                by_group.items(), key=lambda kv: -kv[1])},
            "top_kernels_ms": [[n[:60], us / 1e3] for n, us in top]}


VARIANT_STEPS = 5  # kernel-path steps timed per 4-layer variant
# the kernels every full-depth train step launches (S=2048: the flash
# forward, the dQ and dK/dV passes, the optimizer update)
TRAIN_STEP_KERNELS = ("attention_fwd", "attention_bwd_dq",
                      "attention_bwd_dkv", "adam_update")


def _bit_sums(torch, state):
    """Each tensor of an optimizer ``state_dict`` summed as its integer
    bit patterns (int64): a fingerprint of the moments' bits that needs
    no second copy of them."""
    sums = []
    for _, t in sorted(state.items()):
        if torch.is_tensor(t):
            ity = torch.int32 if t.element_size() == 4 else torch.int16
            sums.append(t.view(ity).to(torch.int64).sum())
    return torch.stack(sums)


def _repeat_and_fused(torch, step, ids):
    """One step from one state three times: twice as it is, which must
    give the same bits, then under ``fuse_optimizer`` (each dtype group
    in one ``adam_update`` launch), which must give the same loss,
    parameters and moments (their bit sums, ``_bit_sums``) as the
    unfused step. Returns (True, the fused step's record); raises on a
    difference."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    model = step.model
    snap = _snapshot(torch, step)
    l1 = step(ids)
    p1 = {n: p.detach().clone() for n, p in model.named_parameters()}
    s1 = _bit_sums(torch, step.optimizer.state_dict())
    _restore(torch, step, snap)
    l2 = step(ids)
    if not (torch.equal(l1, l2) and all(
            torch.equal(p1[n], p) for n, p in model.named_parameters())):
        raise AssertionError("one train step from one state gave two "
                             "results")
    _restore(torch, step, snap)
    del snap
    reset_launch_counts()
    set_flags({"fuse_optimizer": True})
    try:
        l3 = step(ids)
    finally:
        set_flags({"fuse_optimizer": False})
    torch.cuda.synchronize()
    groups = len({(p.dtype, step.optimizer.state_dict()[f"{n}.moment1"]
                   .dtype) for n, p in model.named_parameters()})
    fused = {"adam_update_launches": launch_counts()["adam_update"],
             "dtype_groups": groups}
    same = torch.equal(l1, l3) and all(
        torch.equal(p1[n], p) for n, p in model.named_parameters()) and \
        torch.equal(s1, _bit_sums(torch, step.optimizer.state_dict()))
    if not same:
        raise AssertionError("the fuse_optimizer step differs from the "
                             "unfused step")
    if fused["adam_update_launches"] != groups:
        raise AssertionError(f"fuse_optimizer: {fused} (one launch a "
                             f"group)")
    fused["bitwise_equal_unfused"] = True
    return True, fused


def phase_train(torch, dev, launches):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from paddle_tpu_torch.optimizer import AdamW
    B, S = 2, 2048
    # (a) full depth, one forward+backward: kernels against plain
    model = _train_model(torch, dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    ids = torch.randint(0, model.config.vocab_size, (B, S), generator=gen,
                        device=dev)
    loss_k, grads_k = _loss_and_grads(torch, model, ids, plain=False)
    loss_p, grads_p = _loss_and_grads(torch, model, ids, plain=True)
    errs = _grad_rel(grads_k, grads_p)
    rec = _check_train_parity("train parity", loss_k, loss_p, errs)
    del grads_k, grads_p
    emit({"phase": "train_parity", "ok": True, "model": "gpt_1p3b",
          "layers": model.config.num_layers, "B": B, "S": S,
          "tol": {"loss_rel": LOSS_REL_TOL, "grad_rel": GRAD_REL_TOL},
          **rec, "grad_rel": {n: float(f"{e:.3g}")
                              for n, e in errs.items()}})

    # (b) the main path: TrainStep.multi_step on a repeated batch
    step = TrainStep(model, AdamW(learning_rate=TRAIN_LR), lambda m, x:
                     m(x, labels=x), seed=0, device=dev)
    first = float(step(ids))  # warm-up step: Adam slots allocated here
    n_steps = 6
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem_before = torch.cuda.memory_allocated()
    reset_launch_counts()
    t0 = time.monotonic()
    losses = step.multi_step(ids[None].expand(n_steps, B, S))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = losses.tolist()
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train losses do not fall: {first} "
                             f"{losses}")
    for name in TRAIN_STEP_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"training path")
    qkv_grads = [float(blk.attn.qkv_proj.weight.grad.norm())
                 for blk in model.gpt.h]
    if not all(math.isfinite(g) and g > 0.0 for g in qkv_grads):
        raise AssertionError(f"qkv_proj gradients: {qkv_grads}")
    same, fused = _repeat_and_fused(torch, step, ids)
    prof = profile_once(torch, lambda: step(ids))
    emit({"phase": "train", "ok": True, "model": "gpt_1p3b",
          "layers": model.config.num_layers, "B": B, "S": S,
          "optimizer": f"AdamW({TRAIN_LR})", "warmup_loss": first,
          "losses": losses, "ms_per_step": wall * 1e3 / n_steps,
          "tokens_per_s": B * S * n_steps / wall,
          "peak_mem_gb": peak / 1e9, "mem_before_gb": mem_before / 1e9,
          "launches": counts,
          "qkv_proj_grad_norm_min": min(qkv_grads),
          "repeat_step_bitwise_equal": same, "fuse_optimizer": fused,
          "step_profile": prof})
    for name in ("attention_bwd_dq", "attention_bwd_dkv", "adam_update"):
        launches[name] = counts[name]
    del step, model
    torch.cuda.empty_cache()

    # (c) the other backward kernels, (d) remat + chunked loss: one
    # step each through the kernels against the plain step, 4 layers
    variants = (("S=512", {}, 512, "attention_bwd_fused"),
                ("S=256", {}, 256, "folded_attention_bwd"),
                ("remat+loss_chunk_size=512 S=2048",
                 dict(remat=True, loss_chunk_size=512), 2048,
                 "attention_bwd_dq"),
                ("remat_save_attention+loss_chunk_size=512 S=2048",
                 dict(remat=True, remat_save_attention=True,
                      loss_chunk_size=512), 2048, "attention_bwd_dq"))
    for tag, kw, s, kernel in variants:
        model = _train_model(torch, dev, num_layers=4, **kw)
        step = TrainStep(model, AdamW(learning_rate=TRAIN_LR), lambda m, x:
                         m(x, labels=x), seed=0, device=dev)
        step(ids[:, :s])  # a first step, so Adam's moments are live
        rec, counts = _step_vs_plain(torch, step, ids[:, :s])
        if counts[kernel] <= 0:
            raise AssertionError(f"{tag}: kernel {kernel} not launched")
        if kernel in ("attention_bwd_fused", "folded_attention_bwd"):
            launches[kernel] = counts[kernel]
        if kw:  # the chunked loss against the full-logits loss
            with torch.no_grad():
                chunked = float(model(ids[:, :s], labels=ids[:, :s]))
                model.config.loss_chunk_size = 0
                full = float(model(ids[:, :s], labels=ids[:, :s]))
            rec["loss_rel_chunked_vs_full"] = abs(chunked - full) / full
            if not rec["loss_rel_chunked_vs_full"] <= LOSS_REL_TOL:
                raise AssertionError(f"{tag}: chunked loss {chunked} vs "
                                     f"full {full}")
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(VARIANT_STEPS):
            step(ids[:, :s])
        torch.cuda.synchronize()
        ms = (time.monotonic() - t0) * 1e3 / VARIANT_STEPS
        emit({"phase": "train_variant", "ok": True, "variant": tag,
              "layers": 4, "B": B, "S": s, **rec, "launches": counts,
              "ms_per_step": ms, "tokens_per_s": B * s / ms * 1e3})
        del step, model
        torch.cuda.empty_cache()
    remat_memory(torch, dev, ids)


REMAT_LAYERS = 4


def remat_memory(torch, dev, ids):
    """One forward+backward at 4 layers, B=2, S=2048, chunked loss, with
    no remat, remat and remat with saved attention, from the same seed-0
    weights: the saved-attention gradients bitwise equal to remat's,
    ``attention_fwd`` launched once a layer (remat: twice), and the peak
    memory above the step's start, and the memory the forward keeps for
    the backward, in between remat's and no remat's."""
    from paddle_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    runs = {}
    for tag, kw in (("no remat", {}), ("remat", dict(remat=True)),
                    ("remat_save_attention",
                     dict(remat=True, remat_save_attention=True))):
        model = _train_model(torch, dev, num_layers=REMAT_LAYERS,
                             loss_chunk_size=512, **kw)
        model.train()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        reset_launch_counts()
        loss = model(ids, labels=ids)
        torch.cuda.synchronize()
        kept = torch.cuda.memory_allocated() - start
        loss.backward()
        torch.cuda.synchronize()
        runs[tag] = dict(loss=loss.detach(),
                         grads={n: p.grad for n, p in
                                model.named_parameters()},
                         peak_gb=(torch.cuda.max_memory_allocated() - start)
                         / 1e9, after_forward_gb=kept / 1e9,
                         attention_fwd=launch_counts()["attention_fwd"])
        del model, loss
    want, got = runs["remat"], runs["remat_save_attention"]
    same = torch.equal(want["loss"], got["loss"]) and all(
        torch.equal(g, got["grads"][n]) for n, g in want["grads"].items())
    if not same:
        raise AssertionError("remat_save_attention: gradients differ from "
                             "remat's")
    fwd = {tag: r["attention_fwd"] for tag, r in runs.items()}
    if fwd != {"no remat": REMAT_LAYERS, "remat": 2 * REMAT_LAYERS,
               "remat_save_attention": REMAT_LAYERS}:
        raise AssertionError(f"attention_fwd launches {fwd}")
    peak = {tag: r["peak_gb"] for tag, r in runs.items()}
    kept = {tag: r["after_forward_gb"] for tag, r in runs.items()}
    for what in (peak, kept):
        if not what["remat"] <= what["remat_save_attention"] \
                <= what["no remat"]:
            raise AssertionError(f"remat_save_attention memory {what}")
    emit({"phase": "train_remat_memory", "ok": True,
          "layers": REMAT_LAYERS, "B": ids.shape[0], "S": ids.shape[1],
          "loss_chunk_size": 512, "peak_gb_above_start": peak,
          "kept_after_forward_gb": kept,
          "attention_fwd_launches": fwd,
          "grads_bitwise_equal_remat": same})
    del runs, want, got
    torch.cuda.empty_cache()


# -- phase 6b ----------------------------------------------------------------

# the bf16 recipe of the JAX headline step (bench_all.py
# _to_bf16_except_norms): bf16 weights, fp32 for every parameter whose
# name holds one of these, fp32 floating buffers
BF16_KEEP_TOKENS = ("bn", "norm", "ln_")
# kernel path against plain path in bf16. u = 2^-8 is bf16's unit
# roundoff (8 significant bits). The two paths round at other places:
# the kernels carry P in two bf16 terms and sum in their own order, the
# plain path rounds P to one bf16 term, so an attention output differs
# by up to an ulp (2u relative), and every later bf16 rounding can turn
# a difference below an ulp into a whole one.
# - loss: a bf16 value in both paths (log-softmax and mean in bf16, as
#   the JAX model computes it); their unrounded values lie far closer
#   than an ulp, so the roundings are at most one ulp apart: 2u relative.
# - gradients: the differences of 24 layers add as independent
#   roundings, sqrt(24) ~ 5 of them, each up to u: the L2 error over all
#   gradients within 8u; a parameter whose gradient sums terms of both
#   signs over the B*S positions (the layer norms' scales and biases)
#   loses up to a factor 2 more to cancellation: 16u each.
BF16_U = 2.0 ** -8
BF16_LOSS_REL_TOL = 2 * BF16_U
BF16_GRAD_REL_TOL = 8 * BF16_U
BF16_PARAM_GRAD_REL_TOL = 16 * BF16_U
BF16_VOCAB = 32768  # bench.py:129


def to_bf16_except_norms(torch, model):
    """The bf16 recipe (``bench_all._to_bf16_except_norms``) in place."""
    model.to(torch.bfloat16)
    for name, p in model.named_parameters():
        if any(t in name for t in BF16_KEEP_TOKENS):
            p.data = p.data.float()
    for _, b in model.named_buffers():
        if b is not None and b.is_floating_point():
            b.data = b.data.float()
    return model


def train_flops(B, S, layers, E, V):
    """Model FLOPs of one train step, forward and backward (3x the
    forward), at 2 flops a multiply-add: per token 24 E^2 a layer (the
    qkv, out, fc_in and fc_out products) and 2 E V for the tied head;
    per sequence and layer 4 E per visible (query, key) pair for QK^T
    and PV, S (S + 1) / 2 pairs causal. Lookups, norms, elementwise work
    and remat's recompute are not counted."""
    fwd = (B * S * (layers * 24 * E * E + 2 * E * V)
           + B * layers * 4 * E * (S * (S + 1) // 2))
    return 3 * fwd


def _check_bf16_parity(loss_k, loss_p, grads_k, grads_p):
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    errs = _grad_rel(grads_k, grads_p)
    num = sum(float((grads_k[n].float() - w.float()).norm()) ** 2
              for n, w in grads_p.items())
    den = sum(float(w.float().norm()) ** 2 for w in grads_p.values())
    global_rel = math.sqrt(num / den)
    worst = max(errs, key=errs.get)
    if not loss_rel <= BF16_LOSS_REL_TOL:
        raise AssertionError(f"train bf16: loss {float(loss_k)} vs plain "
                             f"{float(loss_p)} ({loss_rel:.3g} relative)")
    if not global_rel <= BF16_GRAD_REL_TOL:
        raise AssertionError(f"train bf16: gradients off by {global_rel:.3g}"
                             f" relative (all parameters)")
    if not errs[worst] <= BF16_PARAM_GRAD_REL_TOL:
        raise AssertionError(f"train bf16: gradient of {worst} off by "
                             f"{errs[worst]:.3g} relative")
    return {"loss_kernel": float(loss_k), "loss_plain": float(loss_p),
            "loss_rel": loss_rel, "grad_rel_all": global_rel,
            "grad_rel_max": errs[worst], "grad_rel_max_param": worst,
            "grad_rel": {n: float(f"{e:.3g}") for n, e in errs.items()}}


def phase_train_bf16(torch, dev, launches):
    """The JAX headline step (``bench.py:119-138``) at full depth:
    GPT-1.3B, V=32768, 24 layers, the bf16 recipe, bf16 Adam slots,
    ``AdamW(1e-4)``, B=2, S=2048, flash on, ``loss_chunk_size=0``. One
    forward+backward through the kernels against the plain path (the
    ``BF16_*_TOL`` limits), then ``multi_step`` over 6 steps (losses
    fall; the attention kernels and ``adam_update`` launched), ms a step,
    tokens/s, peak memory and MFU against 989 TFLOP/s bf16, one step
    repeated bitwise and under ``fuse_optimizer``, one profiled step."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from paddle_tpu_torch.optimizer import AdamW
    B, S = 2, 2048
    model = to_bf16_except_norms(torch, _train_model(
        torch, dev, vocab_size=BF16_VOCAB, dtype="bfloat16"))
    cfg = model.config
    gen = torch.Generator(device=dev).manual_seed(3)
    ids = torch.randint(0, BF16_VOCAB, (B, S), generator=gen, device=dev)
    loss_k, grads_k = _loss_and_grads(torch, model, ids, plain=False)
    loss_p, grads_p = _loss_and_grads(torch, model, ids, plain=True)
    rec = _check_bf16_parity(loss_k, loss_p, grads_k, grads_p)
    dtypes = sorted({str(p.dtype) for p in model.parameters()})
    del grads_k, grads_p
    emit({"phase": "train_bf16_parity", "ok": True, "model": "gpt_1p3b",
          "layers": cfg.num_layers, "vocab": BF16_VOCAB, "B": B, "S": S,
          "param_dtypes": dtypes, "loss_dtype": str(loss_k.dtype),
          "tol": {"loss_rel": BF16_LOSS_REL_TOL,
                  "grad_rel_all": BF16_GRAD_REL_TOL,
                  "grad_rel_param": BF16_PARAM_GRAD_REL_TOL}, **rec})

    step = TrainStep(model, AdamW(learning_rate=TRAIN_LR), lambda m, x:
                     m(x, labels=x), seed=0, device=dev)
    first = float(step(ids))  # warm-up step: Adam slots allocated here
    slot_dtypes = sorted({str(v.dtype) for v in
                          step.optimizer.state_dict().values()
                          if torch.is_tensor(v)})
    n_steps = 6
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem_before = torch.cuda.memory_allocated()
    reset_launch_counts()
    t0 = time.monotonic()
    losses = step.multi_step(ids[None].expand(n_steps, B, S))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses.float().tolist()]
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"bf16 train losses do not fall: {first} "
                             f"{losses}")
    for name in TRAIN_STEP_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"bf16 training path")
    same, fused = _repeat_and_fused(torch, step, ids)
    prof = profile_once(torch, lambda: step(ids))
    ms = wall * 1e3 / n_steps
    flops = train_flops(B, S, cfg.num_layers, cfg.hidden_size, BF16_VOCAB)
    emit({"phase": "train_bf16", "ok": True, "model": "gpt_1p3b",
          "layers": cfg.num_layers, "vocab": BF16_VOCAB, "B": B, "S": S,
          "optimizer": f"AdamW({TRAIN_LR})", "slot_dtypes": slot_dtypes,
          "warmup_loss": first, "losses": losses, "ms_per_step": ms,
          "tokens_per_s": B * S * n_steps / wall,
          "peak_mem_gb": peak / 1e9, "mem_before_gb": mem_before / 1e9,
          "flops_per_step": flops,
          "mfu": flops / (ms * 1e-3) / BF16_FLOPS,
          "launches": counts, "repeat_step_bitwise_equal": same,
          "fuse_optimizer": fused, "step_profile": prof})
    del step, model
    torch.cuda.empty_cache()


# -- phase 7 -----------------------------------------------------------------

RESNET_BATCH = 128      # tools/fused_eval_bench.py's batch
RESNET_REL_TOL = 1e-4   # logits, relative in L2, against the plain path
RESNET_FOLDS = 53       # conv+BN pairs of ResNet-50
RESNET_FUSED_BLOCKS = 5  # stride-1 identity blocks with H*W >= 784
# kernel-name substrings -> the group a forward's device time is summed
# under (first match wins)
RESNET_KERNEL_GROUPS = (
    ("fused_bottleneck", ("bottleneck_kernel",)),
    ("convolution (cuDNN)", ("conv", "cudnn", "xmma", "gemm", "winograd",
                             "implicit", "fprop", "nchw", "nhwc")),
    ("pooling", ("pool",)),
    ("elementwise (BN, relu, add)", ("elementwise", "vectorized")),
    ("reductions", ("reduce",)),
)


def phase_resnet(torch, dev, launches):
    """ResNet-50 eval inference, NHWC, 1000 classes, 224x224, fp32 (TF32
    off), seed-0 weights and seeded BN running statistics (mean N(0,
    0.3), variance U(0.5, 2)), at N=128, on three paths over the same
    weights under ``torch.inference_mode()``: (a) the kernel path, opted
    in to the fused bottleneck; (b) the plain path, opted out (eager BN,
    cuDNN convolutions); (c) ``fuse_conv_bn`` on a deep copy."""
    import copy
    from paddle_tpu_torch.inference.fusion import fuse_conv_bn
    from paddle_tpu_torch.nn.norm import BatchNorm2D
    from paddle_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from paddle_tpu_torch.ops.kernels import fused_conv_block as FC
    from paddle_tpu_torch.vision.models import resnet50
    t0 = time.monotonic()
    model = resnet50(data_format="NHWC", device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0))
    model.eval()
    gen = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, BatchNorm2D):
                mod._mean.normal_(0.0, 0.3, generator=gen)
                mod._variance.uniform_(0.5, 2.0, generator=gen)
    folded = copy.deepcopy(model)
    folds = fuse_conv_bn(folded)
    if folds != RESNET_FOLDS:
        raise AssertionError(f"fuse_conv_bn folded {folds} pairs, not "
                             f"{RESNET_FOLDS}")
    x = torch.randn((RESNET_BATCH, 3, 224, 224), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(2))
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    paths = {"kernel": (model, True), "plain": (model, False),
             "folded": (folded, False)}

    def forward(name, inp):
        m, fused = paths[name]
        FC.enable_fused_conv_eval(fused)
        try:
            with torch.inference_mode():
                return m(inp)
        finally:
            FC.enable_fused_conv_eval(False)

    logits, counts = {}, {}
    for name in paths:
        reset_launch_counts()
        logits[name] = forward(name, x)
        torch.cuda.synchronize()
        counts[name] = launch_counts()
    for name, c in counts.items():
        want = RESNET_FUSED_BLOCKS if name == "kernel" else 0
        if c["fused_bottleneck"] != want:
            raise AssertionError(f"resnet {name} path: fused_bottleneck "
                                 f"launched {c['fused_bottleneck']} times "
                                 f"in one forward, not {want}")
        others = {k: v for k, v in c.items() if k != "fused_bottleneck"
                  and v}
        if others:
            raise AssertionError(f"resnet {name} path launched {others}")
    launches["fused_bottleneck"] = counts["kernel"]["fused_bottleneck"]
    plain = logits["plain"].float()
    rel = {}
    for name, out in logits.items():
        if tuple(out.shape) != (RESNET_BATCH, 1000) or \
                not torch.isfinite(out).all():
            raise AssertionError(f"resnet {name} logits: shape "
                                 f"{tuple(out.shape)} or non-finite")
        rel[name] = float((out.float() - plain).norm() / plain.norm())
        if not rel[name] <= RESNET_REL_TOL:
            raise AssertionError(f"resnet {name} path: logits {rel[name]:.3g}"
                                 f" relative off the plain path")
    top1 = {name: float((out.argmax(-1) == plain.argmax(-1)).float()
                        .mean()) for name, out in logits.items()}
    timer = Timer(torch, dev)
    timing = {}
    for name in paths:
        torch.cuda.reset_peak_memory_stats()
        ms = timer(lambda: forward(name, x), iters=10, warmup=2)
        peak = torch.cuda.max_memory_allocated()
        ms1 = timer(lambda: forward(name, x[:1]), iters=10, warmup=2)
        timing[name] = {"ms_per_forward": ms,
                        "imgs_per_s": RESNET_BATCH / ms * 1e3,
                        "peak_mem_gb": peak / 1e9, "latency_ms_n1": ms1}
    prof = {name: profile_once(torch, lambda: forward(name, x),
                               RESNET_KERNEL_GROUPS)
            for name in ("kernel", "plain")}
    emit({"phase": "resnet", "ok": True, "model": "resnet50",
          "data_format": "NHWC", "batch": RESNET_BATCH, "image": 224,
          "dtype": "float32", "model_build_s": build_s, "folds": folds,
          "launches_per_forward": {n: c["fused_bottleneck"]
                                   for n, c in counts.items()},
          "tol_rel": RESNET_REL_TOL, "logits_rel_l2_vs_plain": rel,
          "top1_agreement_vs_plain": top1, "timing": timing,
          "profile": prof})


def main() -> int:
    if len(sys.argv) > 1:
        print("chip_smoke: takes no arguments", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script runs only on a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import paddle_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: paddle_tpu_torch is not importable next to "
              f"this script: {e}", file=sys.stderr)
        return 2
    paddle_tpu_torch.setup_precision()
    dev = paddle_tpu_torch.resolve_device("cuda")
    records = {}
    launches = {}
    smi_line = phase_device(torch)
    phase_build()
    phase_kernels(torch, dev, records)
    model = phase_engine(torch, dev, records, launches)
    phase_server(torch, dev, model)
    del model
    # the engine and the server leave reference cycles: collected here,
    # they free the model and its KV pool before the train phase reads
    # its peak memory, instead of whenever the collector next runs
    gc.collect()
    torch.cuda.empty_cache()
    phase_train(torch, dev, launches)
    phase_train_bf16(torch, dev, launches)
    phase_resnet(torch, dev, launches)
    if FAILED_CHECKS:
        emit({"phase": "checks", "ok": False, "failed": FAILED_CHECKS})
        print(f"chip_smoke: {len(FAILED_CHECKS)} closeness checks failed",
              file=sys.stderr)
        return 1
    kernels = []
    for name, (src, replaces) in KERNEL_META.items():
        r = records[name]
        # bound_by is "bytes" or "operations"; the products' route
        # (3xtf32 or bf16) goes beside it
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": ("bytes" if r["bound_by"] == "bytes"
                         else "operations"),
            "bound_route": r["bound_by"], "library_ms": r["library_ms"]})
    emit({"kernels": kernels})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
