"""The work a program does, counted from shapes: the bytes it must move
and the operations it must run, and the least time an H100 could take
for them.

The JAX engine reads each program's flops and bytes from
``jit.lower(...).cost_analysis()``
(``paddle_tpu/inference/continuous_batching.py:1376-1431``). PyTorch
has no such analysis of an eager step or a CUDA graph, so the port
counts the same quantities from the model's config and each launch's
shapes. The count depends on the program alone, never on whether a
hand-written kernel or its plain version runs it, so a roofline share
read against it means the same work either way. ``chip_smoke.py``'s
kernel table takes its bounds from the helpers here too.

What a program counts:

- flops: 2 a multiply-add of every GEMM (the QKV, out-projection and
  MLP products of each layer over the rows the program computes), of
  the lm head over its rows, and 4 a (query, key, head-dim) element of
  attention over the visible pairs (QK^T and PV); elementwise work is
  not counted;
- bytes: every weight read once a launch (each iteration of a
  multi-step launch reads them again), the KV positions read from the
  pools and the positions written; activations, which stay on chip or
  in the L2, are not counted.
"""

from __future__ import annotations

from typing import Dict, Iterable

__all__ = ["HBM_BYTES_PER_S", "TF32_FLOPS", "BF16_FLOPS", "FP16_FLOPS",
           "INT8_OPS", "PRODUCT_ROUTES", "PAGED_POOLS", "bound_ms",
           "attention_fwd_cost", "int8_linear_cost", "int8_conv2d_cost",
           "paged_bytes", "out_proj_cost",
           "kv_position_bytes", "step_cost", "decode_cost",
           "prefill_cost", "restore_cost"]

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
TF32_FLOPS = 495e12         # dense TF32 on the tensor cores
BF16_FLOPS = 989e12         # dense bf16 on the tensor cores
FP16_FLOPS = 989e12         # dense fp16 on the tensor cores
INT8_OPS = 1979e12          # dense int8 on the tensor cores
# route of a function's products -> (flops each costs, peak, bound_by):
# an fp32 product to fp32 accuracy on the tensor cores is three TF32
# products (3xTF32: hi*hi + hi*lo + lo*hi)
PRODUCT_ROUTES = {"fp32": (3.0, TF32_FLOPS, "3xtf32"),
                  "bf16": (1.0, BF16_FLOPS, "bf16"),
                  "fp16": (1.0, FP16_FLOPS, "fp16"),
                  "int8": (1.0, INT8_OPS, "int8")}

# bytes of one pool value and of the query / context element, by pool
PAGED_POOLS = {"fp32": (4, 4), "bf16": (2, 2), "int8": (1, 4)}


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


def int8_linear_cost(M, K, N, x_size=4):
    """(bytes, ops) of one ``int8_linear``: x [M, K] read and the fp32
    out [M, N] written once, the int8 weight, its [N] scale and the bias
    read once; 2 ops per multiply-add."""
    return (M * K * x_size + K * N + 8 * N + M * N * 4, 2 * M * K * N)


def int8_conv2d_cost(B, C, H, W, M, k, OH, OW, groups, x_size=4):
    """(bytes, ops) of one ``int8_conv2d``: x read and the fp32 out
    written once, the int8 weight and the bias read once; 2 ops per
    multiply-add of the implicit GEMM (rows B*OH*OW, depth C/groups*k*k,
    M columns)."""
    depth = C // groups * k * k
    return (B * C * H * W * x_size + M * depth + 4 * M
            + B * M * OH * OW * 4, 2 * B * OH * OW * M * depth)


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


def kv_position_bytes(cfg, itemsize: int, quantized: bool) -> int:
    """Bytes of one position's K and V in one layer's pools: H x D
    values each, plus a 4-byte scale a head for int8 pools."""
    per = cfg.num_heads * cfg.head_dim * itemsize
    if quantized:
        per += cfg.num_heads * 4
    return 2 * per


def step_cost(cfg, rows: int, pairs: int, head_rows: int,
              kv_read: int, kv_written: int, weight_bytes: int,
              kv_pos_bytes: int) -> Dict[str, float]:
    """One forward of the model: ``rows`` token rows through every
    layer's GEMMs, ``pairs`` visible (query, key) pairs of attention a
    layer, ``head_rows`` rows through the lm head, ``kv_read`` /
    ``kv_written`` pool positions a layer, and the weights read once.
    Returns ``{"flops", "bytes_accessed"}`` (the JAX engine's keys)."""
    E, L, V = cfg.hidden_size, cfg.num_layers, cfg.vocab_size
    F = cfg.ffn_hidden_mult * E
    # qkv E x 3E, out E x E, fc_in E x F, fc_out F x E
    gemm = 2 * rows * L * (4 * E * E + 2 * E * F)
    attn = 4 * cfg.num_heads * cfg.head_dim * L * pairs
    head = 2 * head_rows * E * V
    nbytes = weight_bytes + L * (kv_read + kv_written) * kv_pos_bytes
    return {"flops": float(gemm + attn + head),
            "bytes_accessed": float(nbytes)}


def decode_cost(cfg, rows: int, lens: Iterable[int], weight_bytes: int,
                kv_pos_bytes: int, iterations: int = 1,
                stops: Iterable[int] = ()) -> Dict[str, float]:
    """One decode launch: ``rows`` slots each compute one token an
    iteration (every slot's row runs the GEMMs and the head, live or
    parked), and each live slot at stored length ``lens[i]`` appends
    one position and attends ``lens[i] + 1`` an iteration, for
    ``stops[i]`` iterations (all of them when ``stops`` is empty) out of
    ``iterations``; the weights are read once an iteration."""
    lens = [int(n) for n in lens]
    stops = [int(s) for s in stops] or [iterations] * len(lens)
    pairs = kv_read = kv_written = 0
    for n, s in zip(lens, stops):
        s = min(s, iterations)
        # positions attended in iteration j: n + j + 1
        pairs += s * (n + 1) + s * (s - 1) // 2
        kv_read += s * n + s * (s - 1) // 2
        kv_written += s
    return step_cost(cfg, rows * iterations, pairs, rows * iterations,
                     kv_read, kv_written, weight_bytes * iterations,
                     kv_pos_bytes)


def prefill_cost(cfg, bucket: int, cached: int, head_rows: int,
                 weight_bytes: int, kv_pos_bytes: int
                 ) -> Dict[str, float]:
    """One slot's prefill padded to ``bucket`` rows after ``cached``
    stored positions (0 for a fresh prefill): every padded row runs the
    GEMMs and writes a position (padding lands on the scratch page),
    query ``i`` attends ``cached + i + 1`` positions (causal), the
    stored prefix is read once, and ``head_rows`` rows reach the lm
    head (1 with the fused sampler, the bucket without)."""
    pairs = bucket * cached + bucket * (bucket + 1) // 2
    return step_cost(cfg, bucket, pairs, head_rows, cached, bucket,
                     weight_bytes, kv_pos_bytes)


def restore_cost(cfg, pages: int, page_size: int, kv_pos_bytes: int
                 ) -> Dict[str, float]:
    """A spill restore: ``pages`` pages written into every layer's pools
    (no operation)."""
    return {"flops": 0.0,
            "bytes_accessed": float(cfg.num_layers * pages * page_size
                                    * kv_pos_bytes)}
