#!/usr/bin/env python3
"""Time ``paged_decode`` on one CUDA GPU at each split size of its page
walk, to choose ``PAGED_SPLIT_TOKENS``.

Shapes (GPT-1.3B's heads: H=16 D=128, page 64, 32-page table rows):

- ``engine``: the 8-slot decode step's traffic, the sequences of
  ``chip_smoke.py``'s decode profile (prompts of 300-1700 tokens) ten
  tokens into their decode;
- ``table``: ``chip_smoke.py``'s table shape, 8 sequences from empty to
  a full 2048-token row;
- ``single``: one 2048-token sequence (one stream, the fewest blocks).

For each split of ``SPLITS`` positions, each shape and each pool type
(fp32, bf16, int8) the kernel is first checked against its plain
version and its split emulation (``chip_smoke.py``'s checks and
tolerances), then timed with ``chip_smoke.py``'s device-only timer
(median of 20 launches, L2 flushed). The splits are timed in two
passes, ascending then descending, and both readings are printed. The
split is set by assigning the module constant for the duration of a
pass. One JSON line per reading, then a summary line with each shape's
mean fp32 ms per split, then the card's name and power limit as
nvidia-smi gives them. Exits 1 if a check failed.

Run, on a machine with one CUDA GPU and ``nvcc``, from the root of the
repository::

    python3 paged_split_sweep.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

SPLITS = (64, 128, 256, 512)
SHAPES = {
    "engine": (310, 510, 710, 910, 1110, 1310, 1510, 1710),
    "table": (0, 1, 37, 64, 100, 700, 1500, 2048),
    "single": (2048,),
}
H, D, PAGE, MAX_PAGES = 16, 128, 64, 32


def main() -> int:
    if len(sys.argv) > 1:
        print(__doc__, file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import torch

    import chip_smoke as cs
    import paddle_tpu_torch
    from paddle_tpu_torch.ops.kernels import paged_attention as tpa
    paddle_tpu_torch.setup_precision()
    dev = paddle_tpu_torch.resolve_device("cuda")
    timer = cs.Timer(torch, dev)
    inputs = {}
    for shape, lens in SHAPES.items():
        gen = cs.check_gen(torch, dev, f"paged_split_sweep {shape}")
        q, kf, vf, table, ln = cs._paged_inputs(torch, gen, dev, H, D, PAGE,
                                                MAX_PAGES, lens)
        inputs[shape] = {pool: (cs._paged_pools(torch, q, kf, vf, pool),
                                table, ln) for pool in cs.PAGED_POOLS}
    default = tpa.PAGED_SPLIT_TOKENS
    ms = {}
    try:
        for order in (SPLITS, SPLITS[::-1]):
            for split in order:
                tpa.PAGED_SPLIT_TOKENS = split
                for shape, pools in inputs.items():
                    for pool, ((q, kp, vp, ksc, vsc), table, ln) in \
                            pools.items():
                        cs._paged_check(
                            torch, f"paged_decode {shape} {pool} split "
                            f"{split}", q, kp, vp, table, ln, ksc, vsc)
                        t = timer(lambda: tpa.paged_decode(
                            q, kp, vp, table, ln, k_scale=ksc, v_scale=vsc))
                        ms.setdefault((shape, pool, split), []).append(t)
                        cs.emit({"shape": shape, "pool": pool,
                                 "split_tokens": split, "ms": t,
                                 "lens": list(SHAPES[shape])})
    finally:
        tpa.PAGED_SPLIT_TOKENS = default
    cs.emit({"summary": "mean fp32 ms of the two passes", **{
        shape: {str(split): sum(ms[(shape, "fp32", split)]) / 2
                for split in SPLITS} for shape in SHAPES}})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    if cs.FAILED_CHECKS:
        print(f"paged_split_sweep: {len(cs.FAILED_CHECKS)} checks failed",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
