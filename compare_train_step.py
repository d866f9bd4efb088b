#!/usr/bin/env python3
"""Time the GPT-1.3B train step of two checkouts of this repository in
turns on one CUDA GPU: A, B, B, A.

Each turn is a process started in a checkout's root, so it builds and
loads that checkout's kernels and runs its code. A turn times, with
``chip_smoke.py``'s device-only timer, each fp32 attention kernel at
its training-path shape (H=16 D=128, causal): the dQ and dK/dV passes
at B=2 S=2048, the forward at B=1 S=2048, the single pass at B=2 S=512
and the folded backward at B=2 S=256. Then it times
``TrainStep.multi_step`` over 6 steps at full depth (GPT-1.3B, 24
layers, B=2, S=2048, fp32, dropout 0, ``AdamW(1e-4)``, seed-0 weights,
after one warm-up step; with the memory allocated before those steps
and its peak over them) and 5 steps of the 4-layer remat +
chunked-loss (512) model at S=2048, and prints one JSON line. Steps are
timed on the host clock between two ``torch.cuda.synchronize()``. The
script prints every turn's line, then the card's name and power limit
as nvidia-smi gives them.

Run, on a machine with one CUDA GPU and ``nvcc``::

    python3 compare_train_step.py A_DIR B_DIR

where each directory is the root of a checkout (e.g. the parent commit
unpacked with ``git archive`` into a git-ignored directory, and ``.``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

STEPS = 6          # full-depth steps timed per turn
VARIANT_STEPS = 5  # 4-layer remat + chunked-loss steps timed per turn
B, S = 2, 2048


def _steps_ms(torch, step, ids, n):
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(n):
        step(ids)
    torch.cuda.synchronize()
    return (time.monotonic() - t0) * 1e3 / n


def turn() -> None:
    """One turn, in the checkout that is the working directory."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    import paddle_tpu_torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops.kernels import attention as A
    from paddle_tpu_torch.optimizer import AdamW
    paddle_tpu_torch.setup_precision()
    dev = paddle_tpu_torch.resolve_device("cuda")
    out = {"checkout": os.getcwd()}
    timer = cs.Timer(torch, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    ins = cs._bwd_inputs(torch, gen, dev, B, S, torch.float32, True, False)
    out["dq_ms"] = timer(lambda: A.attention_bwd_dq(*ins, True))
    out["dkv_ms"] = timer(lambda: A.attention_bwd_dkv(*ins, True))
    q, k, v = (t[:1] for t in ins[:3])
    out["fwd_ms"] = timer(lambda: A.attention_fwd(q, k, v, causal=True))
    ins = cs._bwd_inputs(torch, gen, dev, B, 512, torch.float32, True, False)
    out["fused_ms"] = timer(lambda: A.attention_bwd_fused(*ins, True))
    ins = cs._bwd_inputs(torch, gen, dev, B, 256, torch.float32, True, False)
    out["folded_ms"] = timer(lambda: A.folded_attention_bwd(*ins[:4], True))
    del ins, q, k, v

    model = cs._train_model(torch, dev)
    ids = torch.randint(0, model.config.vocab_size, (B, S),
                        generator=torch.Generator(device=dev).manual_seed(3),
                        device=dev)
    step = TrainStep(model, AdamW(learning_rate=cs.TRAIN_LR),
                     lambda m, x: m(x, labels=x), seed=0, device=dev)
    step(ids)  # warm-up: Adam's moments are allocated here
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out["mem_before_gb"] = torch.cuda.memory_allocated() / 1e9
    t0 = time.monotonic()
    losses = step.multi_step(ids[None].expand(STEPS, B, S))
    torch.cuda.synchronize()
    out["ms_per_step"] = (time.monotonic() - t0) * 1e3 / STEPS
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["last_loss"] = float(losses[-1])
    del step, model
    torch.cuda.empty_cache()

    model = cs._train_model(torch, dev, num_layers=4, remat=True,
                            loss_chunk_size=512)
    step = TrainStep(model, AdamW(learning_rate=cs.TRAIN_LR),
                     lambda m, x: m(x, labels=x), seed=0, device=dev)
    step(ids)
    out["remat_ms_per_step"] = _steps_ms(torch, step, ids, VARIANT_STEPS)
    print(json.dumps(out), flush=True)


def main() -> int:
    if sys.argv[1:] == ["--turn"]:
        turn()
        return 0
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = (os.path.abspath(d) for d in sys.argv[1:])
    for d in (a, b, b, a):
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--turn"], cwd=d, stdout=subprocess.PIPE,
                             text=True)
        if run.returncode != 0:
            print(f"turn in {d} failed ({run.returncode})", file=sys.stderr)
            return 1
        print(run.stdout.strip().splitlines()[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
