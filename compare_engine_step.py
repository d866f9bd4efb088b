#!/usr/bin/env python3
"""Time GPT-1.3B's per-token engine step of two checkouts of this
repository in turns on one CUDA GPU: A, B, B, A.

Each turn is a process started in a checkout's root, so it builds and
loads that checkout's kernels and runs its code. A turn builds GPT-1.3B
(24 layers, fp32, seed-0 weights), runs ``chip_smoke.py``'s engine main
path (8 prompts of 40-2000 tokens, 32 new tokens each, 8 slots, page
64, 96 pages) and then times steady decode steps at 8 slots (8 prompts
of 300-1700 tokens, after 6 warm steps, 4 blocks of 12 steps on the
host clock between two ``torch.cuda.synchronize()``). Where the
checkout has ``paddle_tpu_torch.nn.layer.Layer``, the blocks alternate
``Layer.__call__`` and ``nn.Module.__call__`` (L, M, M, L), giving the
eager API's boundary cost on the same engine, and the turn also counts
the ``Layer`` calls of a decode step and times one call's overhead on
the host (a ``Linear`` on CPU tensors, 9 alternating rounds of 20000
calls each way, the median of the rounds' differences): their product
estimates the boundary without the steps' noise. It prints one JSON
line a turn, then the card's name and power limit as nvidia-smi gives
them.

Run, on a machine with one CUDA GPU and ``nvcc``::

    python3 compare_engine_step.py A_DIR B_DIR

where each directory is the root of a checkout (e.g. the parent commit
unpacked with ``git archive`` into a git-ignored directory, and ``.``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

STEPS = 12   # decode steps a timed block


def _blocks(torch, eng, kinds, layer_cls):
    out = {k: [] for k in kinds}
    call = layer_cls.__call__ if layer_cls is not None else None
    try:
        for kind in kinds + kinds[::-1]:
            if layer_cls is not None:
                layer_cls.__call__ = call if kind == "layer" \
                    else torch.nn.Module.__call__
            torch.cuda.synchronize()
            t0 = time.monotonic()
            for _ in range(STEPS):
                eng.step()
            torch.cuda.synchronize()
            out[kind].append((time.monotonic() - t0) * 1e3 / STEPS)
    finally:
        if layer_cls is not None:
            layer_cls.__call__ = call
    return {k: sum(v) / len(v) for k, v in out.items()}


def turn() -> None:
    """One turn, in the checkout that is the working directory."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    import paddle_tpu_torch
    from paddle_tpu_torch.inference import create_decode_engine
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_1p3b
    paddle_tpu_torch.setup_precision()
    dev = paddle_tpu_torch.resolve_device("cuda")
    cs.phase_build()
    model = GPTForCausalLM(gpt_1p3b(), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(0))
    model.eval()
    V = model.config.vocab_size
    gen = torch.Generator().manual_seed(0)
    lengths = (40, 100, 200, 400, 900, 1500, 2000, 600)
    prompts = [torch.randint(0, V, (n,), generator=gen).numpy()
               for n in lengths]
    cs.run_engine(torch, model, prompts, cs.ENGINE_NEW, plain=False)
    _, info = cs.run_engine(torch, model, prompts, cs.ENGINE_NEW,
                            plain=False)
    try:
        from paddle_tpu_torch.nn.layer import Layer
        kinds = ["layer", "module"]
    except ImportError:
        Layer, kinds = None, ["module"]
    eng = create_decode_engine(model, device=dev, num_slots=8,
                               page_size=64)
    gen = torch.Generator().manual_seed(1)
    for n in (300, 500, 700, 900, 1100, 1300, 1500, 1700):
        eng.submit(torch.randint(0, V, (n,), generator=gen).numpy(),
                   max_new_tokens=6 + 4 * STEPS + 8)
    for _ in range(6):
        eng.step()
    steady = _blocks(torch, eng, kinds, Layer)
    out = {"dir": os.getcwd(), "main_path": info, "steady_step_ms": steady}
    if Layer is not None:
        out.update(_call_cost(torch, eng, Layer))
    eng.close()
    print(json.dumps(out), flush=True)


def _call_cost(torch, eng, layer_cls, steps=4, rounds=9, n=20000):
    """``Layer`` calls a decode step and one call's host overhead."""
    import timeit

    from paddle_tpu_torch.nn.layers import Linear
    call = layer_cls.__call__
    count = [0]

    def counting(self, *args, **kwargs):
        count[0] += 1
        return call(self, *args, **kwargs)

    layer_cls.__call__ = counting
    try:
        for _ in range(steps):
            eng.step()
    finally:
        layer_cls.__call__ = call
    lin = Linear(8, 8, device="cpu")
    x = torch.ones(2, 8)
    diffs = []
    for _ in range(rounds):
        t_layer = timeit.timeit(lambda: lin(x), number=n)
        t_module = timeit.timeit(lambda: torch.nn.Module.__call__(lin, x),
                                 number=n)
        diffs.append((t_layer - t_module) / n * 1e6)
    per_call = sorted(diffs)[rounds // 2]
    calls = count[0] / steps
    return {"layer_calls_per_step": calls, "call_overhead_us": per_call,
            "call_overhead_us_rounds": diffs,
            "boundary_estimate_ms": calls * per_call / 1e3}


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
