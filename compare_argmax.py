#!/usr/bin/env python3
"""Time two versions of the ``fused_argmax`` kernel on one GPU, in turns.

Usage: ``python3 compare_argmax.py A B`` where A and B are checkouts of
this repository (a parent unpacked under the git-ignored ``build/``, and
``.``). Each checkout's ``paddle_tpu_torch/csrc/fused_argmax.cu`` is
built alone with ``nvcc`` into ``build/compare_argmax/<turn>/`` and
loaded with ctypes; both share the C interface ``pt_fused_argmax`` /
``pt_argmax_tile_count`` (an older one-argument ``pt_argmax_tile_count``
ignores the row count). The turns run A, B, B, A; each times every shape
of ``SHAPES`` with ``chip_smoke.Timer`` (median of 20 launches, L2
flushed, device time only) after checking the tokens index-exact
against ``torch.argmax`` of the fp32 logits, and prints one JSON line.
A last line gives ``torch.argmax(h @ W.T)`` at the same shapes and the
card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

D, V = 2048, 50304
# (rows, dtype of hidden and W): the decode step's 8 rows, one row (a
# prefill's first token), the speculative verify's 40, 16 slots x 8
SHAPES = ((1, "fp32"), (8, "fp32"), (40, "fp32"), (128, "fp32"),
          (8, "bf16"))


def build(checkout: str, turn: str) -> str:
    csrc = os.path.join(checkout, "paddle_tpu_torch", "csrc")
    out = os.path.join(HERE, "build", "compare_argmax", turn)
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libargmax.so")
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-I", csrc, "-o", lib,
                    os.path.join(csrc, "fused_argmax.cu")], check=True)
    return lib


def load(path: str):
    lib = ctypes.CDLL(path)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.pt_fused_argmax.argtypes = [P] * 7 + [I] * 8 + [P]
    lib.pt_fused_argmax.restype = I
    lib.pt_argmax_tile_count.argtypes = [I, I]
    lib.pt_argmax_tile_count.restype = I
    return lib


def call(torch, lib, h, w):
    b = h.shape[0]
    n = lib.pt_argmax_tile_count(V, b)
    rec = torch.empty((3, n, b), device=h.device, dtype=torch.int32)
    out = torch.empty((b,), device=h.device, dtype=torch.int32)
    code = {torch.float32: 0, torch.bfloat16: 1}
    err = lib.pt_fused_argmax(
        h.data_ptr(), w.data_ptr(), None, rec[0].data_ptr(),
        rec[1].data_ptr(), rec[2].data_ptr(), out.data_ptr(), b, D, V, 1,
        code[h.dtype], code[w.dtype], 0, n,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"pt_fused_argmax: cudaError_t {err}")
    return out


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("compare_argmax: needs a CUDA GPU", file=sys.stderr)
        return 2
    from chip_smoke import Timer
    dev = torch.device("cuda")
    libs = {"A": load(build(sys.argv[1], "A")),
            "B": load(build(sys.argv[2], "B"))}
    gen = torch.Generator(device=dev).manual_seed(0)
    w32 = torch.randn((V, D), generator=gen, device=dev) * 0.02
    inputs = {}
    for rows, dt in SHAPES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        h = torch.randn((rows, D), generator=gen, device=dev).to(dtype)
        w = w32.to(dtype)
        want = torch.argmax(h.float() @ w.float().t(), dim=-1).int()
        inputs[f"R={rows} {dt}"] = (h, w, want)
    timer = Timer(torch, dev)
    for turn in ("A", "B", "B", "A"):
        lib = libs[turn]
        row = {"turn": turn, "checkout": sys.argv[1 if turn == "A" else 2]}
        for key, (h, w, want) in inputs.items():
            got = call(torch, lib, h, w)
            torch.cuda.synchronize()
            row[key] = {"ms": timer(lambda: call(torch, lib, h, w)),
                        "index_exact": bool(torch.equal(got, want))}
        print(json.dumps(row), flush=True)
    lib_row = {"turn": "library", "call": "torch.argmax(h @ W.T)"}
    for key, (h, w, _) in inputs.items():
        lib_row[key] = {"ms": timer(lambda: torch.argmax(h @ w.t(),
                                                         dim=-1))}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    lib_row["nvidia_smi"] = smi
    print(json.dumps(lib_row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
