"""Build and load the port's CUDA kernels (``paddle_tpu_torch/csrc``).

Route: every ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all
started together) into an object for ``sm_90a``, and the objects are
linked into one shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c csrc/<kernel>.cu
    nvcc -shared -o build/kernels/libpt_kernels.so *.o

The library is loaded with ``ctypes``; every pointer and the stream are
``c_void_p``. The build runs at the first kernel launch (never at
import, so the CPU tests import the package without ``nvcc``) and is
keyed on a hash of the sources: an unchanged tree reuses
``build/kernels/libpt_kernels.so``. The directory is the kernel cache's
when it is on (``core/compile_cache.py``, ``PADDLE_TPU_COMPILE_CACHE``):
one that holds the library of the current digest serves it without
``nvcc``. Builds are serialised across processes by an ``flock`` on
``<dir>/.build.lock`` (the replicas of a fleet booting from a fresh tree
all reach their first launch together): whoever takes the lock second
finds the stamp written and loads the first one's library. One process
loads one library (:func:`loaded_from`).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from typing import Dict, List, Optional

import torch
from torch._subclasses.fake_tensor import is_fake

from ...core import compile_cache

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
LIB_NAME = "libpt_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures of the entry points (csrc/*.cu ``extern "C"``); each
# returns the cudaError_t of its launches as an int
SIGNATURES: Dict[str, List] = {
    # q, k_pages, v_pages, k_scale, v_scale, page_table, seq_lens, out,
    # workspace, tickets, B, H, D, page, max_pages, pages_per_split,
    # q_dtype, kv_dtype, scale, stream
    "pt_paged_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # ctx, w, bias, out, B, K, N, act_dtype, w_dtype, has_bias,
    # splits, rows per split, stream
    "pt_decode_out_proj": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _P],
    # hidden, weight, bias, tile_max, tile_arg, tile_nan, out,
    # B, D, V, vocab_major, h_dtype, w_dtype, has_bias, n_tiles, stream
    "pt_fused_argmax": [_P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # V, B: vocab tiles of a call with B rows (the records' first axis)
    "pt_argmax_tile_count": [_I, _I],
    # q, k, v, out, lse, B, Sq, Sk, H, D,
    # q strides (b, s, h), k strides, v strides, causal, dtype, scale,
    # write_lse, stream
    "pt_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _I, _I, _F, _I, _P],
    # q, k, v, dout, lse, delta, dq, dk, dv, dq_part, B, Sq, Sk, H, D,
    # q/k/v/dout strides (b, s, h), causal, dtype, scale, mode, stream
    "pt_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I,
                         _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _I, _I, _F, _I, _P],
    # x, w1, b1, w2, b2, w3, b3, out, N, H, W, C, M, tile rows, tile
    # columns, strips, column tiles, shared bytes, dtype, stream
    "pt_fused_bottleneck": [_P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                            _P],
    # shared bytes, dtype, int* blocks per SM
    "pt_fused_bottleneck_occupancy": [_I, _I, _P],
    # host table (p, g, m, v, n per tensor), tensors, param dtype, slot
    # dtype, lr, b1, 1 - b1, b2, 1 - b2, 1 / bc1, 1 / bc2, eps, wd,
    # lr * wd, decay mode, stream
    "pt_adam_update": [_P, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _F, _F,
                       _F, _I, _P],
    "pt_adam_update_max_tensors": [],
    # x, qx workspace, wq, w_scale, act_scale, bias, out, M, K, N,
    # x dtype, has_bias, stream
    "pt_int8_linear": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, qx workspace, wq, w_scale, act_scale, bias, out, B, C, H, W, M,
    # kh, kw, OH, OW, strides, top / left pads, dilations, groups,
    # x dtype, has_bias, stream
    "pt_int8_conv2d": [_P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                       _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_dir: Optional[str] = None


def build_dir() -> str:
    """Where the library is built and found: the kernel cache's directory
    when it is on, else ``build/kernels/``."""
    return compile_cache.compile_cache_dir() or BUILD_DIR


def loaded_from() -> Optional[str]:
    """The directory the loaded library came from (None before the first
    kernel launch)."""
    return _lib_dir


def _sources() -> List[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def source_hash() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    cand = shutil.which("nvcc")
    if cand is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA "
            "kernels are built from paddle_tpu_torch/csrc at first use")
    return cand


def build(verbose: bool = False) -> str:
    """Compile the kernels if the library for the current sources does
    not exist yet; returns the library path. ``verbose`` adds
    ``-Xptxas=-v``, prints each kernel's registers, shared memory and
    spills to stderr and keeps them beside the library
    (:func:`ptxas_report_path`), rebuilding a library that has none.
    ``$PADDLE_TPU_COMPILE_CACHE``, when no cache directory was enabled
    yet, is read here (``compile_cache.enable_compile_cache``)."""
    if compile_cache.compile_cache_dir() is None:
        compile_cache.enable_compile_cache()
    digest = source_hash()
    out_dir = build_dir()
    lib_path = os.path.join(out_dir, LIB_NAME)
    if _built(digest, verbose):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, ".build.lock"), "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not _built(digest, verbose):
                _compile(digest, verbose)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib_path


def _built(digest: str, verbose: bool) -> bool:
    """The library of ``digest`` exists with its stamp (and, for a
    verbose build, its ptxas report)."""
    lib_path = os.path.join(build_dir(), LIB_NAME)
    stamp = lib_path + ".hash"
    if not (os.path.exists(lib_path) and os.path.exists(stamp) and (
            not verbose or os.path.exists(ptxas_report_path()))):
        return False
    with open(stamp) as f:
        return f.read().strip() == digest


def _compile(digest: str, verbose: bool) -> None:
    """Compile every source and link the library (under the build
    lock); the stamp is written last, atomically."""
    lib_path = os.path.join(build_dir(), LIB_NAME)
    stamp = lib_path + ".hash"
    report = ptxas_report_path()
    obj_dir = os.path.join(build_dir(), "obj-" + digest)
    os.makedirs(obj_dir, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    objs = []
    for src in _sources():
        if not src.endswith(".cu"):
            continue
        obj = os.path.join(obj_dir, os.path.basename(src)[:-3] + ".o")
        objs.append(obj)
        cmd = [nvcc] + NVCC_FLAGS + ["-I", CSRC, "-c", src, "-o", obj]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs.append((src, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failures = []
    outputs = []
    for src, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            failures.append(f"{os.path.basename(src)}:\n{out}")
        elif verbose and out:
            print(out, file=sys.stderr, flush=True)
            outputs.append(out)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    if verbose:
        with open(report, "w") as f:
            f.write("\n".join(outputs))
    tmp = lib_path + f".tmp{os.getpid()}"
    link = subprocess.run([nvcc] + ARCH_FLAGS + ["-shared", "-o", tmp]
                          + objs, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, lib_path)
    tmp = stamp + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(digest)
    os.replace(tmp, stamp)


def ptxas_report_path() -> str:
    """Where a verbose build keeps ``ptxas -v``'s lines for the current
    library."""
    return os.path.join(build_dir(), LIB_NAME + ".ptxas")


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib, _lib_dir
    with _lock:
        if _lib is None:
            path = build()
            handle = ctypes.CDLL(path)
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib, _lib_dir = handle, os.path.dirname(path)
        return _lib


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")


# storage-type codes of csrc/common.cuh (pt::DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.float16: 3}


def dtype_code(t: torch.Tensor, name: str, allowed=(torch.float32,
                                                    torch.bfloat16)) -> int:
    if t.dtype not in allowed:
        raise TypeError(f"{name}: dtype {t.dtype} not supported by the "
                        f"kernel (takes {[str(a) for a in allowed]})")
    return DTYPE_CODES[t.dtype]


def require_cuda(name: str, *tensors) -> torch.device:
    """Every given tensor (None skipped) on one CUDA device and
    contiguous; returns that device."""
    dev = None
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name}: all operands must be CUDA tensors, "
                             f"got one on {t.device}")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: operands on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    return dev


def refuse_grad(name: str, *tensors) -> None:
    """Raise when autograd would record through a kernel that has no
    backward (the JAX package has none for it either): grad mode is on
    and an operand requires grad. The plain version would differentiate
    on the CPU where the kernel could not on the card."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: call it under torch.no_grad() or on "
            f"tensors that do not require grad")


# The port's registered ops (``paddle_tpu_torch::<name>``): one library
# fragment, kept alive as long as the module.
_OPS = torch.library.Library("paddle_tpu_torch", "FRAGMENT")


def register_op(schema: str, cpu, cuda, fake, backward=None,
                setup_context=None) -> None:
    """Define the op ``paddle_tpu_torch::<schema>`` with the plain
    version as its CPU kernel, the launch as its CUDA kernel and a fake
    implementation for tracing (``torch.export``, ``FakeTensorMode``),
    through ``torch.library``'s dispatcher API. (``torch.library.
    custom_op`` wraps each kernel in ``torch._disable_dynamo``, whose
    first call imports ``torch._dynamo``: 2.3 s on an 8-core x86 CPU at
    the first launch of every process, a serving replica's first
    prefill among them.) ``backward`` / ``setup_context``, where given,
    are its autograd formula (``torch.library.register_autograd``)."""
    name = schema.split("(", 1)[0]
    _OPS.define(schema)
    _OPS.impl(name, cpu, "CPU")
    _OPS.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"paddle_tpu_torch::{name}", fake,
                                lib=_OPS)
    if backward is not None:
        torch.library.register_autograd(
            f"paddle_tpu_torch::{name}", backward,
            setup_context=setup_context, lib=_OPS)


def refuse_trace(name: str, *tensors) -> None:
    """Raise when a ``ctypes`` kernel is reached while ``torch.export``
    or ``torch.compile`` traces, or on a traced (fake) tensor: such a
    kernel has no registered op, so a traced program could only hold
    its plain version, which would run where the eager model launches
    the kernel. Only the forward kernels are registered ops
    (``paddle_tpu_torch::attention_fwd``,
    ``paddle_tpu_torch::fused_bottleneck``)."""
    if torch.compiler.is_exporting() or torch.compiler.is_compiling() or \
            any(t is not None and is_fake(t) for t in tensors):
        raise RuntimeError(
            f"{name} cannot be exported or compiled: it is a ctypes kernel "
            f"with no registered op; export programs that reach only "
            f"attention_fwd, fused_bottleneck, int8_linear and "
            f"int8_conv2d")


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
