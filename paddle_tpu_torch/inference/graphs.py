"""CUDA graphs of one macro-step iteration: the port's counterpart of
the JAX engine's jitted macro program (``jax.jit(macro,
donate_argnums=(1,))``, ``inference/continuous_batching.py:1645-1746``).

The JAX engine compiles N decode iterations into one ``while_loop``
program and launches it once per N tokens. Here one iteration
(``models/gpt.py`` ``macro_iteration``) is captured once per engine and
program kind ("decode", "decode + chunk") and the engine replays the
graphs N times a launch, with no host synchronisation between replays.
The iteration reads and writes only tensors at fixed addresses: the
carry (``MacroCarry``), the engine's static inputs (:class:`Staging`)
and the KV pools, which it updates in place.

- Warm-up: before a kind is captured, its iteration runs twice on the
  capture stream with every slot inactive and no chunk token valid, so
  it writes only the scratch page. That is where the kernel library
  is loaded, ``cudaFuncSetAttribute`` first runs, PyTorch's
  libraries pick their algorithms and ``paged_decode`` allocates and
  zeroes the ticket buffer of that stream, all outside the graph.
- Launch counts: a kernel wrapper counts its launch when it is
  captured, but the device runs it at every replay. The capture's
  counts are taken back and added once a replay
  (``ops.kernels.add_launches``).
- No fallback: a failed capture or replay raises. Graphs are keyed on
  the pools' ``data_ptr()``s and a replay against other pools (the
  engine's ``release_device()`` drops them) is refused.

CPU engines never build a graph: they run the same iteration as a plain
loop (``models/gpt.py`` ``run_macro_loop``).
"""

from __future__ import annotations

import ctypes
import time
from typing import Callable, Dict, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["IterationGraphs", "Staging", "WeightWatch", "pools_key"]

# CU_GRAPH_NODE_TYPE_KERNEL of libcuda (cuda.h)
_KERNEL_NODE = 0


def pools_key(pools: Dict[str, Sequence]) -> Tuple[int, ...]:
    """The KV pools' addresses, in a fixed order: what a captured
    iteration reads and writes."""
    return tuple(t.data_ptr() for kind in ("k", "v", "ks", "vs")
                 for t in pools[kind] if t is not None)


def kernel_nodes(graph: "torch.cuda.CUDAGraph") -> int:
    """Kernel nodes in a captured graph (kept with ``keep_graph=True``),
    read through libcuda: the device launches one replay makes."""
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    err = cu.cuGraphGetNodes(raw, None, ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {err}")
    nodes = (ctypes.c_void_p * n.value)()
    err = cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {err}")
    count = 0
    kind = ctypes.c_int(0)
    for node in nodes[:n.value]:
        err = cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                    ctypes.byref(kind))
        if err:
            raise RuntimeError(f"cuGraphNodeGetType failed: CUresult "
                               f"{err}")
        count += kind.value == _KERNEL_NODE
    return count


class WeightWatch:
    """A model's modules, parameters and buffers as registered now, and
    each tensor's address: what a graph captured now reads.
    :meth:`moved` tells whether any was replaced since (a layer swapped
    by ``convert_to_weight_only_int8``, a reassigned weight) or its
    storage moved; a copy in place (``load_jax_state``) moves nothing.
    One identity and address check an entry, cheap enough for every
    launch."""

    def __init__(self, model: torch.nn.Module):
        self._entries = [
            (table, name, obj,
             obj.data_ptr() if isinstance(obj, torch.Tensor) else None)
            for mod in model.modules()
            for table in (mod._modules, mod._parameters, mod._buffers)
            for name, obj in table.items() if obj is not None]

    def moved(self) -> bool:
        return not all(table.get(name) is obj and
                       (ptr is None or obj.data_ptr() == ptr)
                       for table, name, obj, ptr in self._entries)


class Staging:
    """Named device buffers at fixed addresses, each with a host twin
    (page-locked on the card) that :meth:`put` fills from numpy and
    copies in asynchronously, in stream order. A twin is rewritten only
    after the launch that read it was drained. ``specs`` maps a name to
    ``(shape, dtype)`` (a new buffer) or to an existing device tensor
    (the buffer itself: the loop carry's inputs)."""

    def __init__(self, device: torch.device,
                 specs: Dict[str, Union[Tuple[Tuple[int, ...],
                                              torch.dtype],
                                        torch.Tensor]]):
        pin = device.type == "cuda"
        self.dev: Dict[str, torch.Tensor] = {}
        self.host: Dict[str, torch.Tensor] = {}
        for name, spec in specs.items():
            if isinstance(spec, torch.Tensor):
                buf = spec
            else:
                buf = torch.zeros(spec[0], dtype=spec[1], device=device)
            self.dev[name] = buf
            self.host[name] = torch.zeros(tuple(buf.shape),
                                          dtype=buf.dtype, pin_memory=pin)

    def put(self, name: str, value) -> None:
        """Stage ``value`` (numpy or a scalar) into ``name``."""
        h = self.host[name]
        h.numpy()[...] = np.asarray(value)
        self.dev[name].copy_(h, non_blocking=h.is_pinned())


class IterationGraphs:
    """One captured iteration per program kind, on one device, against
    one set of pools (``key``: :func:`pools_key`)."""

    def __init__(self, device: torch.device, key: Tuple[int, ...],
                 warmup: int = 2):
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not "
                             f"{device}")
        self.device = device
        self.key = key
        self.warmup = int(warmup)
        self.stream = torch.cuda.Stream(device)
        # the kinds replay one after another on one stream, never
        # together, so they share one memory pool
        self._pool = torch.cuda.graph_pool_handle()
        self._graphs: Dict[str, Tuple["torch.cuda.CUDAGraph",
                                      Dict[str, int], int]] = {}
        self._capture_s: Dict[str, float] = {}

    def kinds(self) -> Dict[str, Dict]:
        """Per kind: the kernel wrappers' launches and the kernel nodes
        of one replay, and the seconds its warm-up and capture took."""
        return {k: {"launches": dict(l), "kernel_nodes": n,
                    "capture_s": self._capture_s[k]}
                for k, (_g, l, n) in self._graphs.items()}

    def captured(self, kind: str) -> bool:
        return kind in self._graphs

    def capture(self, kind: str, fn: Callable[[], None],
                quiesce: Callable[[], None],
                generators: Sequence[torch.Generator] = ()) -> int:
        """Warm ``fn`` (one iteration) up on the capture stream after
        ``quiesce()`` (which makes an iteration write only the scratch
        page), then capture it. ``generators``: the CUDA generators
        ``fn`` draws from, registered with the graph so that each replay
        draws anew from their state and advances it. Returns the graph's
        kernel nodes."""
        from ..ops.kernels import add_launches, launch_counts
        if kind in self._graphs:
            raise RuntimeError(f"iteration graph {kind!r} is already "
                               f"captured")
        t0 = time.monotonic()
        cur = torch.cuda.current_stream(self.device)
        quiesce()
        self.stream.wait_stream(cur)
        with torch.no_grad(), torch.cuda.stream(self.stream):
            for _ in range(self.warmup):
                fn()
        cur.wait_stream(self.stream)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for gen in generators:
            graph.register_generator_state(gen)
        before = launch_counts()
        with torch.no_grad(), torch.cuda.graph(
                graph, pool=self._pool, stream=self.stream,
                capture_error_mode="thread_local"):
            fn()
        after = launch_counts()
        per_replay = {n: after[n] - before[n] for n in after
                      if after[n] != before[n]}
        # the capture recorded these launches; the replays run them
        add_launches(per_replay, -1)
        nodes = kernel_nodes(graph)
        graph.instantiate()
        self._graphs[kind] = (graph, per_replay, nodes)
        self._capture_s[kind] = time.monotonic() - t0
        return nodes

    def replay(self, kind: str, key: Tuple[int, ...]) -> None:
        """Replay ``kind`` on the current stream; refuses pools other
        than the ones it was captured against."""
        from ..ops.kernels import add_launches
        if key != self.key:
            raise RuntimeError(
                "the KV pools changed since the iteration graphs were "
                "captured (released or rebuilt); refusing to replay")
        graph, per_replay, _nodes = self._graphs[kind]
        graph.replay()
        add_launches(per_replay)

    def close(self) -> None:
        """Drop every graph (and with them their memory pool)."""
        for graph, _l, _n in self._graphs.values():
            graph.reset()
        self._graphs.clear()
        self.key = ()
