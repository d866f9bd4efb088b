"""The tail of ``paddle.static``'s module-level API (port of
``paddle_tpu/static/api.py``): scopes, the accepted-and-inert strategy
shells and ``ParallelExecutor``, program and persistable
(de)serialisation, program-state utilities, ``device_guard`` /
``name_scope``, ``Print``, ``py_func``, ``append_backward`` /
``gradients`` and ``auc``.

Autodiff facades run on PyTorch's autograd. Waiting for other items of
ROADMAP.md's 3(e), and not importable: ``cpu_places`` / ``cuda_places``
(``core/place.py``), ``accuracy`` (``metric/``).
"""

from __future__ import annotations

import contextlib
import io
import itertools
import os
import pickle
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from .program import Program, convert_dtype

# Variable: every value is a tensor
Variable = torch.Tensor


# -- scopes -------------------------------------------------------------------

class Scope:
    """Name -> value tree with parent lookup (``framework/scope.h``)."""

    def __init__(self, parent: Optional["Scope"] = None):
        self._vars: Dict[str, Any] = {}
        self.parent = parent

    def var(self, name: str):
        return self._vars.get(name)

    def find_var(self, name: str):
        if name in self._vars:
            return self._vars[name]
        return self.parent.find_var(name) if self.parent else None

    def set_var(self, name: str, value) -> None:
        self._vars[name] = value

    def new_scope(self) -> "Scope":
        return Scope(self)

    def local_var_names(self) -> List[str]:
        return list(self._vars)


_global_scope = Scope()
_scope_stack: List[Scope] = [_global_scope]


def global_scope() -> Scope:
    return _scope_stack[-1]


@contextlib.contextmanager
def scope_guard(scope: Scope):
    _scope_stack.append(scope)
    try:
        yield scope
    finally:
        _scope_stack.pop()


# -- strategies / ParallelExecutor (accepted-and-inert shells) ---------------

class BuildStrategy:
    """``framework/details/build_strategy.h:54``: fields accepted for
    API compatibility."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = \
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.memory_optimize = None
        self.enable_inplace = True
        self.fuse_all_optimizer_ops = True
        self.fuse_all_reduce_ops = True
        self.fuse_elewise_add_act_ops = True
        self.fuse_bn_act_ops = True
        self.build_cuda_graph = False
        self.debug_graphviz_path = ""


class ExecutionStrategy:
    """``framework/details/execution_strategy.h``."""

    def __init__(self):
        self.num_threads = 0
        self.num_iteration_per_drop_scope = 100
        self.num_iteration_per_run = 1
        self.use_thread_barrier = False


class ParallelExecutor:
    """``framework/parallel_executor.h:51``: keeps the call surface and
    runs the program through :class:`Executor`."""

    def __init__(self, use_cuda=False, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None,
                 build_strategy=None, num_trainers=1, trainer_id=0,
                 scope=None):
        self.program = main_program
        self.build_strategy = build_strategy or BuildStrategy()
        self.exec_strategy = exec_strategy or ExecutionStrategy()

    def run(self, fetch_list=None, feed=None, return_numpy=True):
        from .program import Executor
        return Executor().run(self.program, feed=feed,
                              fetch_list=fetch_list,
                              return_numpy=return_numpy)


# -- vars ---------------------------------------------------------------------

def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None, device=None
                      ) -> torch.Tensor:
    """``paddle.static.create_global_var``: a constant-filled tensor on
    ``device`` (CUDA unless the caller names another; ``force_cpu``
    names the CPU), registered in the current scope under ``name``."""
    dev = resolve_device("cpu" if force_cpu else device)
    t = torch.full(tuple(shape), value, dtype=convert_dtype(dtype),
                   device=dev)
    t.persistable = persistable
    if name:
        global_scope().set_var(name, t)
    return t


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None, device=None,
                     generator: Optional[torch.Generator] = None):
    """``paddle.static.create_parameter``: a free parameter on ``device``
    (CUDA unless the caller names another), drawn by the initializer
    rules of ``nn.initializer``, registered in the current scope under
    its name."""
    from ..nn.initializer import create_parameter as _create
    p = _create(shape, attr=attr, default_initializer=default_initializer,
                is_bias=is_bias, device=resolve_device(device),
                dtype=convert_dtype(dtype), generator=generator)
    name = name or getattr(p, "param_name", None)
    if name:
        p.param_name = name
        global_scope().set_var(name, p)
    return p


class WeightNormParamAttr:
    """``fluid/param_attr.py`` ``WeightNormParamAttr``: ParamAttr plus the
    norm dim."""

    def __init__(self, dim=None, name=None, initializer=None,
                 learning_rate=1.0, regularizer=None, trainable=True,
                 do_model_average=False, need_clip=True):
        self.dim = dim
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip


# -- context managers ---------------------------------------------------------

_device_stack: List[Optional[str]] = [None]


@contextlib.contextmanager
def device_guard(device: Optional[str] = None):
    """``paddle.static.device_guard``: records the tag (observational)."""
    _device_stack.append(device)
    try:
        yield
    finally:
        _device_stack.pop()


def current_device_tag() -> Optional[str]:
    return _device_stack[-1]


_scope_ids = itertools.count()


@contextlib.contextmanager
def name_scope(prefix: Optional[str] = None):
    """``paddle.static.name_scope``: a uniquely numbered
    ``torch.profiler.record_function`` range, so the prefix shows in
    profiler traces."""
    with torch.profiler.record_function(
            f"{prefix or 'block'}_{next(_scope_ids)}"):
        yield


# -- debug ops ----------------------------------------------------------------

def Print(input, first_n=-1, message=None, summarize=20,  # noqa: A002,N802
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_layout=True,
          print_tensor_lod=False, print_phase="both"):
    """``paddle.static.Print``: identity that prints the value (nothing
    while a program is being traced)."""
    if not (torch.compiler.is_exporting() or torch.compiler.is_compiling()):
        x = input.detach().cpu().numpy() if isinstance(input, torch.Tensor) \
            else np.asarray(input)
        print(message or "", x)
    return input


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """``paddle.static.py_func``: run a host Python function on numpy
    views of ``x``; ``out`` gives the output shapes and dtypes (tensors
    or specs). An optional ``backward_func(*x, *grads)`` becomes the
    gradient through ``torch.autograd.Function``."""
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    many = isinstance(out, (list, tuple))
    dev = xs[0].device if xs and isinstance(xs[0], torch.Tensor) else \
        torch.device("cpu")

    def host(*tensors):
        r = func(*[t.detach().cpu().numpy() for t in tensors])
        rs = r if isinstance(r, (list, tuple)) else [r]
        return tuple(torch.as_tensor(np.asarray(v), device=dev).to(
            convert_dtype(o.dtype)).reshape(tuple(o.shape))
            for v, o in zip(rs, outs))

    if backward_func is None:
        res = host(*xs)
    else:
        class _PyFunc(torch.autograd.Function):
            @staticmethod
            def forward(ctx, *args):
                ctx.save_for_backward(*args)
                return host(*args)

            @staticmethod
            def backward(ctx, *grads):
                args = ctx.saved_tensors
                r = backward_func(*[a.detach().cpu().numpy() for a in args],
                                  *[g.detach().cpu().numpy() for g in grads])
                rs = r if isinstance(r, (list, tuple)) else [r]
                return tuple(torch.as_tensor(np.asarray(v), device=dev).to(
                    a.dtype).reshape(a.shape) for v, a in zip(rs, args))

        res = _PyFunc.apply(*xs)
    return list(res) if many else res[0]


# -- autodiff facades ---------------------------------------------------------

def _walk_leaf_params(t: torch.Tensor) -> List[torch.Tensor]:
    """The leaf tensors requiring grad that ``t``'s graph reaches, in
    the order a depth-first walk from ``t.grad_fn`` meets them."""
    seen, out, stack = set(), [], [t.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or id(node) in seen:
            continue
        seen.add(id(node))
        var = getattr(node, "variable", None)
        if var is not None:
            out.append(var)
        stack.extend(n for n, _ in node.next_functions)
    return out


def append_backward(loss: torch.Tensor, parameter_list=None,
                    no_grad_set=None, callbacks=None, checkpoints=None):
    """``fluid/backward.py:1363``: back-propagates ``loss`` and returns
    the ``(param, grad)`` pairs."""
    params = parameter_list or _walk_leaf_params(loss)
    no_grad = set(id(p) for p in (no_grad_set or []))
    loss.backward()
    return [(p, p.grad) for p in params
            if id(p) not in no_grad and p.grad is not None]


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """``fluid/backward.py:1958``: the gradients of ``targets`` with
    respect to ``inputs`` (None for an input they do not reach or one
    in ``no_grad_set``)."""
    ts = list(targets) if isinstance(targets, (list, tuple)) else [targets]
    xs = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    gs = target_gradients
    if gs is not None and not isinstance(gs, (list, tuple)):
        gs = [gs]
    skip = set(id(v) for v in (no_grad_set or []))
    want = [x for x in xs if id(x) not in skip]
    got = iter(torch.autograd.grad(ts, want, grad_outputs=gs,
                                   allow_unused=True, retain_graph=True))
    return [None if id(x) in skip else next(got) for x in xs]


# -- metrics ------------------------------------------------------------------

def auc(input, label, curve="ROC", num_thresholds=4095,  # noqa: A002
        topk=1, slide_steps=1):
    """``paddle.static.auc`` (``fluid/layers/metric_op.py:257``): ROC AUC
    by the rank statistic, and the positive / negative histograms over
    the thresholds ``[1, num_thresholds + 1]`` as the stat vars."""
    x, y = input, label
    score = x[:, 1] if x.dim() == 2 and x.shape[1] == 2 else x.reshape(-1)
    y = y.reshape(-1).to(torch.float32)
    order = torch.argsort(score, stable=True)
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(1, score.numel() + 1, device=score.device)
    pos = y.sum()
    neg = y.numel() - pos
    sum_rank_pos = torch.where(y > 0, ranks.to(torch.float32), 0.0).sum()
    a = (sum_rank_pos - pos * (pos + 1) / 2.0) / torch.clamp(pos * neg,
                                                             min=1.0)
    bucket = torch.clamp((score * num_thresholds).to(torch.int32), 0,
                         num_thresholds).long()
    hits = (y > 0).to(torch.int32)
    stat_pos = torch.zeros((1, num_thresholds + 1), dtype=torch.int32,
                           device=score.device)
    stat_neg = torch.zeros_like(stat_pos)
    stat_pos[0].index_add_(0, bucket, hits)
    stat_neg[0].index_add_(0, bucket, 1 - hits)
    return a, a.clone(), [stat_pos, stat_neg, stat_pos.clone(),
                          stat_neg.clone()]


# -- program (de)serialization ------------------------------------------------

def serialize_program(feed_vars=None, fetch_vars=None,
                      program: Program = None) -> bytes:
    """``paddle.static.serialize_program``: the exported program and its
    meta as bytes (the program positionally or as ``program=``)."""
    if program is None and isinstance(feed_vars, Program):
        program = feed_vars
    if not isinstance(program, Program):
        raise TypeError("serialize_program needs a Program (pass it "
                        "positionally or as program=...)")
    return pickle.dumps({"program": program.export(),
                         "meta": program.meta()}, protocol=4)


def deserialize_program(data: bytes):
    """``paddle.static.deserialize_program``: the exported program
    (``torch.export.ExportedProgram``; ``.module()`` runs it)."""
    blob = pickle.loads(data)
    return torch.export.load(io.BytesIO(blob["program"]))


def serialize_persistables(feed_vars=None, fetch_vars=None,
                           executor=None, program: Program = None) -> bytes:
    """``paddle.static.serialize_persistables``: parameters and buffers."""
    program = program or feed_vars
    if not isinstance(program, Program):
        raise TypeError("serialize_persistables needs a Program")
    buf = io.BytesIO()
    torch.save(program.state(), buf)
    return buf.getvalue()


def _set_state(program: Program, state: Dict[str, Any]) -> None:
    for k, v in state.items():
        t = torch.as_tensor(v).to(program.device)
        (program.buffers if k in program.buffers else program.params)[k] = t


def deserialize_persistables(program, data: bytes, executor=None):
    """``paddle.static.deserialize_persistables``: loads the state back
    into the Program."""
    _set_state(program, torch.load(io.BytesIO(data), weights_only=True))
    return program


def save_to_file(path: str, content: bytes) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        f.write(content)


def load_from_file(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def normalize_program(program: Program, feed_vars=None, fetch_vars=None):
    """``paddle.static.normalize_program``: a traced program is already
    the inference subgraph, so this is the identity."""
    return program


def save(program: Program, model_path: str, protocol: int = 4,
         **configs) -> None:
    """``paddle.static.save`` (``fluid/io.py:1840``)."""
    program.save(model_path)


def load(program: Program, model_path: str, executor=None,
         var_list=None) -> None:
    """``paddle.static.load`` (``fluid/io.py:1948``): restore the state
    into ``program``."""
    _set_state(program, load_program_state(model_path))


def load_program_state(model_path: str, var_list=None) -> Dict[str, Any]:
    """``paddle.static.load_program_state``: name -> numpy array."""
    state = torch.load(model_path + ".pdiparams", map_location="cpu",
                       weights_only=True)
    return {k: v.numpy() for k, v in state.items()}


def set_program_state(program: Program, state_dict: Dict[str, Any]) -> None:
    _set_state(program, state_dict)


def default_startup_program():
    """``paddle.static.default_startup_program``: initialisation happens
    at parameter creation; the holder's ``random_seed`` seeds torch."""
    return _startup_program


class _StartupProgram:
    def __init__(self):
        self._seed = 0

    @property
    def random_seed(self):
        return self._seed

    @random_seed.setter
    def random_seed(self, s):
        self._seed = int(s)
        torch.manual_seed(self._seed)


_startup_program = _StartupProgram()
