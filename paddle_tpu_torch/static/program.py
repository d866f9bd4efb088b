"""Program / Executor over exported PyTorch programs (port of
``paddle_tpu/static/program.py``).

A :class:`Program` is ``fn(params, buffers, *inputs)`` with the state
it runs on; :meth:`Program.save` writes the port's own format:

- ``.pdmodel``: ``torch.export.save`` of ``fn`` traced at the input
  specs' static shapes (``None`` / ``-1`` become 1, as the JAX package
  pins them), with the parameters and buffers as graph inputs, as the
  JAX artefact takes its parameters. A Layer is traced through
  ``torch.func.functional_call`` under ``torch.no_grad()``.
- ``.pdiparams``: name -> CPU tensor, parameters and buffers
  (``torch.save``; read back with ``weights_only=True``).
- ``.pdmeta``: the JAX package's fields (``input_specs``, ``name``) and
  the port's two: ``device``, the device the program was exported on,
  and ``buffers``, the names of ``.pdiparams`` that are buffers. JSON.

A program is exported on its layer's device: the graph holds the
kernel choices the model made there at those shapes, as the StableHLO
holds the TPU's. The forward kernels are registered ops
(``paddle_tpu_torch::attention_fwd``, ``paddle_tpu_torch::
fused_bottleneck``), so a program exported on the card launches them
when loaded; the other kernels refuse to be traced. A loaded program
runs its graph op by op (no graph replay).
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import warnings
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils import _pytree as pytree

from ..device import DeviceLike, module_device, resolve_device
from ..io.collate import default_collate_fn

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
           "int32": torch.int32, "int64": torch.int64, "bool": torch.bool}


def convert_dtype(dtype) -> torch.dtype:
    """A dtype named as a string, a numpy dtype or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name if not isinstance(dtype, str) else dtype
    if name not in _DTYPES:
        raise TypeError(f"dtype {dtype!r} has no torch counterpart here")
    return _DTYPES[name]


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


class InputSpec:
    """Symbolic input description (``paddle.static.InputSpec``)."""

    def __init__(self, shape, dtype="float32", name: Optional[str] = None):
        self.shape = tuple(shape)
        self.dtype = convert_dtype(dtype)
        self.name = name

    def static_shape(self) -> tuple:
        """The traced shape: ``None`` and ``-1`` become 1
        (``program.py:30``)."""
        return tuple(1 if (s is None or s == -1) else int(s)
                     for s in self.shape)

    def example(self, device) -> torch.Tensor:
        return torch.zeros(self.static_shape(), dtype=self.dtype,
                           device=device)

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={dtype_name(self.dtype)}"
                f", name={self.name!r})")

    @classmethod
    def from_tensor(cls, t, name=None):
        return cls(tuple(t.shape), t.dtype, name)


def _as_input(x, spec: InputSpec, device) -> torch.Tensor:
    """A feed value (tensor, numpy array or number) as a tensor of the
    spec's dtype on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=spec.dtype)
    return torch.as_tensor(np.array(x), device=device).to(spec.dtype)


class _Traced(nn.Module):
    """The traced signature, ``forward(params, buffers, *inputs)``. The
    function is held as a plain attribute, so a layer it closes over is
    no submodule and its weights enter the graph only as inputs."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, params, buffers, *inputs):
        return self.fn(params, buffers, *inputs)


class Program:
    """A traceable computation and the state it runs on.

    ``fn(params, buffers, *inputs)`` is pure over its arguments;
    :meth:`run` calls it eagerly, :meth:`exported` traces it with
    ``torch.export`` at the input specs' static shapes on ``device``."""

    def __init__(self, fn: Callable, input_specs: Sequence[InputSpec],
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 name: str = "main",
                 buffers: Optional[Dict[str, torch.Tensor]] = None,
                 device: DeviceLike = None):
        self.fn = fn
        self.input_specs = list(input_specs)
        self.params = dict(params or {})
        self.buffers = dict(buffers or {})
        self.name = name
        self.device = torch.device(device) if device is not None else \
            resolve_device(None)
        self._exported = None

    # -- execution ------------------------------------------------------------

    def run(self, *inputs):
        xs = [_as_input(x, s, self.device)
              for x, s in zip(inputs, self.input_specs)]
        with torch.no_grad():
            return self.fn(self.params, self.buffers, *xs)

    # -- introspection (Program surface) -------------------------------------

    def exported(self) -> torch.export.ExportedProgram:
        """The ``torch.export`` trace (cached). Its example inputs are
        dropped, so a saved program holds its weights once, in
        ``.pdiparams``."""
        if self._exported is None:
            examples = [s.example(self.device) for s in self.input_specs]
            with torch.no_grad():
                ep = torch.export.export(
                    _Traced(self.fn), (self.params, self.buffers, *examples),
                    strict=False)
            ep.example_inputs = None
            self._exported = ep
        return self._exported

    def lowered_text(self) -> str:
        return str(self.exported().graph)

    def num_ops(self) -> int:
        return sum(1 for n in self.exported().graph.nodes
                   if n.op == "call_function")

    def __str__(self):
        return self.lowered_text()

    # -- serialization --------------------------------------------------------

    def export(self) -> bytes:
        buf = io.BytesIO()
        torch.export.save(self.exported(), buf)
        return buf.getvalue()

    def meta(self) -> dict:
        return {"input_specs": [(list(s.shape), dtype_name(s.dtype), s.name)
                                for s in self.input_specs],
                "name": self.name, "device": str(self.device),
                "buffers": sorted(self.buffers)}

    def state(self) -> Dict[str, torch.Tensor]:
        """Parameters and buffers, name -> CPU tensor."""
        return {k: v.detach().cpu() for k, v in
                {**self.params, **self.buffers}.items()}

    def save(self, path_prefix: str) -> None:
        d = os.path.dirname(path_prefix)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path_prefix + ".pdmodel", "wb") as f:
            f.write(self.export())
        torch.save(self.state(), path_prefix + ".pdiparams")
        with open(path_prefix + ".pdmeta", "w") as f:
            json.dump(self.meta(), f)


def read_meta(path_prefix: str) -> dict:
    with open(path_prefix + ".pdmeta") as f:
        return json.load(f)


class LoadedProgram:
    """A program read back from its three files.

    It runs on the device it was exported for: ``device`` (a type or a
    device) names the one the caller wants, and another type raises,
    naming both; ``None`` takes the program's. A CUDA program needs a
    GPU (it raises without one).

    ``precision``: None / ``"float32"`` keeps the exported dtypes;
    ``"bfloat16"`` / ``"float16"`` stores the floating parameters in that
    type (buffers stay as exported, as the JAX artefact bakes its
    buffers in) and casts them back to the signature's dtypes at each
    call (``program.py:105-143``)."""

    def __init__(self, path_prefix: str, precision: Optional[str] = None,
                 device: DeviceLike = None):
        meta = read_meta(path_prefix)
        saved = torch.device(meta["device"])
        if device is not None and torch.device(device).type != saved.type:
            raise RuntimeError(
                f"{path_prefix!r} was exported for {saved}, and its graph "
                f"holds that device's kernel choices; it cannot run on "
                f"{torch.device(device)}: export it again there")
        self.device = resolve_device(saved.type)
        self.input_specs = [InputSpec(s, d, n)
                            for s, d, n in meta["input_specs"]]
        self.name = meta.get("name", "main")
        with open(path_prefix + ".pdmodel", "rb") as f:
            self.exported = torch.export.load(io.BytesIO(f.read()))
        self._module = self.exported.module()
        state = torch.load(path_prefix + ".pdiparams", map_location="cpu",
                           weights_only=True)
        names = set(meta.get("buffers", ()))
        self.buffers = {k: v.to(self.device) for k, v in state.items()
                        if k in names}
        self.params = {k: v.to(self.device) for k, v in state.items()
                       if k not in names}
        self._orig_dtypes = {k: v.dtype for k, v in self.params.items()}
        if precision in ("bfloat16", "float16"):
            low = convert_dtype(precision)
            self.params = {k: (v.to(low) if v.is_floating_point() else v)
                           for k, v in self.params.items()}

    def run(self, *inputs):
        xs = [_as_input(x, s, self.device)
              for x, s in zip(inputs, self.input_specs)]
        orig = self._orig_dtypes
        params = {k: (v.to(orig[k]) if v.dtype != orig[k] else v)
                  for k, v in self.params.items()}
        with torch.no_grad():
            return self._module(params, self.buffers, *xs)


def build_program(layer_or_fn, input_specs: Sequence[InputSpec],
                  training: bool = False, *,
                  device: DeviceLike = None) -> Program:
    """Capture a Layer or function into a Program. A Layer's program
    runs on the Layer's device; a function's on ``device`` (CUDA unless
    the caller names another, raising without a GPU)."""
    specs = [s if isinstance(s, InputSpec) else InputSpec(*s)
             for s in input_specs]
    if isinstance(layer_or_fn, nn.Module):
        layer = layer_or_fn
        layer.train(training)
        params = {k: v.detach() for k, v in layer.named_parameters()}
        buffers = {k: v for k, v in layer.named_buffers()}

        def fn(params, buffers, *inputs):
            return torch.func.functional_call(layer, (params, buffers),
                                              tuple(inputs))

        return Program(fn, specs, params=params, buffers=buffers,
                       name=type(layer).__name__,
                       device=device or module_device(layer))

    def fn(params, buffers, *inputs):
        return layer_or_fn(*inputs)

    return Program(fn, specs, device=resolve_device(device))


# -- reference-compatible module-level API -----------------------------------

_default_program: Optional[Program] = None


def default_main_program():
    return _default_program


@contextlib.contextmanager
def program_guard(main_program=None, startup_program=None):
    """Compatibility shim: no global graph is under construction; yields
    the program for API parity."""
    global _default_program
    prev = _default_program
    _default_program = main_program
    try:
        yield main_program
    finally:
        _default_program = prev


def data(name: str, shape, dtype="float32", lod_level=0):
    """Symbolic placeholder (``paddle.static.data``): an InputSpec
    consumed by build_program."""
    return InputSpec(shape, dtype, name)


class CompiledProgram:
    """Reference-API shim: the program is traced at export."""

    def __init__(self, program_or_graph, build_strategy=None):
        self.program = program_or_graph


def _to_tensors(tree, device):
    """Numpy leaves of a collated batch as tensors on ``device``."""
    def conv(v):
        if isinstance(v, np.ndarray):
            return torch.as_tensor(v, device=device)
        return v.to(device) if isinstance(v, torch.Tensor) else v
    return pytree.tree_map(conv, tree)


class Executor:
    """Runs Programs (``fluid/executor.py:475`` ``Executor.run`` with
    feed / fetch). Feed keys map to input spec names, positionally when
    unnamed."""

    def __init__(self, place=None):
        self.place = place

    def run(self, program: Program = None, feed: Optional[Dict] = None,
            fetch_list=None, return_numpy: bool = True):
        program = program or _default_program
        feed = feed or {}
        inputs = []
        for i, spec in enumerate(program.input_specs):
            key = spec.name or f"x{i}"
            if key in feed:
                inputs.append(feed[key])
            else:
                vals = list(feed.values())
                inputs.append(vals[i] if i < len(vals) else None)
        leaves = pytree.tree_leaves(program.run(*inputs))
        if return_numpy:
            leaves = [l.detach().cpu().numpy() for l in leaves]
        return leaves

    # -- dataset-driven training (executor.py:1662 train_from_dataset over
    #    framework/trainer.h trainers) ---------------------------------------

    _default_collate = staticmethod(default_collate_fn)

    def _dataset_step_fn(self, program, collate_fn, train: bool,
                         fetches: Optional[Dict] = None):
        collate = collate_fn or self._default_collate

        if isinstance(program, Program):
            names = [s.name or f"x{i}"
                     for i, s in enumerate(program.input_specs)]

            def step(batch, worker_id):
                b = collate(batch)
                if isinstance(b, dict):
                    # feed by declared input name, never by dict order
                    if all(n in b for n in names):
                        vals = [b[n] for n in names]
                    else:
                        missing = [n for n in names if n not in b]
                        raise KeyError(
                            f"batch keys {sorted(b)} do not cover program "
                            f"inputs {names} (missing {missing}); name "
                            "the InputSpecs after the sample slots")
                else:
                    vals = list(b) if isinstance(b, (tuple, list)) else [b]
                leaves = pytree.tree_leaves(program.run(*vals))
                if fetches is not None:
                    fetches["last"] = [l.detach().cpu().numpy()
                                       for l in leaves]
                # a scalar first output is the loss; anything else
                # contributes no loss metric (pure scoring programs)
                if leaves and leaves[0].dim() == 0:
                    return leaves[0].detach().cpu()
                return None
            return step

        if callable(program):  # e.g. a jit.TrainStep
            if not train and (hasattr(program, "optimizer") or
                              hasattr(program, "opt_state")):
                raise TypeError(
                    "infer_from_dataset must not mutate state: pass a "
                    "Program or a pure callable, not a TrainStep")
            model = getattr(program, "model", None)
            device = module_device(model) if model is not None else None

            def step(batch, worker_id):
                out = program(_to_tensors(collate(batch), device))
                if isinstance(out, torch.Tensor):
                    return out.detach().cpu()
                return out
            return step

        raise TypeError("train_from_dataset needs a Program or a callable "
                        f"step (got {type(program).__name__})")

    def _run_dataset(self, program, dataset, thread, debug, fetch_list,
                     collate_fn, trainer, train, trainer_kwargs):
        from ..framework.trainer import TrainerFactory
        if dataset is None:
            raise ValueError("dataset is required")
        fetches: Optional[Dict] = {} if fetch_list is not None else None
        step = self._dataset_step_fn(program, collate_fn, train=train,
                                     fetches=fetches)
        tr = TrainerFactory.create(
            trainer, step,
            thread_num=thread or getattr(dataset, "thread_num", 1) or 1,
            **trainer_kwargs)
        result = tr.run(dataset, debug=debug)
        if fetches is not None:
            result["fetches"] = fetches.get("last")
        return result

    def train_from_dataset(self, program=None, dataset=None, thread: int = 0,
                           debug: bool = False, fetch_list=None,
                           collate_fn=None, trainer: str = "MultiTrainer",
                           **trainer_kwargs):
        """Run the trainer's workers over the dataset's channels; returns
        ``{'steps', 'avg_loss'}`` and, with ``fetch_list``, ``'fetches'``
        (the last step's outputs)."""
        return self._run_dataset(program, dataset, thread, debug,
                                 fetch_list, collate_fn, trainer, True,
                                 trainer_kwargs)

    def infer_from_dataset(self, program=None, dataset=None, thread: int = 0,
                           debug: bool = False, fetch_list=None,
                           collate_fn=None, trainer: str = "MultiTrainer",
                           **trainer_kwargs):
        """The same worker loop for pure scoring: refuses a TrainStep."""
        return self._run_dataset(program, dataset, thread, debug,
                                 fetch_list, collate_fn, trainer, False,
                                 trainer_kwargs)


def _example_input(v, rng, device) -> torch.Tensor:
    """A concrete random input for a feed var (InputSpec or tensor) on
    ``device``, from the caller's numpy ``rng`` as the JAX package draws
    it (``program.py:323-342``): small random ids for integer feeds,
    standard normals for floating ones."""
    if isinstance(v, torch.Tensor):
        return v
    spec = v if isinstance(v, InputSpec) else InputSpec.from_tensor(v)
    shape = spec.static_shape()
    if spec.dtype == torch.bool:
        arr = rng.integers(0, 2, shape).astype(np.bool_)
    elif not spec.dtype.is_floating_point:
        arr = rng.integers(0, 16, shape).astype(dtype_name(spec.dtype))
    else:
        arr = rng.standard_normal(shape).astype(np.float32)
    return torch.as_tensor(arr, device=device).to(spec.dtype)


def save_inference_model(path_prefix: str, feed_vars, fetch_vars=None,
                         executor=None, program=None, layer=None,
                         optimize: bool = True) -> None:
    """``paddle.static.save_inference_model``: a prebuilt Program, or
    ``layer`` traced at the ``feed_vars`` specs on its own device.

    ``optimize=True`` folds conv + BN on a COPY of an eval-mode layer
    (``inference/fusion.py``) and keeps the fold only if it holds on
    three seeded random examples (``program.py:356-395``); the caller's
    layer is never changed."""
    if program is None:
        if layer is not None and optimize and not layer.training:
            from ..inference.fusion import (find_foldable_pairs,
                                            fold_preserves_outputs,
                                            fuse_conv_bn)
            if next(find_foldable_pairs(layer), None) is not None:
                folded = copy.deepcopy(layer)
                fuse_conv_bn(folded)
                dev = module_device(layer)
                examples = [
                    [_example_input(v, np.random.default_rng(seed), dev)
                     for v in feed_vars] for seed in (0, 1, 2)]
                if fold_preserves_outputs(layer, folded, examples):
                    layer = folded
                else:
                    warnings.warn(
                        "conv+BN folding changed the model's outputs "
                        "(pre-activation topology?); exporting UNFUSED. "
                        "Pass optimize=False to silence this check.")
        specs = [v if isinstance(v, InputSpec) else InputSpec.from_tensor(v)
                 for v in feed_vars]
        program = build_program(layer, specs)
    program.save(path_prefix)


def load_inference_model(path_prefix: str, executor=None,
                         device: DeviceLike = None) -> LoadedProgram:
    """``paddle.static.load_inference_model``: the program on the device
    it was exported for (``device`` names another only to raise)."""
    return LoadedProgram(path_prefix, device=device)
