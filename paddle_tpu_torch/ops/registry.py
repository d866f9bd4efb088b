"""The op registry (port of ``paddle_tpu/ops/registry.py`` and of
``paddle_tpu/ops/__init__.py``'s ``_auto_register``).

It holds the JAX package's names, module by module in its order
(``_jax_names.JAX_OPS``): under each, the port's function of that name
in the same module, or, where the port has none yet, a stub that
raises ``NotImplementedError`` naming ROADMAP.md (one is left:
``paged_attention_head_sharded``, which waits for tensor-parallel
serving). No name is silently missing. The eager wrappers over these
functions are ``dispatch.py``'s.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from ._jax_names import DYNAMIC_SHAPE_OPS, JAX_OPS, NON_DIFF_OPS

# the port's modules whose functions the dispatch layer casts under
# auto_cast (the others call amp.amp_cast themselves)
DISPATCH_AMP_MODULES = frozenset({"creation", "math", "manipulation",
                                  "search", "random", "math_extra"})

# the JAX modules the port has, in whole or in part
PORTED_MODULES = frozenset({"creation", "math", "manipulation", "search",
                            "random", "math_extra", "nn_functional", "rnn",
                            "vision_extra", "detection", "loss_extra",
                            "decode_extra", "linalg", "fft", "sequence",
                            "metric_extra", "nlp_ctr_extra"})


@dataclass
class OpDef:
    name: str
    fn: Callable
    module: str = ""
    differentiable: bool = True
    dynamic_shape: bool = False
    ported: bool = True
    first_param: str = ""


_REGISTRY: Dict[str, OpDef] = {}


def register_op(name: str, fn: Optional[Callable] = None, *,
                differentiable: bool = True, dynamic_shape: bool = False,
                module: str = "") -> Callable:
    def deco(f: Callable) -> Callable:
        _REGISTRY[name] = OpDef(name, f, module or f.__module__,
                                differentiable, dynamic_shape)
        return f
    if fn is not None:
        return deco(fn)
    return deco


def get_op(name: str) -> OpDef:
    from ..core.enforce import NotFoundError
    if name not in _REGISTRY:
        raise NotFoundError(f"Op {name!r} is not registered")
    return _REGISTRY[name]


def has_op(name: str) -> bool:
    return name in _REGISTRY


def all_ops() -> Dict[str, OpDef]:
    return dict(_REGISTRY)


def not_ported(name: str, module: str) -> Callable:
    """A stub for an op the JAX package registers and the port has not
    ported yet."""
    def stub(*args, **kwargs):
        raise NotImplementedError(
            f"paddle_tpu_torch: op {name!r} (paddle_tpu/ops/{module}.py) is "
            f"not ported yet; see ROADMAP.md, Queue 1 item 4")
    stub.__name__ = stub.__qualname__ = name
    stub.__doc__ = (f"Not ported yet: ``paddle_tpu/ops/{module}.py`` "
                    f"``{name}`` (ROADMAP.md, Queue 1 item 4).")
    return stub


def _auto_register() -> None:
    modules = {}
    for module, name, first in JAX_OPS:
        if module in PORTED_MODULES and module not in modules:
            modules[module] = importlib.import_module(f".{module}",
                                                      __package__)
        fn = getattr(modules.get(module), name, None)
        ported = callable(fn)
        if not ported:
            fn = not_ported(name, module)
        _REGISTRY[name] = OpDef(name, fn, module,
                                differentiable=name not in NON_DIFF_OPS,
                                dynamic_shape=name in DYNAMIC_SHAPE_OPS,
                                ported=ported, first_param=first)


_auto_register()
