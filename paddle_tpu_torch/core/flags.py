"""Global flags (port of ``paddle_tpu/core/flags.py``).

Flags are plain Python values with environment overrides
(``PT_FLAGS_<name>`` or ``FLAGS_<name>``, read when the flag is
defined), read with :func:`get_flag` / :func:`get_flags` and set at run
time with :func:`set_flags`. The port defines only the flags it reads:

- ``fuse_optimizer`` (default False, ``flags.py:114``): the optimizer
  updates each group of parameters with one dtype and one set of slot
  dtypes in one pass (``optimizer/optimizer.py``), instead of one pass a
  parameter.
- ``default_dtype`` (default ``"float32"``, ``flags.py:109``): the
  floating dtype of new tensors (``core/dtype.py``).
- ``check_nan_inf`` and ``benchmark`` (``flags.py:106-107``): the eager
  dispatch's NaN / Inf scan and per-op timing (``dispatch.py``).
- ``profiler_enabled`` (default False, ``flags.py:111``): collect
  ``RecordEvent`` host events (``core/profiler.py``).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict

_lock = threading.RLock()
_values: Dict[str, Any] = {}
_defaults: Dict[str, Any] = {}
_parsers: Dict[str, Callable[[str], Any]] = {}


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


def define_flag(name: str, default: Any, doc: str = "") -> None:
    """Register ``name`` with ``default``; an environment override, if
    set, is parsed by the default's type."""
    ty = type(default)
    parser = {bool: _parse_bool, int: int, float: float}.get(ty, str)
    value = default
    for env_key in (f"PT_FLAGS_{name}", f"FLAGS_{name}"):
        if env_key in os.environ:
            value = parser(os.environ[env_key])
            break
    with _lock:
        _values[name] = value
        _defaults[name] = default
        _parsers[name] = parser


def get_flag(name: str) -> Any:
    with _lock:
        try:
            return _values[name]
        except KeyError:
            raise KeyError(f"Unknown flag {name!r}") from None


def get_flags(names) -> Dict[str, Any]:
    if isinstance(names, str):
        names = [names]
    return {n: get_flag(n) for n in names}


def set_flags(flags: Dict[str, Any]) -> None:
    """Set each named flag; a string is parsed by the flag's type."""
    with _lock:
        for name, value in flags.items():
            if name not in _values:
                raise KeyError(f"Unknown flag {name!r}")
            if isinstance(value, str) and not isinstance(_defaults[name],
                                                         str):
                value = _parsers[name](value)
            _values[name] = value


define_flag("fuse_optimizer", False,
            "Update each group of parameters with one dtype and one set "
            "of slot dtypes in one pass instead of one pass a parameter.")
define_flag("default_dtype", "float32",
            "Default floating dtype of new tensors (``core/dtype.py``).")
define_flag("check_nan_inf", False,
            "Scan each eager op's floating outputs for NaN / Inf and raise "
            "(``dispatch.call_fn``).")
define_flag("benchmark", False,
            "Synchronise after each eager op and add its microseconds to "
            "the ``op_us/<name>`` stat (``dispatch.call_fn``).")
define_flag("profiler_enabled", False, "Collect RecordEvent host events.")
