"""Utility subpackage (port of ``paddle_tpu/utils/__init__.py``;
reference: ``python/paddle/utils/``): ``deprecated``,
``require_version``, ``try_import``, ``unique_name``, ``download`` and
``run_check``. Ported in part: ``cpp_extension`` (custom C ops over
``native/pt_custom_op.h``) waits for ROADMAP.md's Queue 1, item 5, and
raises ``NotImplementedError`` naming it.
"""

from .._not_ported import NotPorted
from ..framework import unique_name  # noqa: F401
from . import download  # noqa: F401
from .download import (get_path_from_url,  # noqa: F401
                       get_weights_path_from_url)
from .install_check import run_check  # noqa: F401

cpp_extension = NotPorted("utils.cpp_extension",
                          "paddle_tpu/utils/cpp_extension.py")


def deprecated(update_to="", since="", reason="", level=0):
    """Decorator marking an API deprecated (reference:
    ``paddle.utils.deprecated``): warns on call; ``level=2`` raises."""
    import functools
    import warnings

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            msg = f"API {fn.__module__}.{fn.__name__} is deprecated"
            if since:
                msg += f" since {since}"
            if update_to:
                msg += f", use {update_to} instead"
            if reason:
                msg += f" ({reason})"
            if level == 2:
                raise RuntimeError(msg)
            warnings.warn(msg, DeprecationWarning, stacklevel=2)
            return fn(*args, **kwargs)
        wrapper.__deprecated__ = True
        return wrapper
    return deco


def require_version(min_version: str, max_version=None) -> None:
    """Check the framework's version (``paddle_tpu_torch.__version__``)
    against bounds (reference: ``paddle.utils.require_version``)."""
    import paddle_tpu_torch

    def parse(v):
        return tuple(int(p) for p in str(v).split(".")[:3] if p.isdigit())

    cur = parse(paddle_tpu_torch.__version__)
    if parse(min_version) > cur:
        raise RuntimeError(
            f"paddle_tpu_torch>={min_version} required, found "
            f"{paddle_tpu_torch.__version__}")
    if max_version is not None and parse(max_version) < cur:
        raise RuntimeError(
            f"paddle_tpu_torch<={max_version} required, found "
            f"{paddle_tpu_torch.__version__}")


def try_import(module_name: str, err_msg: str = None):
    """Import a soft dependency with a friendly error (reference:
    ``paddle.utils.lazy_import.try_import``)."""
    import importlib
    try:
        return importlib.import_module(module_name)
    except ImportError:
        raise ImportError(
            err_msg or f"Optional dependency {module_name!r} is not "
            f"installed; install it to use this feature") from None
