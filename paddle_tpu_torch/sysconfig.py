"""Build configuration paths (port of ``paddle_tpu/sysconfig.py``;
reference: ``python/paddle/sysconfig.py`` ``get_include`` / ``get_lib``
for compiling custom ops against the install)."""

from __future__ import annotations

import os


def _root() -> str:
    return os.path.dirname(os.path.abspath(__file__))


def get_include() -> str:
    """Directory with the C headers for custom-op builds: the repo's
    ``native/`` (``pt_custom_op.h``)."""
    return os.path.join(os.path.dirname(_root()), "native")


def get_lib() -> str:
    """Directory with the native shared library: the repo's
    ``native/``."""
    return os.path.join(os.path.dirname(_root()), "native")
