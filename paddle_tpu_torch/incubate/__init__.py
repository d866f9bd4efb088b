"""Incubating APIs (port of ``paddle_tpu/incubate/__init__.py``;
reference: ``python/paddle/incubate/__init__.py`` ``__all__``):
``LookAhead`` and ``ModelAverage`` from the optimizer wrappers, and the
segment ops the reference keeps under ``incubate.tensor``. All of them
are the port's own ``optimizer/wrappers.py`` and ``ops/decode_extra.py``;
this is their namespace.
"""

from ..ops.decode_extra import (segment_max, segment_mean,  # noqa: F401
                                segment_min, segment_sum)
from ..optimizer.wrappers import Lookahead as LookAhead  # noqa: F401
from ..optimizer.wrappers import ModelAverage  # noqa: F401

__all__ = ["LookAhead", "ModelAverage", "segment_sum", "segment_mean",
           "segment_max", "segment_min"]
