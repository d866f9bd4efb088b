"""The high-level API (port of ``paddle_tpu/hapi/``; the reference's
``python/paddle/hapi/``)."""

from . import callbacks  # noqa: F401
from .callbacks import (Callback, EarlyStopping, LRScheduler,  # noqa: F401
                        ModelCheckpoint, ProgBarLogger,
                        ReduceLROnPlateau, VisualDL)
from .flops import flops  # noqa: F401
from .model import Model  # noqa: F401
