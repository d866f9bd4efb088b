"""Automatic mixed precision of the port (``paddle_tpu.amp``):
``auto_cast`` over the reference's white and black op lists, ``decorate``
for O2, and ``GradScaler`` / ``AmpScaler`` for fp16 loss scaling."""

from .auto_cast import (amp_cast, amp_state, amp_target_dtype, auto_cast,
                        black_list as AMP_BLACK_LIST, decorate,
                        record_casts, white_list as AMP_WHITE_LIST)
from .grad_scaler import AmpScaler, GradScaler

__all__ = ["AMP_BLACK_LIST", "AMP_WHITE_LIST", "AmpScaler", "GradScaler",
           "amp_cast", "amp_state", "amp_target_dtype", "auto_cast",
           "decorate", "record_casts"]
