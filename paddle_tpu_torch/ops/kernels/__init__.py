"""The port's hand-written CUDA kernels and their launch counts.

Each wrapper adds one to its ``launches`` attribute where it launches
its kernel (never when a CPU tensor sends it to the plain version), so
a run can show that the main path went through the kernels.
"""

from __future__ import annotations

from typing import Dict

from .attention import (attention_bwd_dkv, attention_bwd_dq,
                        attention_bwd_fused, attention_fwd,
                        folded_attention_bwd)
from .fused_conv_block import fused_bottleneck_eval
from .fused_sample import fused_argmax
from .optimizer_update import adam_update
from .paged_attention import decode_out_proj, paged_decode

KERNELS = {
    "paged_decode": paged_decode,
    "decode_out_proj": decode_out_proj,
    "fused_argmax": fused_argmax,
    "attention_fwd": attention_fwd,
    "attention_bwd_fused": attention_bwd_fused,
    "attention_bwd_dq": attention_bwd_dq,
    "attention_bwd_dkv": attention_bwd_dkv,
    "folded_attention_bwd": folded_attention_bwd,
    "fused_bottleneck": fused_bottleneck_eval,
    "adam_update": adam_update,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: int(fn.launches) for name, fn in KERNELS.items()}
