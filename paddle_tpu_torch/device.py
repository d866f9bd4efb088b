"""Device resolution for the PyTorch port.

Every entry point of the port (the model constructor,
``create_decode_engine``, ``ServingServer`` and the serving CLI) runs on
the GPU unless the caller names another device. There is no silent
move to the CPU: asking for CUDA on a host without a usable GPU raises.
"""

from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means CUDA. Raises
    ``RuntimeError`` when CUDA is asked for (explicitly or by default)
    and ``torch.cuda.is_available()`` is false."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on CUDA by default and this host "
                "has no usable GPU; pass device='cpu' explicitly to run "
                "the plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    setup_precision()
    return dev


def setup_precision() -> None:
    """Full fp32 matmuls and convolutions: TF32 keeps ~3 decimal digits,
    and the port serves fp32 exactly as the JAX server does."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def module_device(module: torch.nn.Module) -> torch.device:
    """The device a module's parameters live on."""
    return next(module.parameters()).device
