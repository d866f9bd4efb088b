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
    """``device`` as a ``torch.device``; ``None`` means the expected
    place (``core/place.py``: CUDA until ``set_device`` names another),
    and a place resolves to its device. Raises ``RuntimeError`` when
    CUDA is asked for (explicitly or by default) and
    ``torch.cuda.is_available()`` is false."""
    from .core import place
    if device is None:
        device = place.expected_spelling()
    elif isinstance(device, place.Place):
        return device.torch_device
    dev = torch.device(device)
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


# -- ``paddle.device`` (port of ``paddle_tpu/device.py``) ---------------------

def set_device(device):
    """Set the expected place (``"cpu"``, ``"gpu"``, ``"gpu:0"``)."""
    from .core.place import set_device as _set
    return _set(device)


def get_device() -> str:
    from .core.place import get_device as _get
    return _get()


def is_compiled_with_cuda() -> bool:
    return torch.cuda.is_available()


def is_compiled_with_rocm() -> bool:
    return torch.version.hip is not None


def is_compiled_with_tpu() -> bool:
    return False


def is_compiled_with_npu() -> bool:
    return False


def is_compiled_with_xpu() -> bool:
    return False


def get_cudnn_version():
    """cuDNN's version as an int, or None without cuDNN."""
    return torch.backends.cudnn.version()


def __getattr__(name):
    if name == "XPUPlace":
        from .core.place import XPUPlace
        return XPUPlace
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
