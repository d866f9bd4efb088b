"""Places and the expected device (port of ``paddle_tpu/core/place.py``).

A place names a device slot. ``CPUPlace`` resolves to the CPU and
``CUDAPlace`` / ``GPUPlace`` to a CUDA device through
``device.resolve_device``, which raises without a usable GPU.
``CUDAPinnedPlace`` is host memory. ``TPUPlace``, ``NPUPlace`` and
``XPUPlace`` exist as names and raise when resolved: the port runs on
CUDA or on the CPU.

The expected place (:func:`set_device` / :func:`get_device`) is where
the eager API creates tensors and where the port's layers put their
parameters when no device is named. It is the card until
``set_device("cpu")``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


class Place:
    """A logical device slot: platform + device index."""

    platform: str = "cpu"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def __eq__(self, other) -> bool:
        return (isinstance(other, Place) and self.platform == other.platform
                and self.device_id == other.device_id)

    def __hash__(self) -> int:
        return hash((self.platform, self.device_id))

    def __repr__(self) -> str:
        return f"Place({self.platform}:{self.device_id})"

    @property
    def torch_device(self) -> torch.device:
        """The ``torch.device`` of this place; raises for a platform the
        port does not run on, and for CUDA without a GPU."""
        from ..device import resolve_device
        if self.platform == "cpu":
            return torch.device("cpu")
        if self.platform == "gpu":
            return resolve_device(f"cuda:{self.device_id}")
        raise RuntimeError(f"{type(self).__name__}: the port runs on CUDA "
                           f"or the CPU, not on {self.platform}")


class CPUPlace(Place):
    platform = "cpu"


class GPUPlace(Place):
    platform = "gpu"


CUDAPlace = GPUPlace


class CUDAPinnedPlace(Place):
    """Page-locked host staging memory: host memory here."""
    platform = "cpu"

    def __init__(self):
        super().__init__(0)


class TPUPlace(Place):
    platform = "tpu"


class NPUPlace(Place):
    platform = "npu"


class XPUPlace(Place):
    platform = "xpu"


_PLATFORMS = {"cpu": CPUPlace, "gpu": GPUPlace, "cuda": GPUPlace,
              "tpu": TPUPlace, "npu": NPUPlace, "xpu": XPUPlace}

_expected_place: Optional[Place] = None


def place_of(device: Union[str, torch.device, Place]) -> Place:
    """The place of a device spelling (``"cpu"``, ``"gpu:0"``,
    ``"cuda"``, a ``torch.device`` or a place)."""
    if isinstance(device, Place):
        return device
    if isinstance(device, torch.device):
        return CPUPlace() if device.type == "cpu" else GPUPlace(
            device.index or 0)
    name, _, idx = str(device).partition(":")
    cls = _PLATFORMS.get(name.lower())
    if cls is None:
        raise ValueError(f"Unknown device {device!r}")
    if cls is CUDAPinnedPlace:
        return cls()
    return cls(int(idx) if idx else 0)


def set_device(device: Union[str, Place]) -> Place:
    """Set the expected place, e.g. ``set_device("cpu")`` or
    ``set_device("gpu:0")``. Resolves it at once, so a place the port
    cannot run on raises here."""
    global _expected_place
    place = place_of(device)
    place.torch_device
    _expected_place = place
    return place


def get_device() -> str:
    p = expected_place()
    return f"{p.platform}:{p.device_id}"


def expected_place() -> Place:
    """The place set by :func:`set_device`, else the card."""
    return _expected_place if _expected_place is not None else GPUPlace(0)


def expected_spelling() -> str:
    """The expected place as a device string, without resolving it:
    ``"cuda"`` until :func:`set_device` names another place."""
    if _expected_place is None:
        return "cuda"
    if _expected_place.platform == "gpu":
        return f"cuda:{_expected_place.device_id}"
    return _expected_place.platform


def expected_device() -> torch.device:
    """The expected place as a ``torch.device`` (raises on a host
    without a GPU until ``set_device("cpu")``)."""
    return expected_place().torch_device


def reset_device() -> None:
    """Forget :func:`set_device`: the card is expected again."""
    global _expected_place
    _expected_place = None


def device_count(platform: Optional[str] = None) -> int:
    if platform is None:
        platform = expected_place().platform
    if platform == "gpu":
        return torch.cuda.device_count()
    return 1
