"""Process-global activation offload and remat selection (port of
``paddle_tpu/core/offload.py``).

Reference parity: ``recompute_configs.enable_offload`` moves checkpointed
activations to host memory. In the JAX package the rematerialised
blocks' ``jax.checkpoint`` calls take an offload policy; in the port a
rematerialised block runs under ``torch.utils.checkpoint`` (non-reentrant),
which saves exactly one tensor for backward, the block's input, and
with offload on (:func:`set_activation_offload`) that input is kept in
pinned host memory and copied back to the device when the block's
backward recomputes it (:func:`offload_block_inputs`, a
``torch.autograd.graph.saved_tensors_hooks`` pair in the manner of
``save_on_cpu(pin_memory=True)``). The copies are exact: offload moves
storage and computes nothing new.

The remat selection (:func:`set_remat_saved_names` and the scoped
:func:`override_remat_saved_names`) names the activations a
rematerialised block keeps on the device instead of recomputing. The one
name defined is :data:`ATTN_OUT_NAME`, the attention kernel's forward
outputs (``models/gpt.py`` ``_remat_block`` keeps them in a
``SavedAttention``). The switch and the selection are read when a block
runs its forward, as the JAX package reads them at trace time.

:func:`name_block_input` and :func:`name_activation` return their
argument: in the port a block's input is what the checkpoint saves, and
the saved activation is chosen by the attention entry, so no tensor
carries a name.
"""

from __future__ import annotations

import contextlib as _contextlib
import threading as _threading
from typing import NamedTuple, Optional

import torch

__all__ = ["ATTN_OUT_NAME", "RematPolicy", "activation_offload_enabled",
           "name_activation", "name_block_input", "offload_block_inputs",
           "offload_stats", "override_remat_saved_names",
           "remat_policy", "remat_saved_names", "reset_offload_stats",
           "set_activation_offload", "set_remat_saved_names"]

_activation_offload = False

# the one named activation: the attention kernel's forward outputs
# (out and lse of the flash entry, out of the folded one)
ATTN_OUT_NAME = "attn_out"

# the name of a rematerialised block's input, the tensor offload stages
BLOCK_INPUT_NAME = "remat_block_in"

_remat_saved_names: tuple = ()


class RematPolicy(NamedTuple):
    """What a rematerialised block keeps: ``saved`` names the
    activations kept on the device, ``offloaded`` the ones kept in
    pinned host memory (``(BLOCK_INPUT_NAME,)`` with offload on)."""
    saved: tuple
    offloaded: tuple


def set_activation_offload(enabled: bool) -> None:
    global _activation_offload
    _activation_offload = bool(enabled)


def activation_offload_enabled() -> bool:
    return _activation_offload


def set_remat_saved_names(names) -> None:
    """Select the named activations that rematerialised blocks keep
    rather than recompute."""
    global _remat_saved_names
    _remat_saved_names = tuple(names)


@_contextlib.contextmanager
def override_remat_saved_names(names):
    """Scoped selection: a model that opted into selective remat wraps
    its forward in this, so its choice never leaks into other models.
    Nesting restores the previous selection on exit."""
    global _remat_saved_names
    prev = _remat_saved_names
    _remat_saved_names = tuple(names)
    try:
        yield
    finally:
        _remat_saved_names = prev


def remat_saved_names() -> tuple:
    return _remat_saved_names


def remat_policy() -> Optional[RematPolicy]:
    """The policy of the rematerialised blocks (None = plain full
    remat). With offload on, the block inputs, the only tensors a fully
    rematerialised block saves, go to pinned host memory; the named
    saved activations stay on the device in both modes."""
    if _activation_offload:
        return RematPolicy(_remat_saved_names, (BLOCK_INPUT_NAME,))
    if _remat_saved_names:
        return RematPolicy(_remat_saved_names, ())
    return None


def name_block_input(x):
    """The block input as it is: the checkpoint saves it by position."""
    return x


def name_activation(x, name: str):
    """``x`` as it is: the port keeps a saved activation by its entry
    (``ATTN_OUT_NAME``: the attention kernels' ``SavedAttention``)."""
    return x


# counts of the offload hooks: tensors packed to the host and their
# bytes, tensors copied back
_STATS = {"packed": 0, "bytes": 0, "unpacked": 0}
_STATS_LOCK = _threading.Lock()


def offload_stats() -> dict:
    with _STATS_LOCK:
        return dict(_STATS)


def reset_offload_stats() -> None:
    with _STATS_LOCK:
        for k in _STATS:
            _STATS[k] = 0


def _pack(t: torch.Tensor):
    if t.numel() == 0:  # the checkpoint's placeholder on some torch builds
        return t
    pin = t.device.type == "cuda"
    host = torch.empty(t.size(), dtype=t.dtype, layout=t.layout,
                       pin_memory=pin)
    host.copy_(t, non_blocking=pin)
    with _STATS_LOCK:
        _STATS["packed"] += 1
        _STATS["bytes"] += t.numel() * t.element_size()
    return t.device, host


def _unpack(packed) -> torch.Tensor:
    if isinstance(packed, torch.Tensor):
        return packed
    device, host = packed
    with _STATS_LOCK:
        _STATS["unpacked"] += 1
    return host.to(device, non_blocking=device.type == "cuda")


def offload_block_inputs():
    """A context in which every tensor saved for backward, outside an
    inner checkpoint's own hooks, is kept in host memory (pinned when it
    came from the card) and copied back at its first use in backward;
    an empty tensor stays where it is. Around a ``torch.utils.checkpoint``
    call that is the block input."""
    return torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)
