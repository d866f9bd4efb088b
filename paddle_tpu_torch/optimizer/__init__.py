"""Optimizers and gradient clipping of the port (``paddle_tpu.optimizer``)."""

from .clip import ClipGradByGlobalNorm, GradClipBase
from .optimizer import Adam, AdamW, Optimizer, load_jax_optimizer_state

__all__ = ["Adam", "AdamW", "ClipGradByGlobalNorm", "GradClipBase",
           "Optimizer", "load_jax_optimizer_state"]
