"""Optimizers, learning-rate schedulers and gradient clipping of the
port (``paddle_tpu.optimizer``)."""

from . import lr
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   GradClipBase)
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,
                        DecayedAdagrad, Dpsgd, Ftrl, Lamb, LarsMomentum,
                        Momentum, Optimizer, RMSProp, Rprop,
                        load_jax_optimizer_state)

__all__ = ["SGD", "Adadelta", "Adagrad", "Adam", "Adamax", "AdamW",
           "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "DecayedAdagrad", "Dpsgd", "Ftrl", "GradClipBase", "Lamb",
           "LarsMomentum", "Momentum", "Optimizer", "RMSProp", "Rprop",
           "load_jax_optimizer_state", "lr"]
