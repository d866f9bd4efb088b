"""Optimizers, learning-rate schedulers, gradient clipping, the EMA /
ModelAverage / Lookahead wrappers and DGC momentum of the port
(``paddle_tpu.optimizer``)."""

from . import lr
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   GradClipBase)
from .dgc import DGCMomentum
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,
                        DecayedAdagrad, Dpsgd, Ftrl, Lamb, LarsMomentum,
                        Momentum, Optimizer, RMSProp, Rprop,
                        load_jax_optimizer_state)
from .wrappers import ExponentialMovingAverage, Lookahead, ModelAverage

__all__ = ["SGD", "Adadelta", "Adagrad", "Adam", "Adamax", "AdamW",
           "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "DGCMomentum", "DecayedAdagrad", "Dpsgd",
           "ExponentialMovingAverage", "Ftrl", "GradClipBase", "Lamb",
           "LarsMomentum", "Lookahead", "ModelAverage", "Momentum",
           "Optimizer", "RMSProp", "Rprop", "load_jax_optimizer_state",
           "lr"]
