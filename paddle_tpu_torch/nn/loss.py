"""The loss layers (port of ``paddle_tpu/nn/loss.py``): each keeps the
JAX layer's constructor and calls its functional of
``ops/nn_functional.py`` or ``ops/loss_extra.py``. ``HSigmoidLoss`` owns
its parameters (``weight [nodes, feature_size]`` drawn by
``create_parameter``'s default, ``xavier_uniform``, and zero biases);
it takes ``device`` (``None`` means CUDA) and ``generator``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..ops import loss_extra as LE
from ..ops import nn_functional as NF
from .initializer import create_parameter
from .layer import Layer


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):  # noqa: A002
        return NF.cross_entropy(
            input, label, weight=self.weight, ignore_index=self.ignore_index,
            reduction=self.reduction, soft_label=self.soft_label,
            axis=self.axis, use_softmax=self.use_softmax,
            label_smoothing=self.label_smoothing)


class _Reduced(Layer):
    """A loss whose only option is ``reduction``."""

    _fn = None

    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return type(self)._fn(input, label, self.reduction)


class MSELoss(_Reduced):
    _fn = staticmethod(NF.mse_loss)


class L1Loss(_Reduced):
    _fn = staticmethod(NF.l1_loss)


class KLDivLoss(_Reduced):
    _fn = staticmethod(NF.kl_div)


class SoftMarginLoss(_Reduced):
    _fn = staticmethod(NF.soft_margin_loss)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction = reduction
        self.delta = delta

    def forward(self, input, label):  # noqa: A002
        return NF.smooth_l1_loss(input, label, self.reduction, self.delta)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return NF.nll_loss(input, label, self.weight, self.ignore_index,
                           self.reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return NF.binary_cross_entropy(input, label, self.weight,
                                       self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return NF.binary_cross_entropy_with_logits(
            logit, label, self.weight, self.reduction, self.pos_weight)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, other, label):  # noqa: A002
        return NF.margin_ranking_loss(input, other, label, self.margin,
                                      self.reduction)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return NF.hinge_embedding_loss(input, label, self.margin,
                                       self.reduction)


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input1, input2, label):
        return NF.cosine_embedding_loss(input1, input2, label, self.margin,
                                        self.reduction)


class TripletMarginLoss(Layer):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.margin, self.p, self.epsilon = margin, p, epsilon
        self.swap, self.reduction = swap, reduction

    def forward(self, anchor, positive, negative):
        return NF.triplet_margin_loss(anchor, positive, negative,
                                      self.margin, self.p, self.epsilon,
                                      self.swap, self.reduction)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return LE.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                           blank=self.blank, reduction=self.reduction,
                           norm_by_times=norm_by_times)


class HSigmoidLoss(Layer):
    """The default tree touches internal nodes ``0 .. num_classes - 2``
    (weight ``[num_classes - 1, D]``); a custom tree indexes up to
    ``num_classes`` rows."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        self.is_custom = is_custom
        n_nodes = num_classes if is_custom else num_classes - 1
        kw = dict(device=resolve_device(device), dtype=dtype,
                  generator=generator)
        self.weight = create_parameter((n_nodes, feature_size),
                                       attr=weight_attr, **kw)
        self.bias = None if bias_attr is False else create_parameter(
            (n_nodes,), attr=bias_attr, is_bias=True, **kw)

    def forward(self, input, label, path_table=None,  # noqa: A002
                path_code=None):
        return LE.hsigmoid_loss(input, label, self.weight, self.bias,
                                num_classes=self.num_classes,
                                path_table=path_table, path_code=path_code)


class MultiLabelSoftMarginLoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return NF.multi_label_soft_margin_loss(
            input, label, weight=self.weight, reduction=self.reduction)


class PoissonNLLLoss(Layer):
    def __init__(self, log_input=True, full=False, epsilon=1e-8,
                 reduction="mean", name=None):
        super().__init__()
        self._args = (log_input, full, epsilon, reduction)

    def forward(self, input, label):  # noqa: A002
        li, fu, ep, red = self._args
        return NF.poisson_nll_loss(input, label, log_input=li, full=fu,
                                   epsilon=ep, reduction=red)


class GaussianNLLLoss(Layer):
    def __init__(self, full=False, epsilon=1e-6, reduction="mean",
                 name=None):
        super().__init__()
        self._args = (full, epsilon, reduction)

    def forward(self, input, label, variance):  # noqa: A002
        fu, ep, red = self._args
        return NF.gaussian_nll_loss(input, label, variance, full=fu,
                                    epsilon=ep, reduction=red)
