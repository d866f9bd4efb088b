"""Streaming metrics (port of ``paddle_tpu/metric/__init__.py``; the
reference's ``python/paddle/metric/metrics.py``): ``Metric``,
``Accuracy``, ``Precision``, ``Recall``, ``Auc`` and the functional
``accuracy``.

The classes keep their state in numpy on the host, as the JAX package's
do, so ``Accuracy``'s ``np.argsort(-pred)`` breaks ties as there. The
functional ``accuracy`` runs on the tensors' device and breaks ties as
``lax.top_k`` does, the lower index first, through a stable descending
sort: ``torch.topk`` does not promise an order among equal values, and
int8 logits tie often.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Metric:
    def __init__(self):
        self._name = type(self).__name__.lower()

    def name(self):
        return self._name

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def compute(self, pred, label, *args):
        """Optional pre-processing on device; default passthrough."""
        return pred, label


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label, *args):
        pred_np = _np(pred)
        label_np = _np(label)
        idx = np.argsort(-pred_np, axis=-1)[..., :self.maxk]
        if label_np.ndim == pred_np.ndim:
            label_np = label_np.argmax(-1)
        correct = (idx == label_np[..., None])
        return correct

    def update(self, correct, *args):
        correct = _np(correct)
        num = correct.shape[0] if correct.ndim else 1
        for i, k in enumerate(self.topk):
            self.total[i] += correct[..., :k].sum()
            self.count[i] += num
        accs = self.total / np.maximum(self.count, 1)
        return accs[0] if len(self.topk) == 1 else accs

    def accumulate(self):
        accs = self.total / np.maximum(self.count, 1)
        return accs[0] if len(self.topk) == 1 else list(accs)

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name=None):
        super().__init__()
        self._name = name or "precision"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int32).ravel()
        l = _np(labels).astype(np.int32).ravel()
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fp += int(((p == 1) & (l == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0


class Recall(Metric):
    def __init__(self, name=None):
        super().__init__()
        self._name = name or "recall"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int32).ravel()
        l = _np(labels).astype(np.int32).ravel()
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fn += int(((p == 0) & (l == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        super().__init__()
        self._name = name or "auc"
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        preds = _np(preds)
        labels = _np(labels).ravel()
        if preds.ndim == 2 and preds.shape[1] == 2:
            scores = preds[:, 1]
        else:
            scores = preds.ravel()
        bins = np.clip((scores * self.num_thresholds).astype(np.int64), 0,
                       self.num_thresholds)
        for b, l in zip(bins, labels):
            if l:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if not tot_pos or not tot_neg:
            return 0.0
        # trapezoid over thresholds descending
        area = 0.0
        pos = neg = 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = pos + self._stat_pos[i]
            new_neg = neg + self._stat_neg[i]
            area += (new_neg - neg) * (pos + new_pos) / 2.0
            pos, neg = new_pos, new_neg
        return area / (tot_pos * tot_neg)


def accuracy(input, label, k=1, correct=None, total=None):  # noqa: A002
    """Functional accuracy (``paddle.metric.accuracy``): the share of
    rows whose label is among the ``k`` largest scores, a float32 0-d
    tensor. ``correct`` / ``total`` tensors, where given, are filled in
    place with the hits and the rows (the reference accuracy_op's
    outputs)."""
    idx = torch.sort(input, dim=-1, descending=True, stable=True)[1][..., :k]
    lbl = label if label.dim() > 1 else label[:, None]
    hit = (idx == lbl).any(dim=-1)
    if correct is not None:
        correct.copy_(hit.to(torch.int64).sum())
    if total is not None:
        total.copy_(torch.tensor(hit.numel()))
    return hit.to(torch.float32).mean()
