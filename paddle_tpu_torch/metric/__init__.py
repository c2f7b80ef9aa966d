"""Metrics (port of ``paddle_tpu/metric/__init__.py``).

The metric classes count on the host, in numpy, from the outputs'
values, as the JAX package does; ``accuracy`` is a Tensor function over
``topk`` (whose indices are int64 here and int32 in the JAX package: the
results are equal).
"""
from __future__ import annotations

import numpy as np

from paddle_tpu_torch.core.tensor import Tensor

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x) -> np.ndarray:
    return np.asarray(x.numpy() if isinstance(x, Tensor) else x)


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self.__class__.__name__.lower()

    def compute(self, *args):
        return args


class Accuracy(Metric):
    """Top-k accuracy for each k of ``topk``. ``compute`` gives the
    (..., max k) correct matrix; ``update`` counts every sample of its
    leading dims (a (B, S, k) matrix counts B*S samples)."""

    def __init__(self, topk=(1,), name=None):
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label):
        pred_np, label_np = _np(pred), _np(label)
        if label_np.ndim == pred_np.ndim:
            label_np = label_np.squeeze(-1)
        topk_idx = np.argsort(-pred_np, axis=-1)[..., :max(self.topk)]
        return topk_idx == label_np[..., None]

    def update(self, correct):
        correct = _np(correct)
        n = int(np.prod(correct.shape[:-1]))
        for i, k in enumerate(self.topk):
            self.total[i] += float(correct[..., :k].any(axis=-1).sum())
            self.count[i] += n
        return self.accumulate()

    def accumulate(self):
        accs = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return accs[0] if len(accs) == 1 else accs

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


def _binary(preds, labels):
    """Predicted classes (probability > 0.5) and labels, flattened."""
    pred_cls = (_np(preds) > 0.5).astype(np.int64).reshape(-1)
    return pred_cls, _np(labels).reshape(-1)


class Precision(Metric):
    def __init__(self, name=None):
        self._name = name or "precision"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        pred_cls, labels = _binary(preds, labels)
        self.tp += int(((pred_cls == 1) & (labels == 1)).sum())
        self.fp += int(((pred_cls == 1) & (labels == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name=None):
        self._name = name or "recall"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        pred_cls, labels = _binary(preds, labels)
        self.tp += int(((pred_cls == 1) & (labels == 1)).sum())
        self.fn += int(((pred_cls == 0) & (labels == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC from ``num_thresholds`` buckets of the positive class's
    probability (column 1 of a 2-column prediction)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        self._name = name or "auc"
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        preds, labels = _np(preds), _np(labels)
        if preds.ndim == 2:
            preds = preds[:, 1]
        labels = labels.reshape(-1)
        idx = np.clip((preds * self.num_thresholds).astype(np.int64), 0,
                      self.num_thresholds)
        for i, lbl in zip(idx, labels):
            if lbl:
                self._stat_pos[i] += 1
            else:
                self._stat_neg[i] += 1

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # the trapezoid rule over the thresholds, descending
        tpr = np.cumsum(self._stat_pos[::-1]) / tot_pos
        fpr = np.cumsum(self._stat_neg[::-1]) / tot_neg
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        return float(trapezoid(tpr, fpr))

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None):
    """The share of rows whose label is among the top ``k`` of
    ``input``, as a 0-dim f32 Tensor."""
    from paddle_tpu_torch import ops

    _, topk_idx = ops.topk(input, k)
    lbl = label
    if lbl.ndim < topk_idx.ndim:
        lbl = ops.unsqueeze(lbl, -1)
    correct_t = ops.any(ops.equal(topk_idx, lbl), axis=-1)
    return ops.mean(ops.cast(correct_t, "float32"))
