"""Metrics, the counterparts of ``paddle_tpu/metric/__init__.py``:
``Metric``, ``Accuracy`` (top-k), ``Precision`` and ``Recall``.

``Accuracy.compute`` ranks on the tensors' device and returns the
``[..., maxk]`` f32 hits; equal scores rank the lower index first
(:func:`paddle_tpu_torch.tensor.topk`, ``lax.top_k``'s rule), on the
card as on the CPU.  ``update`` adds them to host counts, one read of
the device a call, as JAX's numpy path reads its arrays."""

from __future__ import annotations

import math

import torch

from .tensor.search import topk


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        """``[..., maxk]`` f32: 1 where the label is the prediction's
        i-th largest score.  A label of the prediction's rank (a
        trailing dim of 1) is squeezed."""
        pred, label = torch.as_tensor(pred), torch.as_tensor(label)
        if label.dim() == pred.dim():
            label = label.squeeze(-1)
        order = topk(pred, self.maxk)[1]
        return (order == label.to(order.device)[..., None]).to(torch.float32)

    def update(self, correct, *args):
        """Add a batch's hits; returns its accuracy (a list with several
        ``topk``)."""
        c = torch.as_tensor(correct)
        rows = math.prod(c.shape[:-1])
        hits = torch.stack([c[..., :k].sum() for k in self.topk]).tolist()
        accs = []
        for i, num in enumerate(hits):
            self.total[i] += float(num)
            self.count[i] += rows
            accs.append(float(num) / max(rows, 1))
        return accs[0] if len(accs) == 1 else accs

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """Binary precision of scores above 0.5 against 0/1 labels."""

    def __init__(self, name="precision"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        pos = torch.as_tensor(preds).reshape(-1) > 0.5
        lbl = torch.as_tensor(labels).reshape(-1).to(pos.device)
        self.tp += int((pos & (lbl == 1)).sum())
        self.fp += int((pos & (lbl == 0)).sum())

    def accumulate(self):
        return self.tp / max(self.tp + self.fp, 1)

    def name(self):
        return self._name


class Recall(Metric):
    """Binary recall of scores above 0.5 against 0/1 labels."""

    def __init__(self, name="recall"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        pos = torch.as_tensor(preds).reshape(-1) > 0.5
        lbl = torch.as_tensor(labels).reshape(-1).to(pos.device)
        self.tp += int((pos & (lbl == 1)).sum())
        self.fn += int((~pos & (lbl == 1)).sum())

    def accumulate(self):
        return self.tp / max(self.tp + self.fn, 1)

    def name(self):
        return self._name
