"""Loss layers, the counterparts of ``paddle_tpu/nn/layer/loss.py``: the
twenty layers with JAX's arguments, each calling its functional in
:mod:`paddle_tpu_torch.nn.functional`.  ``HSigmoidLoss`` holds the tree's
``weight`` ``[num_classes - 1, feature_size]`` (Xavier-uniform, from the
port's counter stream) and ``bias`` (zeros)."""

from __future__ import annotations

import math

import torch
from torch import nn

from .. import random as _random
from ..device import resolve_device
from . import functional as F
from .layers import Layer


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0):
        super().__init__()
        self._weight = weight
        self._kw = dict(ignore_index=ignore_index, reduction=reduction,
                        soft_label=soft_label, axis=axis,
                        use_softmax=use_softmax,
                        label_smoothing=label_smoothing)

    def forward(self, input, label):
        return F.cross_entropy(input, label, weight=self._weight, **self._kw)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self._reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, self._reduction)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean"):
        super().__init__()
        self._weight = weight
        self._ignore_index = ignore_index
        self._reduction = reduction

    def forward(self, input, label):
        return F.nll_loss(input, label, self._weight, self._ignore_index,
                          self._reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean"):
        super().__init__()
        self._weight = weight
        self._reduction = reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, self._weight,
                                      self._reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None):
        super().__init__()
        self._weight = weight
        self._reduction = reduction
        self._pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, self._weight, self._reduction, self._pos_weight)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0):
        super().__init__()
        self._reduction = reduction
        self._delta = delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, self._reduction, self._delta)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean", log_target=False):
        super().__init__()
        self._reduction = reduction
        self._log_target = log_target

    def forward(self, input, label):
        return F.kl_div(input, label, self._reduction, self._log_target)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean"):
        super().__init__()
        self._margin = margin
        self._reduction = reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, self._margin,
                                     self._reduction)


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean"):
        super().__init__()
        self._margin = margin
        self._reduction = reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, self._margin,
                                       self._reduction)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction="mean"):
        super().__init__()
        self._margin = margin
        self._reduction = reduction

    def forward(self, input, label):
        return F.hinge_embedding_loss(input, label, self._margin,
                                      self._reduction)


class TripletMarginLoss(Layer):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean"):
        super().__init__()
        self._kw = dict(margin=margin, p=p, epsilon=epsilon, swap=swap,
                        reduction=reduction)

    def forward(self, input, positive, negative):
        return F.triplet_margin_loss(input, positive, negative, **self._kw)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self._blank = blank
        self._reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self._blank, self._reduction, norm_by_times)


class GaussianNLLLoss(Layer):
    def __init__(self, full=False, epsilon=1e-6, reduction="mean"):
        super().__init__()
        self._kw = dict(full=full, epsilon=epsilon, reduction=reduction)

    def forward(self, input, label, variance):
        return F.gaussian_nll_loss(input, label, variance, **self._kw)


class PoissonNLLLoss(Layer):
    def __init__(self, log_input=True, full=False, epsilon=1e-8,
                 reduction="mean"):
        super().__init__()
        self._kw = dict(log_input=log_input, full=full, epsilon=epsilon,
                        reduction=reduction)

    def forward(self, input, label):
        return F.poisson_nll_loss(input, label, **self._kw)


class SoftMarginLoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.soft_margin_loss(input, label, self._reduction)


class MultiLabelSoftMarginLoss(Layer):
    def __init__(self, weight=None, reduction="mean"):
        super().__init__()
        self._weight = weight
        self._reduction = reduction

    def forward(self, input, label):
        return F.multi_label_soft_margin_loss(input, label, self._weight,
                                              self._reduction)


class MultiMarginLoss(Layer):
    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean"):
        super().__init__()
        self._kw = dict(p=p, margin=margin, weight=weight, reduction=reduction)

    def forward(self, input, label):
        return F.multi_margin_loss(input, label, **self._kw)


class TripletMarginWithDistanceLoss(Layer):
    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean"):
        super().__init__()
        self._kw = dict(distance_function=distance_function, margin=margin,
                        swap=swap, reduction=reduction)

    def forward(self, input, positive, negative):
        return F.triplet_margin_with_distance_loss(input, positive, negative,
                                                   **self._kw)


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid classifier head (the default
    complete-binary-tree coding)."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 device=None, dtype=None):
        super().__init__()
        if is_custom:
            raise NotImplementedError("custom-tree HSigmoidLoss")
        self._num_classes = num_classes
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.weight = nn.Parameter(torch.empty(num_classes - 1, feature_size,
                                               **kw))
        bound = math.sqrt(6.0 / (num_classes - 1 + feature_size))
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=(
                _random.next_generator(self.weight.device)))
        self.bias = (None if bias_attr is False else
                     nn.Parameter(torch.zeros(num_classes - 1, **kw)))

    def forward(self, input, label):
        return F.hsigmoid_loss(input, label, self._num_classes, self.weight,
                               self.bias)
