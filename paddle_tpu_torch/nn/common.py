"""``Linear``, ``Embedding`` and ``Dropout``, the counterparts of
``paddle_tpu/nn/layer/common.py``.

``Linear`` keeps the port's ``[out, in]`` weight (torch's layout;
``convert`` transposes paddle's ``[in, out]`` at load).  Initial values
follow the JAX layers' defaults, drawn from the port's counter stream
(:mod:`paddle_tpu_torch.random`), one key a parameter: ``Linear`` weights
Xavier-normal, biases 0; ``Embedding`` N(0, 1) with the ``padding_idx``
row at 0.  Models that want other initial values (BERT's N(0, 0.02)
embeddings) draw them over these.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .. import random as _random
from . import functional as F


class Linear(nn.Module):
    def __init__(self, in_features, out_features, bias_attr=None,
                 device=None, dtype=None):
        """``bias_attr=False`` leaves out the bias, as paddle's."""
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               **kw))
        std = math.sqrt(2.0 / (in_features + out_features))
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=_random.next_generator(
                self.weight.device))
        self.bias = (None if bias_attr is False else
                     nn.Parameter(torch.zeros(out_features, **kw)))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 device=None, dtype=None):
        super().__init__()
        self._padding_idx = padding_idx
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=device, dtype=dtype))
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0, generator=_random.next_generator(
                self.weight.device))
            if padding_idx is not None:
                self.weight[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)


class Dropout(nn.Module):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train"):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"
