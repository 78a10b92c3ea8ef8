"""``paddle.regularizer``, the counterpart of ``paddle_tpu/regularizer.py``:
``L1Decay`` and ``L2Decay``, each the gradient of its penalty,
``coeff * sign(p)`` and ``coeff * p``.  Attached through ``ParamAttr``
they add that term to the parameter's gradient before the update
(replacing the optimizer's ``weight_decay`` for it); as an optimizer's
``weight_decay``, ``L2Decay`` is the coupled float path (its ``coeff``)
and ``L1Decay`` the gradient term, as JAX's ``Optimizer`` maps them."""

from __future__ import annotations

import torch


class WeightDecayRegularizer:
    def __call__(self, param):
        """The penalty's gradient at ``param``."""
        raise NotImplementedError


class L1Decay(WeightDecayRegularizer):
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __call__(self, param):
        return self.coeff * torch.sign(param)

    def __repr__(self):
        return f"L1Decay(coeff={self.coeff})"


class L2Decay(WeightDecayRegularizer):
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __call__(self, param):
        return self.coeff * param

    def __repr__(self):
        return f"L2Decay(coeff={self.coeff})"


__all__ = ["WeightDecayRegularizer", "L1Decay", "L2Decay"]
