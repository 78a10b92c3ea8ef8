"""``paddle.nn.initializer``, the counterpart of
``paddle_tpu/nn/initializer/__init__.py``: the eleven initializers and
their base, ``calculate_gain``, ``set_global_initializer`` and
``LazyGuard``.

``set_global_initializer`` stores its choice, and nothing reads it: the
JAX package's ``create_parameter`` never looks at it
(``paddle_tpu/nn/layer/layers.py:114-142``), and the port follows it
(``ROADMAP.md``, reference caveats)."""

from .initializer import (
    Assign, Constant, Dirac, Initializer, KaimingNormal, KaimingUniform,
    Normal, Orthogonal, TruncatedNormal, Uniform, XavierNormal,
    XavierUniform, calculate_gain,
)
from .lazy_init import LazyGuard

_GLOBAL_INIT = [None, None]


def set_global_initializer(weight_init, bias_init=None):
    _GLOBAL_INIT[0] = weight_init
    _GLOBAL_INIT[1] = bias_init


__all__ = ["Assign", "Constant", "Dirac", "Initializer", "KaimingNormal",
           "KaimingUniform", "LazyGuard", "Normal", "Orthogonal",
           "TruncatedNormal", "Uniform", "XavierNormal", "XavierUniform",
           "calculate_gain", "set_global_initializer"]
