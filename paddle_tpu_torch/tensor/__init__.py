"""Tensor functions of ``paddle_tpu/tensor/``: all of
``manipulation.py`` (:mod:`.manipulation`) and ``matmul`` of
``math.py`` (:mod:`.math`); the rest of the tensor surface (``math``,
``creation``, ``linalg``, ``search``, ``logic``, ``random``, ``stat``,
``einsum``, ``attribute``) is not ported yet (ROADMAP.md Queue 1)."""

from . import manipulation
from .manipulation import *  # noqa: F401,F403
from .manipulation import __all__ as _manipulation_all
from .math import matmul

__all__ = sorted(_manipulation_all + ["manipulation", "matmul"])
