"""``paddle.linalg``, the counterpart of ``paddle_tpu/linalg/__init__.py``:
the names of :mod:`paddle_tpu_torch.tensor.linalg`."""

from .tensor.linalg import *  # noqa: F401,F403
from .tensor.linalg import __all__  # noqa: F401
