"""``paddle_tpu_torch.framework``: ``save`` and ``load`` (``io``), the
counterparts of ``paddle_tpu/framework/io.py``."""

from .io import load, save

__all__ = ["load", "save"]
