"""``paddle_tpu_torch.hapi``: ``Model``, its ``callbacks``, ``summary``
and ``flops``, the counterparts of ``paddle_tpu/hapi``."""

from . import callbacks
from .dynamic_flops import flops
from .model import Model
from .model_summary import summary

__all__ = ["Model", "callbacks", "flops", "summary"]
