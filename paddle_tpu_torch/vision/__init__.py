"""``paddle_tpu_torch.vision``: the model zoo (``models``), the detection
ops (``ops``), the datasets (``datasets``) and the NumPy image
transforms (``transforms``), the counterparts of ``paddle_tpu/vision``."""

from . import datasets, models, ops, transforms

__all__ = ["datasets", "models", "ops", "transforms"]
