"""``paddle_tpu_torch.vision``: the ResNet family (``models``), the
datasets (``datasets``) and the NumPy image transforms
(``transforms``), the counterparts of ``paddle_tpu/vision`` (``ops``
and the rest of the model zoo are not ported yet)."""

from . import datasets, models, transforms

__all__ = ["datasets", "models", "transforms"]
