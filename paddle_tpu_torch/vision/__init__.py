"""``paddle_tpu_torch.vision``: the model zoo (``models``, whose
constructors and classes are also exported here, as JAX's ``from .models
import *``), the detection ops (``ops``), the datasets (``datasets``) and
the NumPy image transforms (``transforms``), the counterparts of
``paddle_tpu/vision``; with JAX's ``set_image_backend`` (ignored),
``get_image_backend`` (``"numpy"``) and ``image_load``."""

from . import datasets, models, ops, transforms
from .models import *  # noqa: F401,F403


def set_image_backend(backend):
    pass


def get_image_backend():
    return "numpy"


def image_load(path, backend=None):
    """An image file as JAX's ``image_load`` reads it: a ``.npy`` file
    through NumPy, anything else through PIL (raises without it)."""
    import numpy as np

    if str(path).endswith(".npy"):
        return np.load(path)
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            "image_load needs PIL for files other than .npy") from e
    return Image.open(path)


__all__ = ["datasets", "get_image_backend", "image_load", "models", "ops",
           "set_image_backend", "transforms"] + models.__all__
