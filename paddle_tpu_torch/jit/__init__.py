from .api import (
    InputSpec, StaticFunction, TranslatedLayer, enable_to_static,
    ignore_module, load, not_to_static, save, to_static,
)
from .train_step import TrainStep

__all__ = ["to_static", "not_to_static", "save", "load", "InputSpec",
           "StaticFunction", "TranslatedLayer", "enable_to_static",
           "ignore_module", "TrainStep"]
