from . import lr
from .lbfgs import LBFGS
from .optimizer import Optimizer
from .optimizers import (
    ASGD, SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb, Momentum,
    NAdam, RAdam, RMSProp, Rprop,
)

__all__ = ["Optimizer", "SGD", "Momentum", "Adagrad", "Adadelta", "RMSProp",
           "Adam", "AdamW", "Adamax", "Lamb", "Rprop", "ASGD", "NAdam",
           "RAdam", "LBFGS", "lr"]
