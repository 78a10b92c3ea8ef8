"""The statistics namespace of ``paddle_tpu/tensor/stat.py``: re-exports
of :mod:`.math`, :mod:`.search` and :mod:`.attribute`."""

from .attribute import numel
from .math import mean, nanmean, nansum, std, var
from .search import median, nanmedian, quantile

__all__ = ["mean", "median", "nanmean", "nanmedian", "nansum", "numel",
           "quantile", "std", "var"]
