"""Tensor functions of ``paddle_tpu/tensor/``, all of them: every name of
its ``__init__.py`` import lists (``creation``, ``math``,
``manipulation``, ``logic``, ``search``, the root-level ``linalg``
aliases, ``random``, ``einsum`` and ``attribute``, with ``shape_fn``),
and the modules themselves (``stat`` and the whole of ``linalg`` among
them).  The root package re-exports them, as JAX's ``from .tensor import
*`` does.

They are functions of ``torch.Tensor``s: nothing is grafted onto
``torch.Tensor`` (JAX's ``_patch`` grafts every function and operator
onto its own ``Tensor``), so a tensor's methods and operators keep
torch's meaning (``ROADMAP.md`` Queue 3, a known difference)."""

from . import (attribute, creation, einsum as _einsum_module, linalg, logic,
               manipulation, math, random, search, stat)
from .attribute import is_complex, is_floating_point, is_integer, numel, rank
from .attribute import shape as shape_fn
from .creation import *  # noqa: F401,F403
from .einsum import einsum
from .linalg import (cdist, corrcoef, cov, det, inv, matrix_power,
                     matrix_rank, multi_dot, norm, pdist, pinv, slogdet)
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403

__all__ = sorted(
    set(creation.__all__) | set(math.__all__) | set(manipulation.__all__)
    | set(logic.__all__) | set(search.__all__) | set(random.__all__)
    | {"cdist", "corrcoef", "cov", "det", "einsum", "inv", "is_complex",
       "is_floating_point", "is_integer", "matrix_power", "matrix_rank",
       "multi_dot", "norm", "numel", "pdist", "pinv", "rank", "shape_fn",
       "slogdet", "manipulation"})
del _einsum_module
