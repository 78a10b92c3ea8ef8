"""``paddle.amp.debugging``, the counterpart of
``paddle_tpu/amp/debugging.py``: NaN/Inf checks.

``check_numerics`` counts the NaNs and Infs of one tensor (``[1]``
tensors on its device) and raises ``FloatingPointError`` under
``CHECK_NAN_INF_AND_ABORT``.  ``enable_tensor_checker`` turns on a real
check, as JAX's turns on ``jax_debug_nans``: a ``TorchDispatchMode``
that looks at every floating output of every operator torch dispatches
on this thread (but ``empty`` and its kin, whose memory is not written
yet) and, finding a NaN or an Inf, raises
``FloatingPointError`` naming the operator (under
``CHECK_NAN_INF_AND_ABORT``) or warns (the other modes).  Each check
reads one flag back from the device, so the mode synchronises once an
operator: a debug mode, not one to time.  The port's hand-written
kernels launch outside the dispatcher; the operators that read their
outputs check them.  ``set_flags({"FLAGS_check_nan_inf": True})`` turns
on the same check.  The operator-stats context managers do nothing, and
``compare_accuracy`` raises, as JAX's.
"""

from __future__ import annotations

import contextlib
import enum
import warnings

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class DebugMode(enum.Enum):
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL = 2


class TensorCheckerConfig:
    def __init__(self, enable, debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT,
                 output_dir=None, checked_op_list=None, skipped_op_list=None,
                 debug_step=None, stack_height_limit=1):
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir


def _counts(t):
    return int(torch.isnan(t).sum()), int(torch.isinf(t).sum())


#: operators whose output is uninitialized memory: not checked
_UNINITIALIZED = frozenset({"empty", "empty_like", "empty_strided",
                            "empty_permuted", "new_empty",
                            "new_empty_strided", "resize_"})


class _NanInfMode(TorchDispatchMode):
    """Checks every floating output of every operator but those that
    allocate without writing (``empty`` and its kin)."""

    def __init__(self, debug_mode):
        super().__init__()
        self.debug_mode = debug_mode

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in _UNINITIALIZED:
            return out
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_floating_point() \
                    and t.numel() and not bool(torch.isfinite(t).all()):
                n_nan, n_inf = _counts(t)
                msg = (f"tensor checker: {func} produced {n_nan} nan, "
                       f"{n_inf} inf in a {tuple(t.shape)} {t.dtype} "
                       "output")
                if self.debug_mode == DebugMode.CHECK_NAN_INF_AND_ABORT:
                    raise FloatingPointError(msg)
                warnings.warn(msg, RuntimeWarning, stacklevel=2)
        return out


_CONFIG = [None]
_MODE = [None]


def enable_tensor_checker(config: TensorCheckerConfig):
    """Store ``config`` and, if it is enabled, check every operator's
    floating outputs from here on (on this thread)."""
    disable_tensor_checker()
    _CONFIG[0] = config
    if config.enable:
        mode = _NanInfMode(config.debug_mode)
        mode.__enter__()
        _MODE[0] = mode


def disable_tensor_checker():
    _CONFIG[0] = None
    mode, _MODE[0] = _MODE[0], None
    if mode is not None:
        mode.__exit__(None, None, None)


def check_numerics(tensor, op_type="", var_name="",
                   debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT):
    """``(n_nan, n_inf)`` of ``tensor`` as int32 ``[1]`` tensors on its
    device; raises ``FloatingPointError`` if either is not 0 under
    ``CHECK_NAN_INF_AND_ABORT``."""
    t = torch.as_tensor(tensor)
    n_nan, n_inf = _counts(t) if t.is_floating_point() else (0, 0)
    if (n_nan or n_inf) and debug_mode == DebugMode.CHECK_NAN_INF_AND_ABORT:
        raise FloatingPointError(
            f"check_numerics: {op_type}/{var_name} has {n_nan} nan, "
            f"{n_inf} inf")
    return (torch.tensor([n_nan], dtype=torch.int32, device=t.device),
            torch.tensor([n_inf], dtype=torch.int32, device=t.device))


@contextlib.contextmanager
def collect_operator_stats():
    yield


def enable_operator_stats_collection():
    pass


def disable_operator_stats_collection():
    pass


def compare_accuracy(dump_path, another_dump_path, output_filename,
                     loss_scale=1, dump_all_tensors=False):
    raise NotImplementedError(
        "accuracy comparison dumps are not supported (nor in the JAX "
        "package)")
