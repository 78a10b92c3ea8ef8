"""``auto_cast`` and ``decorate``, the counterparts of
``paddle_tpu/amp/auto_cast.py``.

The JAX package casts inside its op dispatcher: every op it names asks
``amp_dtype_for(op_name)`` and casts its real floating inputs to the
answer.  The port has no dispatcher, so each functional entry that the
JAX package names (``nn.functional``'s ``linear``, ``conv*``, pools,
norms, losses, activations and attention, ``tensor.matmul`` and
``flatten``, ``ops.flash_attention`` and ``ops.rms_norm``) calls
:func:`cast_inputs` with JAX's op name.  The cast is a differentiable
``Tensor.to``, so a gradient comes back in the input's dtype, as JAX's
pullback through its cast.  ``torch.autocast`` is not used: its op lists
are not JAX's.

O1 casts the white list to the scope's dtype and the black list to f32
and leaves every other op as it is; O2 casts every named op to the
scope's dtype but the black list.  The scope is per thread, as JAX's.
A float16 scope casts attention inputs to float16 too: the flash kernels
take them.
"""

from __future__ import annotations

import contextlib
import sys
import threading

import torch

# the JAX package's default O1 lists, keyed by its op names
WHITE_LIST = {
    "matmul", "linear", "conv1d", "conv2d", "conv3d", "conv1d_transpose",
    "conv2d_transpose", "conv3d_transpose", "einsum", "mm", "bmm", "mv",
    "flash_attention", "scaled_dot_product_attention",
}
BLACK_LIST = {
    "exp", "square", "log", "mean", "sum", "cos_sim", "softmax",
    "softmax_with_cross_entropy", "sigmoid_cross_entropy_with_logits",
    "cross_entropy", "layer_norm", "batch_norm", "group_norm", "instance_norm",
    "rms_norm", "logsumexp", "erf", "erfinv", "pow", "log_softmax",
    "sync_batch_norm", "norm", "var", "std",
}
_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
           "float32": torch.float32}


def to_torch_dtype(dtype):
    """``"float16"``, ``"bfloat16"``, ``"float32"`` or a torch dtype."""
    return _DTYPES[dtype] if isinstance(dtype, str) else dtype


def white_list():
    return {"float16": {"O1": WHITE_LIST, "O2": WHITE_LIST},
            "bfloat16": {"O1": WHITE_LIST, "O2": WHITE_LIST}}


def black_list():
    return {"float16": {"O1": BLACK_LIST, "O2": BLACK_LIST},
            "bfloat16": {"O1": BLACK_LIST, "O2": BLACK_LIST}}


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.custom_white = set()
        self.custom_black = set()


_STATE = _AmpState()


def amp_state():
    return _STATE


def amp_dtype_for(op_name):
    """The dtype op ``op_name`` computes in under this thread's scope, or
    None to leave its inputs as they are (``auto_cast.py:59-75``)."""
    if not _STATE.enabled or not op_name:
        return None
    if op_name in _STATE.custom_black or op_name in BLACK_LIST:
        return torch.float32
    if _STATE.level == "O2":
        return _STATE.dtype
    if op_name in _STATE.custom_white or op_name in WHITE_LIST:
        return _STATE.dtype
    return None


#: set by ``static.enable_static``: names the nodes the calling functional
#: records (``static/graph.py``), the one place where an op names itself
_static_namer = None


def cast_inputs(op_name, *tensors):
    """``tensors`` with each real floating tensor cast to
    :func:`amp_dtype_for` ``(op_name)``; the others (None, integer
    labels) pass through.  Returns a tuple.  In static mode the calling
    functional's recorded nodes take ``op_name``."""
    if _static_namer is not None:
        _static_namer(op_name, sys._getframe(1))
    dt = amp_dtype_for(op_name)
    if dt is None:
        return tensors
    return tuple(t.to(dt) if isinstance(t, torch.Tensor)
                 and t.is_floating_point() and t.dtype != dt else t
                 for t in tensors)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """Cast the named ops inside the block by the O1 or O2 rule; custom
    lists add to the default ones.  The previous scope comes back on
    exit."""
    prev = (_STATE.enabled, _STATE.dtype, _STATE.level, _STATE.custom_white,
            _STATE.custom_black)
    _STATE.enabled = enable
    _STATE.dtype = to_torch_dtype(dtype)
    _STATE.level = level
    _STATE.custom_white = set(custom_white_list or ())
    _STATE.custom_black = set(custom_black_list or ())
    try:
        yield
    finally:
        (_STATE.enabled, _STATE.dtype, _STATE.level, _STATE.custom_white,
         _STATE.custom_black) = prev


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast the models' floating parameters and buffers to ``dtype``;
    the optimizers keep f32 master weights where they have them
    (``multi_precision``).  Returns the models, or ``(models,
    optimizers)`` when optimizers are given, each as passed (one or a
    list)."""
    dt = to_torch_dtype(dtype)
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        for m in model_list:
            m.to(dtype=dt)
    opt_single = optimizers is not None and not isinstance(
        optimizers, (list, tuple))
    opt_list = ([] if optimizers is None else
                [optimizers] if opt_single else list(optimizers))
    for o in opt_list:
        if hasattr(o, "_multi_precision"):
            o._multi_precision = True
    if optimizers is None:
        return models
    return ((model_list[0] if single else model_list),
            (opt_list[0] if opt_single else opt_list))


def is_bf16_supported():
    return True


def is_float16_supported():
    return True
