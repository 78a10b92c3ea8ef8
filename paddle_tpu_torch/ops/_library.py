"""The hand-written kernels as ``torch.library`` custom ops.

Each kernel wrapper that a captured (``torch.compile``) or exported
(``torch.export``) program can reach is an operator of the
``paddle_tpu_torch`` namespace, so that a graph holds it as one node and
a compiled program calls it: the CUDA kernel for CUDA tensors (which
raises on what it does not take, and never gives way to the plain
version), the plain twin for CPU tensors, a raise for any other device.
Each op has a fake implementation (the outputs' shapes and dtypes), and
the forward ops carry their backward through the backward ops, so that
AOTAutograd and ``torch.export`` keep the hand-written backward.

The launch counters live in Python (each wrapper adds one where it
launches): a compiled program calls the op's Python implementation on
every call, so they count there too.  A replayed CUDA graph calls no
Python; ``jit.TrainStep.many`` adds the launches it captured once for
each replay.
"""

from __future__ import annotations

import torch

NAMESPACE = "paddle_tpu_torch"


def define(name, schema, impl, fake):
    """``impl`` as the custom op ``paddle_tpu_torch::<name>`` with the
    given schema (the arguments and returns of the C++ signature) and
    fake implementation."""
    op = torch.library.custom_op(f"{NAMESPACE}::{name}", impl,
                                 mutates_args=(), schema=schema)

    def fake_or_raise(*args):
        # a meta tensor is a device as any other, and the implementation
        # raises on it (the fake implementation also serves the Meta
        # key; a capture's fake tensors report their own device)
        if any(isinstance(a, torch.Tensor) and a.device.type == "meta"
               for a in args):
            return impl(*args)
        return fake(*args)

    op.register_fake(fake_or_raise)
    return op


def first_order(name):
    """Raise where a backward is asked for a derivative of its own (a
    second order: the kernels' backwards have none)."""
    if torch.is_grad_enabled():
        raise RuntimeError(f"{name}: the kernel's backward has no "
                           "derivative of its own (first order only)")


def ops():
    """Every custom op of the port, by name (the ops of the modules
    imported so far; ``paddle_tpu_torch.ops`` imports them all)."""
    return {name: getattr(getattr(torch.ops, NAMESPACE), name)
            for name in OP_NAMES}


#: the registered ops, in the order of ``ops/__init__``'s modules
OP_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "layer_norm_fwd",
            "layer_norm_bwd", "group_norm_fwd", "group_norm_bwd",
            "rms_norm_fwd", "rms_norm_bwd")
