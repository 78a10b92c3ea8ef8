"""``paddle.autograd``, the counterpart of ``paddle_tpu/autograd/__init__.py``:
``backward``, the custom op ``PyLayer``, and the functional transforms
``jacobian``, ``hessian``, ``jvp`` and ``vjp``.

``PyLayer`` is a ``torch.autograd.Function`` under Paddle's contract: the
user's ``forward(ctx, *args)`` runs without recording, and
``backward(ctx, *grads)`` returns one gradient per Tensor input in
forward order; inputs that stop the gradient get none, and non-Tensor
arguments pass through.  torch's autograd calls that backward wherever
the op is differentiated: eagerly, and under ``distributed.recompute``
(``torch.utils.checkpoint`` re-runs the forward and keeps the custom
backward), which is what JAX's ``_apply_staged`` exists for.

The transforms take reverse mode, first order, through
``torch.autograd.functional`` (``vectorize`` off): ``jacobian`` and
``vjp`` run each output's backward once, so they go through the port's
kernels (whose backward is a kernel of its own); ``jvp`` is the
jacobian contracted with the tangent, for the same reason.  ``hessian``
differentiates a backward, which the kernels' backwards do not allow:
through a port kernel it raises, as JAX's ``hessian`` raises through a
Pallas kernel's ``custom_vjp``.  The outputs keep JAX's structure: a
tensor for one input, tuples over several inputs and over several
outputs, and ``v=None`` as ones.
"""

from __future__ import annotations

import torch
from torch.autograd import functional as _F

from ..core import (enable_grad, grad, is_grad_enabled, no_grad,  # noqa: F401
                    set_grad_enabled)

__all__ = ["PyLayer", "PyLayerContext", "backward", "enable_grad", "grad",
           "hessian", "is_grad_enabled", "is_pylayer_op", "jacobian", "jvp",
           "no_grad", "set_grad_enabled", "vjp"]


def backward(tensors, grad_tensors=None, retain_graph=False):
    """Accumulate the gradients of ``tensors`` (one or a list), seeded by
    ``grad_tensors`` (None: ones for a scalar), into the leaves'
    ``.grad``."""
    if isinstance(tensors, torch.Tensor):
        tensors = [tensors]
    if isinstance(grad_tensors, torch.Tensor):
        grad_tensors = [grad_tensors]
    torch.autograd.backward(list(tensors), grad_tensors,
                            retain_graph=retain_graph)


class PyLayerContext:
    """The ``ctx`` of a :class:`PyLayer`: ``save_for_backward`` /
    ``saved_tensor()``, ``mark_not_inplace`` and
    ``set_materialize_grads``.  Saved tensors go through torch's
    ``save_for_backward`` (so recompute can drop and rebuild them), other
    values are kept as they are."""

    def __init__(self, fn_ctx):
        self._fn_ctx = fn_ctx
        self._saved = []
        self.not_inplace_tensors = ()

    def save_for_backward(self, *tensors):
        is_t = [isinstance(t, torch.Tensor) for t in tensors]
        self._fn_ctx.save_for_backward(
            *[t for t, k in zip(tensors, is_t) if k])
        self._saved = [None if k else t for t, k in zip(tensors, is_t)]
        self._is_t = is_t

    def saved_tensor(self):
        if not self._saved:
            return []
        it = iter(self._fn_ctx.saved_tensors)
        return [next(it) if k else v for v, k in zip(self._saved, self._is_t)]

    saved_tensors = property(saved_tensor)

    def mark_not_inplace(self, *args):
        self.not_inplace_tensors = args

    def set_materialize_grads(self, value):
        self._fn_ctx.set_materialize_grads(value)


class _PyLayerFunction(torch.autograd.Function):
    @staticmethod
    def forward(fn_ctx, layer, kwargs, *args):
        ctx = PyLayerContext(fn_ctx)
        fn_ctx.pylayer = (layer, ctx, [isinstance(a, torch.Tensor)
                                       for a in args])
        return layer.forward(ctx, *args, **kwargs)

    @staticmethod
    def backward(fn_ctx, *grads):
        layer, ctx, is_t = fn_ctx.pylayer
        out = layer.backward(ctx, *grads)
        if not isinstance(out, (tuple, list)):
            out = (out,)
        # Paddle's contract: one gradient per Tensor input, in order
        it = iter(out)
        return (None, None) + tuple(next(it, None) if k else None
                                    for k in is_t)


class PyLayer:
    """A custom op (Paddle's ``paddle.autograd.PyLayer``)::

        class Cube(PyLayer):
            @staticmethod
            def forward(ctx, x):
                ctx.save_for_backward(x)
                return x ** 3

            @staticmethod
            def backward(ctx, dy):
                (x,) = ctx.saved_tensor()
                return dy * 3 * x ** 2

        y = Cube.apply(x)

    Keyword tensors are passed through without a gradient, as JAX's."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        return _PyLayerFunction.apply(cls, kwargs, *args)


def is_pylayer_op(x):
    return isinstance(x, PyLayer)


# ------------------------------------------------------ functional autograd

def _inputs(xs):
    """(single, tuple of detached tensors) of one tensor or a list."""
    single = isinstance(xs, torch.Tensor)
    return single, tuple(torch.as_tensor(x).detach()
                         for x in ((xs,) if single else xs))


def _fn(func, single, outs=None):
    """``func`` over a tuple of inputs, a list output made a tuple; each
    output is appended to ``outs`` if given."""
    def f(*args):
        out = func(args[0]) if single else func(*args)
        out = tuple(out) if isinstance(out, list) else out
        if outs is not None:
            outs.append(out)
        return out

    return f


def _detach(out):
    return tuple(o.detach() for o in out) if isinstance(out, tuple) else \
        out.detach()


def jacobian(func, xs, create_graph=False, allow_unused=False):
    """d func / d xs: a tensor of shape ``out.shape + x.shape`` for one
    input and one output; over several inputs a tuple per input, and
    over several outputs a tuple per output (of those)."""
    single, args = _inputs(xs)
    return _F.jacobian(_fn(func, single), args[0] if single else args,
                       vectorize=False)


def hessian(func, xs, create_graph=False, allow_unused=False):
    """d² func / d xs² of a scalar ``func``: ``x.shape * 2`` for one
    input, a tuple of tuples over several.  Raises through a port
    kernel (see the module docstring)."""
    single, args = _inputs(xs)
    return _F.hessian(_fn(func, single), args[0] if single else args,
                      vectorize=False)


def jvp(func, xs, v=None):
    """``(func(xs), J·v)`` with ``v`` ones if None; the tangent is the
    reverse-mode jacobian contracted with ``v``."""
    single, args = _inputs(xs)
    tangents = tuple(torch.ones_like(a) for a in args) if v is None \
        else _inputs(v)[1]
    outs = []
    jac = _F.jacobian(_fn(func, single, outs), args, vectorize=False)
    out = _detach(outs[0])
    multi = isinstance(out, tuple)
    per_out = zip(out, jac) if multi else [(out, jac)]
    tangent_out = tuple(
        sum((j.reshape(o.numel(), -1) @ t.reshape(-1)).reshape(o.shape)
            for j, t in zip(js, tangents))
        for o, js in per_out)
    return out, (tangent_out if multi else tangent_out[0])


def vjp(func, xs, v=None):
    """``(func(xs), vᵀ·J)`` with ``v`` ones if None: a tensor for one
    input, a list over several."""
    single, args = _inputs(xs)
    args = tuple(a.requires_grad_() for a in args)
    with torch.enable_grad():
        out = _fn(func, single)(*args)
    outs = out if isinstance(out, tuple) else (out,)
    if v is None:
        cots = tuple(torch.ones_like(o) for o in outs)
    else:
        cots = _inputs(v)[1]
        if len(cots) != len(outs):
            raise ValueError(f"vjp: v has {len(cots)} leaves but func "
                             f"output has {len(outs)}")
    grads = torch.autograd.grad(outs, args, cots, allow_unused=True)
    grads = [torch.zeros_like(a) if g is None else g
             for a, g in zip(args, grads)]
    return _detach(out), (grads[0] if single else grads)
