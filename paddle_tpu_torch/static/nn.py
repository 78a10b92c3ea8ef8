"""``static.nn``, the counterpart of ``paddle_tpu/static/nn.py``: the
classic static-graph layer helpers and control flow.

``fc`` makes its parameters eagerly (concrete, from the port's counter
stream) and records the data path.  ``cond`` runs one branch when its
predicate is concrete (exact eager semantics and gradients); when the
predicate is symbolic (a static Program) or traced (``torch.compile``,
``jit.to_static``) it builds both branches and selects each output with
``torch.where``, with JAX's structure, shape and dtype checks: the
untaken branch still runs, and its ops see a zero cotangent.
``while_loop`` is a Python loop on concrete values, one
``torch._higher_order_ops.while_loop`` under a capture, and in a static
Program one node whose replay loops on the fed values, forward only
(its outputs stop gradient, as ``lax.while_loop`` has no reverse rule).
"""

from __future__ import annotations

import math

import torch

from ..core import Parameter
from ..nn import functional as F
from . import graph


def fc(x, size, num_flatten_dims=1, activation=None, name=None,
       weight_attr=None, bias_attr=None):
    """``static.nn.fc``: flatten the trailing dims, affine, optional
    activation.  The weight draws ``U(-k, k)``, ``k = 1/sqrt(in)``, from
    the port's counter stream (one key a call), the bias is zero."""
    if weight_attr is not None or bias_attr is not None:
        raise NotImplementedError(
            "static.nn.fc: weight_attr/bias_attr initializers are not "
            "supported; build the model with paddle_tpu_torch.nn layers "
            "instead")
    from ..nn.initializer import Uniform

    in_dim = math.prod(x.shape[num_flatten_dims:])
    k = 1.0 / math.sqrt(in_dim)
    with graph.concrete():
        w = Parameter(Uniform(-k, k)((in_dim, size), torch.float32,
                                     x.device))
        b = Parameter(torch.zeros(size, dtype=torch.float32,
                                  device=x.device))
    if x.dim() > num_flatten_dims + 1:
        # -1 on the leading (possibly fed-at-any-size) dim: the recorded
        # reshape keeps no build-time batch
        tail = list(x.shape[1:num_flatten_dims]) + [in_dim]
        x = x.reshape([-1] + tail)
    out = F.linear(x, w, b)
    if activation:
        out = getattr(F, activation)(out)
    return out


def batch_norm(x, **kwargs):
    raise NotImplementedError(
        "static.nn.batch_norm: build the model with paddle_tpu_torch.nn "
        "layers and stage it in static mode or through jit.to_static")


def _staged(t):
    return isinstance(t, torch.Tensor) and (
        graph.is_symbolic(t) or torch.compiler.is_compiling())


def _as_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    from ..core import to_tensor

    return to_tensor(x)


def _flatten_rets(res):
    """A branch's return (a tensor, None or nested tuples/lists of them)
    -> (leaves, rebuild)."""
    if res is None:
        return [], lambda leaves: None
    if isinstance(res, (tuple, list)):
        ctor = type(res)
        subs = [_flatten_rets(r) for r in res]
        sizes = [len(ls) for ls, _ in subs]
        leaves = [x for ls, _ in subs for x in ls]

        def rebuild(vals):
            out, off = [], 0
            for (_, rb), n in zip(subs, sizes):
                out.append(rb(vals[off:off + n]))
                off += n
            return ctor(out)

        return leaves, rebuild
    return [_as_tensor(res)], lambda vals: vals[0]


def cond(pred, true_fn=None, false_fn=None, name=None, return_names=None):
    """``static.nn.cond``: ``true_fn()`` where ``pred`` holds, else
    ``false_fn()`` (see the module docstring for staged predicates)."""
    if true_fn is None or false_fn is None:
        raise ValueError("cond requires both true_fn and false_fn")
    pred_t = _as_tensor(pred)
    if not _staged(pred_t):
        return true_fn() if bool(pred_t.reshape(())) else false_fn()
    t_leaves, rebuild = _flatten_rets(true_fn())
    f_leaves, _ = _flatten_rets(false_fn())
    if len(t_leaves) != len(f_leaves):
        raise ValueError(f"cond branches return different structures: "
                         f"{len(t_leaves)} vs {len(f_leaves)} tensors")
    for a, b in zip(t_leaves, f_leaves):
        if tuple(a.shape) != tuple(b.shape):
            raise ValueError(f"cond branch outputs must have matching "
                             f"shapes, got {tuple(a.shape)} vs "
                             f"{tuple(b.shape)}")
        if a.dtype != b.dtype:
            raise ValueError(
                f"cond branch outputs must have matching dtypes, got "
                f"{a.dtype} vs {b.dtype} (the select would silently "
                "promote; cast one branch explicitly)")
    from ..amp.auto_cast import cast_inputs

    cast_inputs("cond")             # names the selects of a static Program
    p = pred_t.reshape(()).to(torch.bool)
    return rebuild([torch.where(p, a, b) for a, b in zip(t_leaves,
                                                          f_leaves)])


def case(pred_fn_pairs, default=None, name=None):
    """``static.nn.case``: the first predicate that holds wins (chained
    ``cond`` selects)."""
    if not pred_fn_pairs:
        raise ValueError("case requires at least one (pred, fn) pair")
    if default is None:
        *rest, (_, last_fn) = list(pred_fn_pairs)
        default = last_fn
    else:
        rest = list(pred_fn_pairs)
    out = default()
    for p, fn in reversed(rest):
        out = cond(p, fn, (lambda o: lambda: o)(out))
    return out


def switch_case(branch_index, branch_fns, default=None, name=None):
    """``static.nn.switch_case``: the branch of an integer index;
    ``branch_fns`` a dict ``{index: fn}`` or a list of fns or
    ``(index, fn)`` pairs; an index out of range takes the largest
    index's fn when no ``default`` is given."""
    if isinstance(branch_fns, dict):
        items = sorted(branch_fns.items())
    else:
        items = sorted(
            (i, f) if not isinstance(f, (tuple, list)) else tuple(f)
            for i, f in enumerate(branch_fns))
    idx = _as_tensor(branch_index)
    if default is None:
        default = items[-1][1]
    out = default()
    for i, fn in reversed(items):
        out = cond(idx == i, fn, (lambda o: lambda: o)(out))
    return out


def _check_carry(out, carry):
    if not isinstance(out, (tuple, list)):
        out = (out,)
    if len(out) != len(carry):
        raise ValueError(f"while_loop body returned {len(out)} values for "
                         f"{len(carry)} loop_vars")
    res = []
    for o, a in zip(out, carry):
        o = _as_tensor(o)
        if tuple(o.shape) != tuple(a.shape) or o.dtype != a.dtype:
            raise ValueError(
                f"while_loop body changed a loop var from "
                f"{tuple(a.shape)}/{a.dtype} to {tuple(o.shape)}/{o.dtype} "
                "(loop-carried values must keep shape and dtype)")
        res.append(o)
    return tuple(res)


def _python_loop(cond_fn, body_fn, vals):
    with torch.no_grad():
        while bool(_as_tensor(cond_fn(*vals)).reshape(())):
            vals = _check_carry(body_fn(*vals), vals)
    return vals


def while_loop(cond, body, loop_vars, is_test=False, name=None):
    """``static.nn.while_loop``: ``while cond(*vars): vars =
    body(*vars)``, forward only; the body must keep each loop var's
    shape and dtype.  A symbolic value the body reads must come in
    through ``loop_vars``."""
    if not isinstance(loop_vars, (tuple, list)) or not loop_vars:
        raise ValueError("while_loop expects a non-empty list of loop_vars")
    ctor = type(loop_vars)
    vals = tuple(_as_tensor(v) for v in loop_vars)
    cond_fn, body_fn = cond, body
    if any(graph.is_symbolic(v) for v in vals):
        def loop(*carry):
            return _python_loop(cond_fn, body_fn, carry)

        outs = graph.record_call(
            loop, vals, "while_loop",
            meta=lambda *fakes: tuple(f.clone() for f in fakes))
        return ctor(outs)
    if torch.compiler.is_compiling():
        from torch._higher_order_ops.while_loop import while_loop as _wl

        def c(*carry):
            return _as_tensor(cond_fn(*carry)).reshape(()).to(torch.bool)

        def b(*carry):
            return tuple(o.clone() for o in _check_carry(body_fn(*carry),
                                                          carry))

        outs = _wl(c, b, tuple(v.detach() for v in vals))
        return ctor(outs)
    return ctor(_python_loop(cond_fn, body_fn, vals))
