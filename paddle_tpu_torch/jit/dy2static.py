"""dy2static: AST conversion of Python ``if``/``while``/``for`` over
traced tensors, the counterpart of ``paddle_tpu/jit/dy2static.py``.

``to_static`` captures a function with ``torch.compile`` (and
``jit.save`` with ``torch.export``).  Control flow over CONCRETE Python
values needs no conversion (the capture specializes on it, and captures
again for a new input signature).  What capture cannot do is a branch or
loop whose predicate is a traced tensor: dynamo would break the graph
there, and ``to_static`` captures whole graphs only.  This module closes
that gap as the JAX package's does, with the same AST transformer (a
copy: the early-exit rewrite ``_EarlyExit``, ``_CallTransformer``,
``_PredicateTransformer``, ``_Dy2StaticTransformer``, ``convert_call``,
``convert_to_static``) and runtime helpers that stage on torch's
control-flow operators:

- every ``if``/``while`` statement is rewritten into a call to a runtime
  dispatch helper (``convert_ifelse`` / ``convert_while``);
- at run time the helper inspects the predicate: a Python value, or a
  tensor outside a capture, keeps exact Python semantics (one branch
  runs, a loop runs eagerly); a tensor under ``torch.compile`` or
  ``torch.export`` (:func:`_is_traced`) stages:

  * ``convert_ifelse`` -> both branches are traced (as JAX's staging
    does) and ``torch.cond`` selects the variables they assign
    differently;
  * ``convert_while`` -> ``torch._higher_order_ops.while_loop``;
  * ``convert_for_iter`` over a traced tensor -> the rows are taken one
    at a time along the leading axis, whose length is static under
    capture (JAX's ``lax.scan`` gives the same values; this form is
    differentiable by torch autograd through the capture, which
    ``torch._higher_order_ops.scan`` is not on every torch this port
    runs on);
  * ``convert_for_range`` over a traced bound -> a ``while_loop`` whose
    trip count is computed on the device;

- variables assigned in a branch/loop body become explicit carries —
  rebound from a tuple on entry, returned on exit — so the rewrite never
  needs ``nonlocal`` and AugAssign keeps working;
- names possibly unbound before the statement are carried as an
  ``UNDEF`` sentinel: a temp defined inside the branch/loop body works,
  a genuine read-before-assignment raises a NameError naming the
  variable.

Early exits: ``return``/``break``/``continue`` inside convertible
control flow rewrite into flag-guarded dataflow before the statement
conversion (``_EarlyExit``), as in the JAX package: a greedy decode with
a data-dependent early exit stages as one program.  Loop temps first
assigned inside a staged while are zeros-initialized from a probe run of
the body (their shapes), so the post-loop read works; after a ZERO-trip
staged loop such a temp reads as zeros rather than raising — the
documented staging trade-off.

Deliberately NOT converted (the statement stays plain Python, which keeps
working for concrete predicates and raises
:class:`UnconvertibleControlFlowError` for traced ones):
``del``/``global``/``nonlocal`` in bodies; ``while/else`` /
``for/else``; exits inside ``with``/``try`` or non-range ``for`` loops;
generators/coroutines; impure return expressions evaluate at the
function-end dispatch rather than the return site; functions whose
source is unavailable.  Conversion is transitive through calls: user
call sites inside a converted function route through ``convert_call``,
so undecorated helpers stage too (framework/builtin callables pass
through untouched; mark a function with ``jit.not_to_static`` to opt
out).
"""

from __future__ import annotations

import ast
import functools
import inspect
import sys
import textwrap
import types

import torch

__all__ = ["convert_to_static", "convert_call", "convert_ifelse",
           "convert_while", "convert_for_range", "convert_for_iter",
           "convert_logical_and", "convert_logical_or",
           "convert_logical_not", "range_parts", "UndefinedVar", "UNDEF",
           "UnconvertibleControlFlowError", "unconvertible_guard"]


class UndefinedVar:
    """Sentinel carried for names not yet bound when a converted statement
    runs. Any actual USE raises — matching the NameError the untransformed
    code would have raised, just later and with context."""

    __slots__ = ("name",)

    def __init__(self, name="<var>"):
        self.name = name

    def _boom(self):
        name = getattr(self, "name", "<var>")
        raise NameError(
            f"variable {name!r} is read on a path through converted "
            "control flow where it was never assigned (dy2static carries "
            "it as undefined); assign it before the if/while")

    def __getattr__(self, item):
        if item == "name" or item.startswith("__"):
            raise AttributeError(item)   # the slot unset, a protocol probe
        self._boom()

    def __call__(self, *a, **k):
        self._boom()

    def __bool__(self):
        self._boom()

    def __iter__(self):
        self._boom()

    def __repr__(self):
        return f"UndefinedVar({self.name!r})"


# operator dunders are looked up on the TYPE (bypassing __getattr__), so a
# sentinel used in arithmetic/indexing/comparison must trip explicitly
def _undef_op(name):
    def op(self, *a, **k):
        self._boom()
    op.__name__ = name
    return op


for _dunder in ("__add__", "__radd__", "__sub__", "__rsub__", "__mul__",
                "__rmul__", "__truediv__", "__rtruediv__", "__floordiv__",
                "__rfloordiv__", "__mod__", "__rmod__", "__pow__",
                "__rpow__", "__matmul__", "__rmatmul__", "__neg__",
                "__pos__", "__abs__", "__lt__", "__le__", "__gt__",
                "__ge__", "__getitem__", "__setitem__", "__len__",
                "__float__", "__int__", "__index__", "__contains__"):
    setattr(UndefinedVar, _dunder, _undef_op(_dunder))


UNDEF = UndefinedVar()


UNDEF = UndefinedVar()


def _is_traced(x):
    """True when ``x`` is a tensor under a capture (``torch.compile`` or
    ``torch.export``) or a static Program's symbolic tensor
    (``paddle.enable_static()``): its value is not known, so a predicate
    on it stages (JAX's ``dy2static.py:125-136``)."""
    return isinstance(x, torch.Tensor) and (
        torch.compiler.is_compiling() or _is_symbolic(x))


def _is_symbolic(x):
    graph = sys.modules.get("paddle_tpu_torch.static.graph")
    return graph is not None and isinstance(x, graph.SymbolicTensor)


class UnconvertibleControlFlowError(TypeError):
    """A traced predicate reached an if/while the converter deliberately
    left as plain Python.  The message names each construct and its
    line (the JAX package cites its analysis rules' codes)."""


#: why a statement was left as plain Python, by the JAX package's
#: analysis rule code (``paddle_tpu/analysis``, not ported)
_REASONS = {
    "PTA001": "`del` inside the body",
    "PTA002": "`global`/`nonlocal` inside the body",
    "PTA003": "a loop `else` clause",
    "PTA004": "a return/break/continue inside `with` or `try`",
    "PTA006": "a `return` inside a `for` over a non-range iterable",
    "PTA007": "a return/break/continue the early-exit rewrite could not "
              "consume",
}


def unconvertible_guard(pred, reasons, filename, line):
    """Runtime guard the transformer wraps around the test of an
    UNCONVERTIBLE if/while: concrete predicates pass through with exact
    Python semantics; a traced predicate raises a source-mapped error
    naming each construct instead of a deep capture traceback.
    ``reasons``: ((code, absolute_line), ...)."""
    if not _is_traced(pred):
        return pred
    parts = [f"{filename}:{ln}: {code} {_REASONS.get(code, '')}"
             for code, ln in reasons]
    raise UnconvertibleControlFlowError(
        f"{filename}:{line}: this if/while has a traced (tensor) "
        "predicate, but the statement contains construct(s) dy2static "
        "deliberately does not stage:\n" + "\n".join(parts))


def _scan_statement(node):
    """Reasons ``node`` (an ast.If / ast.While / ast.For) cannot be
    staged, as [(code, lineno)] in source order (the JAX package's
    ``analysis.diagnostics.scan_statement`` with plain exits)."""
    out = []
    if isinstance(node, (ast.While, ast.For, ast.AsyncFor)) and node.orelse:
        out.append(("PTA003", node.lineno))

    def walk(stmts, in_with, loop_stack):
        for s in stmts:
            if isinstance(s, _SCOPES):
                continue
            if isinstance(s, ast.Delete):
                out.append(("PTA001", s.lineno))
            elif isinstance(s, (ast.Global, ast.Nonlocal)):
                out.append(("PTA002", s.lineno))
            elif isinstance(s, (ast.Return, ast.Break, ast.Continue)):
                if in_with:
                    out.append(("PTA004", s.lineno))
                elif isinstance(s, ast.Return) and "iter" in loop_stack:
                    out.append(("PTA006", s.lineno))
                elif isinstance(s, (ast.Break, ast.Continue)) \
                        and loop_stack:
                    pass        # belongs to the inner loop's own rewrite
                else:
                    out.append(("PTA007", s.lineno))
            if isinstance(s, (ast.With, ast.AsyncWith)):
                walk(s.body, True, loop_stack)
            elif isinstance(s, ast.Try):
                for blk in (s.body, s.orelse, s.finalbody):
                    walk(blk, True, loop_stack)
                for h in s.handlers:
                    walk(h.body, True, loop_stack)
            elif isinstance(s, (ast.For, ast.AsyncFor)):
                if s.orelse:
                    out.append(("PTA003", s.lineno))
                kind = ("range" if isinstance(s, ast.For)
                        and _is_range_call(s.iter) else "iter")
                walk(s.body, in_with, loop_stack + [kind])
                walk(s.orelse, in_with, loop_stack)
            elif isinstance(s, ast.While):
                if s.orelse:
                    out.append(("PTA003", s.lineno))
                walk(s.body, in_with, loop_stack + ["while"])
                walk(s.orelse, in_with, loop_stack)
            elif isinstance(s, ast.If):
                walk(s.body, in_with, loop_stack)
                walk(s.orelse, in_with, loop_stack)

    for body in (node.body, getattr(node, "orelse", []) or []):
        walk(body, False, [])
    out.sort(key=lambda cl: cl[1])
    return out


def _as_tensor(x, device=None):
    """A Python number as a 0-d tensor of JAX's x64-off dtype (bool,
    int32, float32) on ``device``: a ``full``, not a tensor constant (an
    exported program cannot serialize a constant inside a control-flow
    subgraph)."""
    if isinstance(x, torch.Tensor):
        return x
    dtype = (torch.bool if isinstance(x, bool) else
             torch.int32 if isinstance(x, int) else torch.float32)
    return torch.full((), x, dtype=dtype, device=device)


def _to_carry(x, name, device=None):
    """A loop carry entering the staged path must be a tensor."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (bool, int, float)):
        return _as_tensor(x, device)
    raise TypeError(
        f"variable {name!r} of type {type(x).__name__} cannot be carried "
        "through staged control flow (only tensors and numbers can); hoist "
        "it out of the if/while or keep the predicate concrete")


def _device_of(*vals):
    """The device of the first tensor among ``vals`` (nested in tuples):
    where staged Python numbers go."""
    for v in vals:
        if isinstance(v, torch.Tensor):
            return v.device
        if isinstance(v, tuple):
            d = _device_of(*v)
            if d is not None:
                return d
    return None


def _pred(p, device=None):
    """A staged predicate: a 0-d bool tensor."""
    p = _to_carry(p, "<predicate>", device)
    if p.dtype != torch.bool:
        p = p != 0
    return p.reshape(())


def _concrete(p):
    return bool(p) if isinstance(p, torch.Tensor) else p


def convert_ifelse(pred, true_fn, false_fn, vals, names, guard=False):
    """Runtime dispatch for a converted ``if``: concrete predicate keeps
    exact Python semantics (one branch runs); traced predicate traces
    both branches and stages ``torch.cond`` over each variable they
    assign differently.  ``guard=True`` marks the flag-guard ifs the
    early-exit rewrite generates: a name assigned on one path only
    merges as cond(pred, value, zeros) instead of the loud UndefinedVar —
    safe because the rewrite only reads such names on paths where the
    guard ran (locals freeze at the exit)."""
    if isinstance(pred, UndefinedVar):
        pred._boom()
    if not _is_traced(pred):
        return true_fn(vals) if _concrete(pred) else false_fn(vals)
    if not names:
        # a branch that binds no names can only act through side effects
        # (list.append, dict/attr mutation) — under a traced predicate
        # BOTH branches would execute unconditionally, so wrong results
        # would silently replace the loud pre-conversion error
        raise TypeError(
            "a converted `if` over a traced tensor predicate assigns no "
            "variables — its body works only by side effects, which "
            "cannot be staged (both branches trace). Assign the result "
            "to a variable, or call torch.cond directly.")
    # each branch works on its own copies: an in-place update (``i +=
    # 1``) in one must not reach the other, which also runs
    t_out = true_fn(_copies(vals))
    f_out = false_fn(_copies(vals))
    dev = _device_of(pred, t_out, f_out, vals)
    sel_idx, t_sel, f_sel = [], [], []
    merged = [None] * len(names)
    for i, (tv, fv, name) in enumerate(zip(t_out, f_out, names)):
        t_undef = isinstance(tv, UndefinedVar)
        f_undef = isinstance(fv, UndefinedVar)
        if t_undef and f_undef:
            merged[i] = UndefinedVar(name)      # stays undefined, loudly
        elif t_undef or f_undef:
            if guard:
                dv = _to_carry(fv if t_undef else tv, name, dev)
                zero = torch.zeros_like(dv)
                sel_idx.append(i)
                t_sel.append(zero if t_undef else dv)
                f_sel.append(dv if t_undef else zero)
            else:
                merged[i] = UndefinedVar(name)
        elif tv is fv:
            merged[i] = tv                      # untouched by both
        elif not isinstance(tv, torch.Tensor) and \
                not isinstance(fv, torch.Tensor) and tv == fv:
            merged[i] = tv                      # the same Python value
        else:
            if (tv is None) != (fv is None):
                if name.startswith(_RV):
                    raise TypeError(
                        "a staged early-exit function must return a "
                        "value of the same structure on EVERY path: an "
                        "implicit `return None` fall-through (or a bare "
                        "`return`) cannot merge with tensor returns "
                        "under a traced predicate — add an explicit "
                        "final return")
                raise TypeError(
                    f"variable {name!r} is None on one branch of a "
                    "staged `if` — both paths must assign an array "
                    "value (staged selects cannot mix None with "
                    "tensors)")
            tv, fv = _to_carry(tv, name, dev), _to_carry(fv, name, dev)
            dtype = torch.promote_types(tv.dtype, fv.dtype)
            shape = torch.broadcast_shapes(tv.shape, fv.shape)
            sel_idx.append(i)
            t_sel.append(tv.to(dtype).expand(shape))
            f_sel.append(fv.to(dtype).expand(shape))
    if sel_idx:
        # the branches return copies: torch.cond's outputs may not alias
        # its inputs
        k = len(t_sel)
        if _is_symbolic(pred):
            # a static Program records the select, as static.nn.cond does
            p = pred.reshape(()).to(torch.bool)
            picked = [torch.where(p, t, f) for t, f in zip(t_sel, f_sel)]
        else:
            picked = torch.cond(_pred(pred, dev),
                                lambda *ops: tuple(o.clone()
                                                   for o in ops[:k]),
                                lambda *ops: tuple(o.clone()
                                                   for o in ops[k:]),
                                tuple(t_sel + f_sel))
        for i, v in zip(sel_idx, picked):
            merged[i] = v
    return tuple(merged)


def _probe_body_carries(run_body, vals, names, keep):
    """Discover the shapes of names undefined BEFORE a staged loop but
    assigned by its body (``t = step(x)`` inside a decode ``while``):
    the body runs once on the carries (traced, so it costs nothing at
    run time: its results are not used and the capture drops them), and
    those names start as zeros of what it gave, so the value is readable
    after the loop (the early-exit dispatch reads it under its guard
    flag).  A body that READS an undefined name before assigning it
    raises inside the probe -> {} (the loud NameError then surfaces at
    the real trace, naming the variable).  After a ZERO-trip staged loop
    such a carry reads as zeros rather than raising — documented
    trade-off of staging.  run_body(vals_tuple) -> vals_tuple."""
    maybe = [i for i in range(len(vals)) if i not in keep]
    if not maybe:
        return {}
    vs = list(_copies(vals))
    for i in maybe:
        vs[i] = UndefinedVar(names[i])
    try:
        res = run_body(tuple(vs))
    except NameError:
        return {}
    return {i: torch.zeros_like(res[i]) for i in maybe
            if isinstance(res[i], torch.Tensor)}


def convert_while(cond_fn, body_fn, vals, names, reads=()):
    """Runtime dispatch for a converted ``while``: a concrete first
    predicate runs the plain Python loop (which unrolls under capture);
    a traced predicate stages ONE ``while_loop`` over the defined
    carries.  A predicate that BECOMES traced mid-loop (a staged
    break/return flag flipping a concrete bound, ``while i < 100: ... if
    done(x): break``) continues as one staged while from the current
    state — already-run iterations stay unrolled.  Names unbound before
    the loop carry per _probe_body_carries; a genuine read-before-assign
    raises a NameError naming the variable."""
    first = cond_fn(vals)
    if isinstance(first, UndefinedVar):
        first._boom()
    if not _is_traced(first):
        p = _concrete(first)
        while p:
            vals = body_fn(vals)
            nxt = cond_fn(vals)
            if _is_traced(nxt):
                # data-dependent from here on: stage the remainder
                return _convert_while_staged(cond_fn, body_fn, vals, names,
                                             reads)
            p = _concrete(nxt)
        return vals
    return _convert_while_staged(cond_fn, body_fn, vals, names, reads)


def _while(cond_w, body_w, carried):
    from torch._higher_order_ops import while_loop

    out = while_loop(cond_w, body_w, tuple(carried))
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _copies(vals):
    """``vals`` with each tensor cloned (a staged body may update a
    variable in place; ``while_loop`` and ``cond`` take no mutation of
    their inputs)."""
    return tuple(v.clone() if isinstance(v, torch.Tensor) else v
                 for v in vals)


def _full(vals, keep, vs, names):
    out = list(vals)
    for i, v in zip(keep, vs):
        out[i] = v
    for i in range(len(out)):
        if isinstance(out[i], UndefinedVar):
            out[i] = UndefinedVar(names[i])
    return tuple(out)


def _body_outs(res, keep, carried, names):
    """The carried values a body returned, each in its carry's dtype and
    shape (``while_loop`` keeps both fixed)."""
    out = []
    for j, c in zip(keep, carried):
        v = res[j]
        if isinstance(v, UndefinedVar):
            v._boom()
        v = _to_carry(v, names[j], c.device)
        if v.shape != c.shape:
            raise TypeError(
                f"staged loop body changed carried variable {names[j]!r} "
                f"from {tuple(c.shape)} to {tuple(v.shape)} (loop-carried "
                "values must keep their shape)")
        out.append(v.to(c.dtype).clone())
    return tuple(out)


def _convert_while_staged(cond_fn, body_fn, vals, names, reads=()):
    # a carry the body reads before assigning it must be defined before
    # the loop (``reads``, from the source): raise by name here, where
    # the JAX package's probe finds it
    for i, name in enumerate(names):
        if name in reads and isinstance(vals[i], UndefinedVar):
            UndefinedVar(name)._boom()
    keep = [i for i, v in enumerate(vals)
            if not isinstance(v, UndefinedVar)]
    extra = _probe_body_carries(body_fn, vals, names, keep)
    keep = sorted(set(keep) | set(extra))
    if not keep:
        raise TypeError(
            "a converted `while` over a traced tensor predicate carries "
            "no defined variables — initialize the loop state before the "
            "loop (while_loop needs loop-carried values).")
    dev = _device_of(tuple(extra.values()), vals)
    carried = [extra[i] if i in extra else _to_carry(vals[i], names[i], dev)
               for i in keep]

    def cond_w(*vs):
        return _pred(cond_fn(_full(vals, keep, _copies(vs), names)), dev)

    def body_w(*vs):
        res = body_fn(_full(vals, keep, _copies(vs), names))
        return _body_outs(res, keep, carried, names)

    outs = _while(cond_w, body_w, carried)
    return _full(vals, keep, outs, names)


def convert_logical_and(lx, ly):
    """``a and b`` inside a converted statement's predicate: Python
    short-circuit semantics for concrete values; traced values evaluate
    BOTH sides and stage ``logical_and`` (no short-circuit once
    staged)."""
    x = lx()
    if isinstance(x, UndefinedVar):
        x._boom()
    if not _is_traced(x):
        if not _concrete(x):
            return x
        return ly()
    y = ly()
    dev = _device_of(x, y)
    return torch.logical_and(_pred(x, dev), _pred(y, dev))


def convert_logical_or(lx, ly):
    x = lx()
    if isinstance(x, UndefinedVar):
        x._boom()
    if not _is_traced(x):
        if _concrete(x):
            return x
        return ly()
    y = ly()
    dev = _device_of(x, y)
    return torch.logical_or(_pred(x, dev), _pred(y, dev))


def convert_logical_not(x):
    if isinstance(x, UndefinedVar):
        x._boom()
    if not _is_traced(x):
        return not _concrete(x)
    return torch.logical_not(_pred(x))


def _range_normalize(args):
    """(start, stop, step) from range-call args, with Python's zero-step
    check (shared by convert_for_range and range_parts)."""
    if len(args) == 1:
        start, stop, step = 0, args[0], 1
    elif len(args) == 2:
        (start, stop), step = args, 1
    else:
        start, stop, step = args
    if isinstance(step, (int, torch.Tensor)) and not _is_traced(step) \
            and int(step) == 0:
        raise ValueError("range() arg 3 must not be zero")
    return start, stop, step


def _range_count(start, stop, step):
    """Sign-aware integer ceil-div trip count on tensors (exact at any
    int32 bound)."""
    n_pos = torch.div(stop - start + step - 1, step, rounding_mode="floor")
    n_neg = torch.div(start - stop - step - 1, -step, rounding_mode="floor")
    return torch.clamp(torch.where(step > 0, n_pos, n_neg),
                       min=0).to(torch.int32)


def _int_tensors(*vs):
    dev = _device_of(*vs)
    return [_as_tensor(v, dev).to(torch.int32) for v in vs]


def convert_for_range(range_args, body_fn, vals, names,
                      target_name="<target>", target_prior=UNDEF):
    """Runtime dispatch for a converted ``for <target> in range(...)``:
    concrete bounds run the plain Python loop (unrolls under capture); a
    traced bound stages ONE ``while_loop`` with the trip count computed
    on the device.  body_fn((i, vals)) -> vals.  Returns (final_i, vals)
    — after an EMPTY range the target keeps its prior binding
    (``target_prior``, Python semantics; after a staged empty range that
    only works when the prior value is a tensor/number — otherwise the
    target pins to ``start``)."""
    start, stop, step = _range_normalize(range_args)
    if not any(_is_traced(v) for v in (start, stop, step)):
        as_py = [int(v) if isinstance(v, torch.Tensor) else v
                 for v in (start, stop, step)]
        # empty range keeps the prior binding; an unbound prior stays the
        # loud sentinel, renamed so the eventual NameError names the var
        i = (UndefinedVar(target_name)
             if isinstance(target_prior, UndefinedVar) else target_prior)
        for i in range(*as_py):
            vals = body_fn((i, vals))
        return i, vals

    start_t, stop_t, step_t = _int_tensors(start, stop, step)
    n_iters = _range_count(start_t, stop_t, step_t)
    keep = [i for i, v in enumerate(vals)
            if not isinstance(v, UndefinedVar)]
    extra = _probe_body_carries(lambda vs: body_fn((start_t, vs)), vals,
                                names, keep)
    keep = sorted(set(keep) | set(extra))
    carried = [extra[i] if i in extra else
               _to_carry(vals[i], names[i], start_t.device) for i in keep]

    def cond_w(k, i, *vs):
        return k < n_iters

    def body_w(k, i, *vs):
        res = body_fn((i, _full(vals, keep, _copies(vs), names)))
        return (k + 1, i + step_t) + _body_outs(res, keep, carried, names)

    outs = _while(cond_w, body_w,
                  [torch.zeros_like(n_iters), start_t.clone()] + carried)
    final_i = outs[1] - step_t          # the last iterated value...
    # ...except for an empty range, where Python keeps the target's prior
    # binding — honored when the prior is a tensor or a number; otherwise
    # the staged code pins it to `start` deterministically
    if isinstance(target_prior, (torch.Tensor, int, float)) \
            and not isinstance(target_prior, bool):
        empty = _as_tensor(target_prior, start_t.device).to(start_t.dtype)
    else:
        empty = start_t
    final_i = torch.where(n_iters > 0, final_i, empty)
    return final_i, _full(vals, keep, outs[2:], names)


def range_parts(*args):
    """(start, trip_count, step) for range(*args) — plain ints for
    concrete bounds (the rewritten while unrolls under capture exactly
    like the plain for did), int32 scalar tensors when any bound is
    traced (the while stages).  Used by the early-exit rewrite's
    for->while form."""
    start, stop, step = _range_normalize(args)
    if not any(_is_traced(v) for v in (start, stop, step)):
        as_py = [int(v) if isinstance(v, torch.Tensor) else v
                 for v in (start, stop, step)]
        return as_py[0], len(range(*as_py)), as_py[2]
    start_t, stop_t, step_t = _int_tensors(start, stop, step)
    return start_t, _range_count(start_t, stop_t, step_t), step_t


def convert_for_iter(seq, body_fn, vals, names,
                     target_name="<target>", target_prior=UNDEF):
    """Runtime dispatch for a converted ``for <target> in <expr>`` over a
    NON-range iterable: a traced tensor sequence runs its rows one at a
    time along the leading axis (static under capture), carrying the
    variables the body assigns with their shapes and dtypes fixed, as
    JAX's ``lax.scan`` over the leading axis does; every other iterable
    (lists, generators, concrete tensors) runs the plain Python loop with
    exact semantics.  body_fn((x, vals)) -> vals.  Returns
    (final_target, vals)."""
    if not _is_traced(seq):
        i = (UndefinedVar(target_name)
             if isinstance(target_prior, UndefinedVar) else target_prior)
        for i in seq:
            vals = body_fn((i, vals))
        return i, vals
    if seq.dim() < 1:
        raise TypeError(
            "cannot iterate a 0-d tensor in converted control flow")
    n = int(seq.shape[0])          # the leading dim is static under capture
    keep = [i for i, v in enumerate(vals)
            if not isinstance(v, UndefinedVar)]
    extra = _probe_body_carries(
        lambda vs: body_fn((torch.zeros_like(seq[0]), vs)), vals, names,
        keep)
    keep = sorted(set(keep) | set(extra))
    if not keep:
        raise TypeError(
            "a converted `for` over a traced tensor sequence assigns no "
            "variables — its body works only by side effects, which "
            "cannot be staged; assign results to variables, or keep the "
            "sequence concrete")
    carried = [extra[i] if i in extra else
               _to_carry(vals[i], names[i], seq.device) for i in keep]
    cur = tuple(carried)
    for r in range(n):
        res = body_fn((seq[r], _full(vals, keep, cur, names)))
        outs = []
        for j, c in zip(keep, carried):
            v = res[j]
            if isinstance(v, UndefinedVar):
                v._boom()
            v = _to_carry(v, names[j], c.device)
            if v.shape != c.shape or v.dtype != c.dtype:
                raise TypeError(
                    f"staged for-loop body changed carried variable "
                    f"{names[j]!r} from {tuple(c.shape)}/{c.dtype} to "
                    f"{tuple(v.shape)}/{v.dtype} (loop-carried values must "
                    "keep shape and dtype)")
            outs.append(v)
        cur = tuple(outs)
    final = _full(vals, keep, cur, names)
    if n == 0:
        final_t = (UndefinedVar(target_name)
                   if isinstance(target_prior, UndefinedVar)
                   else target_prior)
    else:
        final_t = seq[n - 1]       # Python leaves target = last element
    return final_t, final


# --------------------------------------------------------------------------
# AST transformation


_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)


def _assigned_names(stmts):
    """Names bound by the statement list, in first-assignment order.
    Mutations through subscripts/attributes are not bindings; nested
    function/class bodies and comprehensions have their own scope."""
    out, seen = [], set()

    def add(name):
        if not name.startswith("__jst") and name not in seen:
            seen.add(name)
            out.append(name)

    def target_names(t):
        if isinstance(t, ast.Name):
            add(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                target_names(e)
        elif isinstance(t, ast.Starred):
            target_names(t.value)

    def walk(body):
        for node in body:
            if isinstance(node, _SCOPES):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    add(node.name)
                continue
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    target_names(t)
            elif isinstance(node, ast.AugAssign):
                target_names(node.target)
            elif isinstance(node, ast.AnnAssign):
                if node.value is not None:
                    target_names(node.target)
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                target_names(node.target)
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    if item.optional_vars is not None:
                        target_names(item.optional_vars)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    add((a.asname or a.name).split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                for a in node.names:
                    add(a.asname or a.name)
            for sub in ast.walk(node):
                if isinstance(sub, ast.NamedExpr) \
                        and isinstance(sub.target, ast.Name):
                    add(sub.target.id)
            for attr in ("body", "orelse", "finalbody"):
                child = getattr(node, attr, None)
                if child:
                    walk(child)
            for h in getattr(node, "handlers", ()) or ():
                walk(h.body)

    walk(list(stmts))
    return out


def _contains(stmts, kinds, skip_loops=False):
    """Any node of `kinds` in the statement list, not counting nested
    function/class scopes; with skip_loops, nested for/while bodies are
    skipped too (their break/continue belong to them)."""
    for node in stmts:
        if isinstance(node, _SCOPES):
            continue
        if isinstance(node, kinds):
            return True
        if skip_loops and isinstance(node, (ast.For, ast.AsyncFor,
                                            ast.While)):
            children = list(node.orelse)      # loop else runs after the loop
        else:
            children = []
            for a in ("body", "orelse", "finalbody"):
                children += getattr(node, a, None) or []
            for h in getattr(node, "handlers", ()) or ():
                children += h.body
        if children and _contains(children, kinds, skip_loops):
            return True
    return False


def _convertible(node):
    for body in (node.body, getattr(node, "orelse", [])):
        if not body:
            continue
        if _contains(body, (ast.Return, ast.Delete, ast.Global,
                            ast.Nonlocal)):
            return False
        if _contains(body, (ast.Break, ast.Continue), skip_loops=True):
            return False
    return True


#: the helper module's name in a converted function's globals: not the
#: JAX package's ``__jst``, so functions of one module can be converted by
#: both packages (dynamo also guards a global by its module's name)
_HELPER = "__jst_pt"
_VALS = "__jst_vals"
# early-exit flag names deliberately do NOT start with "__jst":
# _assigned_names skips that prefix, and these flags must be CARRIED
# through staged control flow like ordinary variables
_RET = "_jst_ret"
_SITE = "_jst_site"
_RV = "_jst_rv"


def _load(name):
    return ast.Name(id=name, ctx=ast.Load())


def _store(name):
    return ast.Name(id=name, ctx=ast.Store())


def _names_tuple(names, ctx):
    return ast.Tuple(elts=[ast.Name(id=n, ctx=ctx()) for n in names],
                     ctx=ctx())


def _one_arg():
    return ast.arguments(posonlyargs=[], args=[ast.arg(arg=_VALS)],
                         vararg=None, kwonlyargs=[], kw_defaults=[],
                         kwarg=None, defaults=[])


def _fn_def(name, body_stmts, carry_names, tail):
    """def <name>(__jst_vals): (a,b)=__jst_vals; <body>; <tail>"""
    body = []
    if carry_names:
        body.append(ast.Assign(targets=[_names_tuple(carry_names,
                                                     ast.Store)],
                               value=_load(_VALS)))
    body += body_stmts or [ast.Pass()]
    body.append(tail)
    return ast.FunctionDef(name=name, args=_one_arg(), body=body,
                           decorator_list=[], returns=None, type_params=[])


def _carries_return(names):
    return ast.Return(value=ast.Tuple(elts=[_load(n) for n in names],
                                      ctx=ast.Load()))


def _guarded_reads(names, prefix):
    """__jst_vN_i = a — reads the current value of each carry.  The JAX
    package wraps each read in try/except NameError; dynamo cannot read
    an unbound local, so here every local the converted function assigns
    starts as ``__jst.UNDEF`` instead (:func:`_undef_inits`), and an
    unbound carry reads as the sentinel all the same."""
    return [ast.Assign(targets=[_store(f"{prefix}{i}")], value=_load(n))
            for i, n in enumerate(names)]


def _undef_inits(fdef):
    """``name = __jst.UNDEF`` for every local ``fdef`` assigns that is
    not one of its parameters: the sentinel a read before assignment
    finds (a NameError naming the variable on first use)."""
    a = fdef.args
    params = {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs}
    params |= {x.arg for x in (a.vararg, a.kwarg) if x is not None}
    undef = ast.Attribute(value=_load(_HELPER), attr="UNDEF", ctx=ast.Load())
    return [ast.Assign(targets=[_store(n)], value=undef)
            for n in _assigned_names(fdef.body) if n not in params]


def _lam(expr):
    return ast.Lambda(
        args=ast.arguments(posonlyargs=[], args=[], vararg=None,
                           kwonlyargs=[], kw_defaults=[], kwarg=None,
                           defaults=[]),
        body=expr)


def _helper_call(name, args):
    return ast.Call(
        func=ast.Attribute(value=_load(_HELPER), attr=name,
                           ctx=ast.Load()),
        args=args, keywords=[])


def _assign(name, value):
    return ast.Assign(targets=[_store(name)], value=value)


def _const(v):
    return ast.Constant(value=v)


def _not(expr):
    return ast.UnaryOp(op=ast.Not(), operand=expr)


def _terminates(stmts):
    """True when the statement list definitely returns on every path
    (last stmt is a return, an if/else whose branches both do, or a
    `while True:` with no break — the canonical `while True: ... if eos:
    return x` decode can only exit through a return)."""
    if not stmts:
        return False
    last = stmts[-1]
    if isinstance(last, ast.Return):
        return True
    if isinstance(last, ast.If):
        return (bool(last.orelse) and _terminates(last.body)
                and _terminates(last.orelse))
    if isinstance(last, ast.While):
        test_true = (isinstance(last.test, ast.Constant)
                     and bool(last.test.value))
        return (test_true
                and not _contains(last.body, (ast.Break,),
                                  skip_loops=True))
    return False


class _LoopCtx:
    __slots__ = ("brk", "cont")

    def __init__(self, brk, cont):
        self.brk = brk          # flag name or None (no `break` targets it)
        self.cont = cont        # flag name or None


def _is_range_call(it):
    return (isinstance(it, ast.Call) and isinstance(it.func, ast.Name)
            and it.func.id == "range" and not it.keywords
            and 1 <= len(it.args) <= 3
            and not any(isinstance(a, ast.Starred) for a in it.args))


def _is_simple_range_for(node):
    return (isinstance(node, ast.For) and not node.orelse
            and isinstance(node.target, ast.Name)
            and _is_range_call(node.iter))


class _EarlyExit:
    """Function-level rewrite of `return`/`break`/`continue` into
    flag-guarded dataflow — the reference's return_transformer /
    break_continue_transformer (python/paddle/jit/dy2static/transformers/
    (U)), redesigned carry-free for TPU staging:

    - `return e` at site k becomes `_jst_ret = True; _jst_site = k`;
      every statement after a may-exit statement is wrapped in
      `if not <flags>:` so locals FREEZE at the exit moment;
    - loops containing exits get per-loop break/continue flags and the
      conjunct `not flag` on their predicate; `for _ in range(...)` with
      exits rewrites to an equivalent while (`range_parts` computes the
      trip count, concretely or on-device);
    - the function ends with a site-dispatch chain that re-evaluates the
      k-th return EXPRESSION once, from the frozen locals — no
      return-value carries at all (the reference carries magic-number
      placeholder values instead), so the staged carries are two scalars.

    Because the guards freeze all locals, deferred evaluation is
    observationally equivalent for pure expressions; an impure return
    expression (rare, discouraged under tracing) evaluates at function
    end instead of at the return site. Exits inside with/try, non-range
    for loops, or loop-else clauses abort the rewrite (those statements
    keep today's fall-back behavior)."""

    def __init__(self):
        self.n = 0
        self.sites = []            # [(site_id, value_expr_or_None)]
        self.use_ret = False

    # -- scan for placements the guard rewrite cannot reach
    def _unsupported(self, stmts, in_loop):
        for s in stmts:
            if isinstance(s, _SCOPES):
                continue
            if isinstance(s, (ast.With, ast.AsyncWith, ast.Try)):
                kids = []
                for a in ("body", "orelse", "finalbody"):
                    kids += getattr(s, a, None) or []
                for h in getattr(s, "handlers", ()) or ():
                    kids += h.body
                if _contains(kids, (ast.Return,)):
                    return True
                if in_loop and _contains(kids, (ast.Break, ast.Continue),
                                         skip_loops=True):
                    return True
                continue
            if isinstance(s, (ast.For, ast.AsyncFor)):
                if not _is_simple_range_for(s):
                    if _contains([s], (ast.Return,)):
                        return True
                    continue        # break targeting it stays Python
                if self._unsupported(s.body, True):
                    return True
                continue
            if isinstance(s, ast.While):
                if s.orelse:
                    if _contains([s], (ast.Return,)):
                        return True
                    continue
                if self._unsupported(s.body, True):
                    return True
                continue
            if isinstance(s, ast.If):
                if self._unsupported(s.body, in_loop) \
                        or self._unsupported(s.orelse, in_loop):
                    return True
        return False

    def transform(self, fdef):
        body = fdef.body
        ret_in_compound = any(
            isinstance(s, (ast.If, ast.While, ast.For))
            and _contains([s], (ast.Return,)) for s in body)
        brk_anywhere = self._any_staged_break(body)
        if not (ret_in_compound or brk_anywhere):
            return False
        if self._unsupported(body, False):
            return False
        self.use_ret = ret_in_compound
        falls_through = not _terminates(body)
        new_body, _ = self._rw_list(body, None)
        out = []
        if self.use_ret:
            out += [_assign(_RET, _const(False)), _assign(_SITE, _const(0))]
        out += new_body
        if self.use_ret:
            out += self._dispatch(falls_through)
        fdef.body = [ast.copy_location(s, body[0]) for s in out]
        ast.fix_missing_locations(fdef)
        return True

    def _any_staged_break(self, stmts):
        for s in stmts:
            if isinstance(s, _SCOPES):
                continue
            if isinstance(s, ast.While) and not s.orelse \
                    and _contains(s.body, (ast.Break, ast.Continue),
                                  skip_loops=True):
                return True
            if isinstance(s, ast.For) and _is_simple_range_for(s) \
                    and _contains(s.body, (ast.Break, ast.Continue),
                                  skip_loops=True):
                return True
            for a in ("body", "orelse", "finalbody"):
                if self._any_staged_break(getattr(s, a, None) or []):
                    return True
            for h in getattr(s, "handlers", ()) or ():
                if self._any_staged_break(h.body):
                    return True
        return False

    # -- rewrite
    def _live_flags(self, ctx):
        flags = []
        if ctx is not None:
            flags += [f for f in (ctx.brk, ctx.cont) if f]
        if self.use_ret:
            flags.append(_RET)
        return flags

    def _rw_list(self, stmts, ctx):
        out, may_any = [], False
        for idx, s in enumerate(stmts):
            new, may = self._rw_stmt(s, ctx)
            out.extend(new)
            if may:
                may_any = True
                rest = stmts[idx + 1:]
                if rest:
                    rbody, _ = self._rw_list(rest, ctx)
                    flags = self._live_flags(ctx)
                    loads = [_load(f) for f in flags]
                    test = _not(loads[0] if len(loads) == 1
                                else ast.BoolOp(op=ast.Or(), values=loads))
                    g = ast.If(test=test, body=rbody, orelse=[])
                    g._jst_guard = True   # one-sided assigns merge softly
                    out.append(g)
                return out, True
        return out, may_any

    def _rw_stmt(self, s, ctx):
        if isinstance(s, ast.Return):
            if not self.use_ret:
                return [s], False
            k = len(self.sites) + 1
            self.sites.append((k, s.value))
            return [_assign(_RET, _const(True)),
                    _assign(_SITE, _const(k))], True
        if isinstance(s, ast.Break):
            return [_assign(ctx.brk, _const(True))], True
        if isinstance(s, ast.Continue):
            return [_assign(ctx.cont, _const(True))], True
        if isinstance(s, ast.If):
            nb, mb = self._rw_list(s.body, ctx)
            no, mo = self._rw_list(s.orelse, ctx)
            s.body = nb or [ast.Pass()]
            s.orelse = no
            return [s], mb or mo
        if isinstance(s, ast.While) and not s.orelse:
            return self._rw_while(s, ctx)
        if isinstance(s, ast.For) and _is_simple_range_for(s):
            return self._rw_for_range(s, ctx)
        return [s], False

    def _loop_flags(self, body):
        """(brk_name|None, cont_name|None, ret_in) for a loop body."""
        self.n += 1
        k = self.n
        brk = (f"_jst_brk{k}"
               if _contains(body, (ast.Break,), skip_loops=True) else None)
        cont = (f"_jst_cont{k}"
                if _contains(body, (ast.Continue,), skip_loops=True)
                else None)
        ret_in = self.use_ret and _contains(body, (ast.Return,))
        return brk, cont, ret_in

    def _loop_test(self, orig_test, brk, ret_in):
        conj = []
        if brk:
            conj.append(_not(_load(brk)))
        if ret_in:
            conj.append(_not(_load(_RET)))
        if not conj:
            return orig_test
        return ast.BoolOp(op=ast.And(), values=conj + [orig_test])

    def _rw_while(self, s, outer_ctx):
        brk, cont, ret_in = self._loop_flags(s.body)
        if not (brk or cont or ret_in):
            s.body = self._rw_list(s.body, None)[0]   # nested loops only
            return [s], False
        nb, _ = self._rw_list(s.body, _LoopCtx(brk, cont))
        body = ([_assign(cont, _const(False))] if cont else []) + nb
        s.test = self._loop_test(s.test, brk, ret_in)
        s.body = body
        pre = [_assign(brk, _const(False))] if brk else []
        return pre + [s], ret_in

    def _rw_for_range(self, s, outer_ctx):
        brk, cont, ret_in = self._loop_flags(s.body)
        if not (brk or cont or ret_in):
            s.body = self._rw_list(s.body, None)[0]
            return [s], False
        k = self.n
        base, cnt, stp = f"_jst_fb{k}", f"_jst_fn{k}", f"_jst_fs{k}"
        i = f"_jst_fi{k}"
        parts_call = ast.Call(
            func=ast.Attribute(value=_load(_HELPER), attr="range_parts",
                               ctx=ast.Load()),
            args=list(s.iter.args), keywords=[])
        pre = [ast.Assign(
                   targets=[ast.Tuple(
                       elts=[_store(base), _store(cnt), _store(stp)],
                       ctx=ast.Store())],
                   value=parts_call),
               _assign(i, _const(0))]
        nb, _ = self._rw_list(s.body, _LoopCtx(brk, cont))
        body = ([_assign(cont, _const(False))] if cont else [])
        body.append(ast.Assign(
            targets=[_store(s.target.id)],
            value=ast.BinOp(left=_load(base), op=ast.Add(),
                            right=ast.BinOp(left=_load(i), op=ast.Mult(),
                                            right=_load(stp)))))
        body += nb
        # the increment stays OUTSIDE the continue/break guards: `continue`
        # must still advance the iteration variable, exactly like the
        # Python for it replaces
        body.append(_assign(i, ast.BinOp(left=_load(i), op=ast.Add(),
                                         right=_const(1))))
        test = self._loop_test(
            ast.Compare(left=_load(i), ops=[ast.Lt()],
                        comparators=[_load(cnt)]),
            brk, ret_in)
        loop = ast.While(test=test, body=body, orelse=[])
        pre2 = [_assign(brk, _const(False))] if brk else []
        return pre + pre2 + [loop], ret_in

    # -- final site dispatch
    def _dispatch(self, falls_through):
        sites = self.sites
        if not sites:
            return []
        if falls_through:
            leaf_expr, chain_sites = None, sites
        else:
            leaf_expr, chain_sites = sites[-1][1], sites[:-1]

        # element-wise return values when every site returns a literal
        # tuple of one arity (staged selects need array leaves, not
        # tuple objects)
        arities = set()
        for _, e in sites:
            arities.add(len(e.elts) if isinstance(e, ast.Tuple)
                        else (None if e is None else -1))
        m = next(iter(arities)) if len(arities) == 1 else -1
        if isinstance(m, int) and m is not None and m > 0 \
                and not falls_through:
            rvs = [f"{_RV}_{j}" for j in range(m)]

            def site_assign(e):
                return [ast.Assign(
                    targets=[ast.Tuple(elts=[_store(r) for r in rvs],
                                       ctx=ast.Store())],
                    value=e)]

            ret_stmt = ast.Return(value=ast.Tuple(
                elts=[_load(r) for r in rvs], ctx=ast.Load()))
        else:
            def site_assign(e):
                return [_assign(_RV, e if e is not None else _const(None))]

            ret_stmt = ast.Return(value=_load(_RV))

        cur = site_assign(leaf_expr)
        for k, e in reversed(chain_sites):
            cur = [ast.If(
                test=ast.Compare(left=_load(_SITE), ops=[ast.Eq()],
                                 comparators=[_const(k)]),
                body=site_assign(e), orelse=cur)]
        return cur + [ret_stmt]


_BUILTIN_SKIP = {"range", "len", "print", "isinstance", "issubclass",
                 "getattr", "setattr", "hasattr", "float", "int", "bool",
                 "str", "repr", "type", "enumerate", "zip", "list",
                 "dict", "tuple", "set", "super", "sorted", "reversed",
                 "min", "max", "abs", "sum", "any", "all", "id", "iter",
                 "next", "callable", "vars", "globals", "locals"}


class _CallTransformer(ast.NodeTransformer):
    """`f(...)` -> `__jst.convert_call(f)(...)` at user call sites, making
    conversion TRANSITIVE through calls (ref dy2static convert_call (U)).
    Applied AFTER the statement conversion: it descends into the
    generated `__jst_*` branch/body defs (user code lives there now) but
    leaves genuinely nested user defs alone — those convert at their own
    call sites. Builtin names and `__jst` helpers are skipped to keep the
    eager overhead at one cached dict lookup per user call."""

    def __init__(self):
        self.wrapped = 0
        self.names = set()      # the plain names called (pre-converted)

    def _visit_scope(self, node):
        if node.name.startswith("__jst"):
            return self.generic_visit(node)
        return node

    visit_FunctionDef = _visit_scope
    visit_AsyncFunctionDef = _visit_scope

    def visit_ClassDef(self, node):
        return node

    def visit_Lambda(self, node):
        return node

    def visit_Call(self, node):
        node = self.generic_visit(node)
        f = node.func
        if isinstance(f, ast.Name):
            if f.id in _BUILTIN_SKIP or f.id.startswith("__jst"):
                return node
        elif not (isinstance(f, ast.Attribute)
                  and isinstance(f.value, ast.Name) and f.value.id == "self"):
            # only plain names and ``self.<method>``: dynamo cannot
            # inspect other attributes (a tensor's bound method) inside
            # convert_call, so module functions and tensor methods pass
            # through unconverted
            return node
        if isinstance(f, ast.Name):
            self.names.add(f.id)
        node.func = _helper_call("convert_call", [f])
        self.wrapped += 1
        return node


class _PredicateTransformer(ast.NodeTransformer):
    """Rewrites `and`/`or`/`not` and chained comparisons INSIDE a
    converted statement's test expression into lazy helper calls, so
    traced operands stage (logical_and/or/not) instead of tripping
    Python's bool() — the reference's convert_logical_* rewrite.
    Short-circuit behavior is preserved for concrete values; a CHAINED
    comparison's middle operands may evaluate twice (lite scope). Apply
    via `transform`, which skips tests containing walrus bindings (the
    lambda wrap would capture `:=` in its own scope, hiding the name
    from the branch body)."""

    @classmethod
    def transform(cls, test):
        if any(isinstance(s, ast.NamedExpr) for s in ast.walk(test)):
            return test
        return cls().visit(test)

    def visit_Lambda(self, node):
        return node

    def visit_BoolOp(self, node):
        node = self.generic_visit(node)
        name = ("convert_logical_and" if isinstance(node.op, ast.And)
                else "convert_logical_or")
        out = node.values[-1]
        for v in reversed(node.values[:-1]):
            out = _helper_call(name, [_lam(v), _lam(out)])
        return out

    def visit_UnaryOp(self, node):
        node = self.generic_visit(node)
        if isinstance(node.op, ast.Not):
            return _helper_call("convert_logical_not", [node.operand])
        return node

    def visit_Compare(self, node):
        node = self.generic_visit(node)
        if len(node.ops) == 1:
            return node
        left, pairs = node.left, []
        for op, comp in zip(node.ops, node.comparators):
            pairs.append(ast.Compare(left=left, ops=[op],
                                     comparators=[comp]))
            left = comp
        out = pairs[-1]
        for p in reversed(pairs[:-1]):
            out = _helper_call("convert_logical_and", [_lam(p), _lam(out)])
        return out


class _Dy2StaticTransformer(ast.NodeTransformer):
    def __init__(self, filename="<dy2static>", line_base=0):
        self.counter = 0
        self.converted_any = False
        self.guarded = False
        self.filename = filename
        self.line_base = line_base

    # nested scopes keep their own control flow untouched by THIS pass
    def visit_FunctionDef(self, node):
        return node

    def visit_AsyncFunctionDef(self, node):
        return node

    def visit_ClassDef(self, node):
        return node

    def visit_Lambda(self, node):
        return node

    def _emit(self, names, defs, helper, k):
        prefix = f"__jst_v{k}_"
        stmts = list(defs)
        stmts += _guarded_reads(names, prefix)
        call = ast.Call(
            func=ast.Attribute(value=_load(_HELPER), attr=helper,
                               ctx=ast.Load()),
            args=[ast.Tuple(elts=[_load(f"{prefix}{i}")
                                  for i in range(len(names))],
                            ctx=ast.Load()),
                  ast.Tuple(elts=[ast.Constant(value=n) for n in names],
                            ctx=ast.Load())],
            keywords=[])
        return stmts, call

    def _guard_unconvertible(self, node):
        """Wrap the test of an unconvertible if/while so a TRACED
        predicate raises :class:`UnconvertibleControlFlowError` instead
        of a deep capture traceback. Concrete predicates keep exact
        Python semantics (the guard is identity for them)."""
        if getattr(node, "_jst_guard", False):
            return node      # generated flag-guard ifs are ours
        reasons = _scan_statement(node)
        if not reasons:
            return node
        node.test = ast.Call(
            func=ast.Attribute(value=_load(_HELPER),
                               attr="unconvertible_guard", ctx=ast.Load()),
            args=[node.test,
                  ast.Constant(value=tuple(
                      (c, self.line_base + ln) for c, ln in reasons)),
                  ast.Constant(value=self.filename),
                  ast.Constant(value=self.line_base + node.lineno)],
            keywords=[])
        ast.copy_location(node.test, node)
        self.guarded = True
        return node

    def visit_If(self, node):
        node = self.generic_visit(node)
        if not _convertible(node):
            return self._guard_unconvertible(node)
        node.test = _PredicateTransformer.transform(node.test)
        k = self.counter = self.counter + 1
        names = _assigned_names(node.body + node.orelse)
        tname, fname = f"__jst_t{k}", f"__jst_f{k}"
        defs = [
            _fn_def(tname, node.body, names, _carries_return(names)),
            _fn_def(fname, node.orelse, names, _carries_return(names)),
        ]
        stmts, call = self._emit(names, defs, "convert_ifelse", k)
        call.args = [node.test, _load(tname), _load(fname)] + call.args
        if getattr(node, "_jst_guard", False):
            call.keywords.append(ast.keyword(
                arg="guard", value=ast.Constant(value=True)))
        if names:
            stmts.append(ast.Assign(
                targets=[_names_tuple(names, ast.Store)], value=call))
        else:
            stmts.append(ast.Expr(value=call))
        self.converted_any = True
        return [ast.copy_location(s, node) for s in stmts]

    def visit_For(self, node):
        node = self.generic_visit(node)
        it = node.iter
        if (node.orelse or not isinstance(node.target, ast.Name)
                or not _convertible(node)):
            return node  # for-else / tuple-target / break-carrying: Python
        is_range = _is_range_call(it)
        target = node.target.id
        if target in _assigned_names(node.body):
            # a body that REBINDS the loop target has Python semantics the
            # threaded-target rewrite can't reproduce — leave it alone
            return node
        k = self.counter = self.counter + 1
        names = _assigned_names(node.body)
        bname, inner = f"__jst_fb{k}", f"__jst_inner{k}"
        body = [ast.Assign(
            targets=[ast.Tuple(elts=[_store(target), _store(inner)],
                               ctx=ast.Store())],
            value=_load(_VALS))]
        if names:
            body.append(ast.Assign(
                targets=[_names_tuple(names, ast.Store)],
                value=_load(inner)))
        body += node.body
        body.append(_carries_return(names))
        body_def = ast.FunctionDef(name=bname, args=_one_arg(), body=body,
                                   decorator_list=[], returns=None,
                                   type_params=[])
        prior = f"__jst_v{k}_prior"
        helper = "convert_for_range" if is_range else "convert_for_iter"
        stmts, call = self._emit(names, [body_def], helper, k)
        stmts += _guarded_reads([target], prior)       # -> __jst_vK_prior0
        head = (ast.Tuple(elts=list(it.args), ctx=ast.Load()) if is_range
                else it)
        call.args = [head, _load(bname)] + call.args \
            + [ast.Constant(value=target), _load(prior + "0")]
        out = f"__jst_out{k}"
        stmts.append(ast.Assign(
            targets=[ast.Tuple(elts=[_store(target), _store(out)],
                               ctx=ast.Store())],
            value=call))
        if names:
            stmts.append(ast.Assign(
                targets=[_names_tuple(names, ast.Store)],
                value=_load(out)))
        self.converted_any = True
        return [ast.copy_location(s, node) for s in stmts]

    def visit_While(self, node):
        reads = _read_first(node.body)
        node = self.generic_visit(node)
        if node.orelse or not _convertible(node):
            return self._guard_unconvertible(node)  # while/else: Python
        node.test = _PredicateTransformer.transform(node.test)
        k = self.counter = self.counter + 1
        names = _assigned_names(node.body)
        cname, bname = f"__jst_c{k}", f"__jst_b{k}"
        cond_def = ast.FunctionDef(
            name=cname, args=_one_arg(),
            body=([ast.Assign(targets=[_names_tuple(names, ast.Store)],
                              value=_load(_VALS))] if names else [])
            + [ast.Return(value=node.test)],
            decorator_list=[], returns=None, type_params=[])
        defs = [cond_def,
                _fn_def(bname, node.body, names, _carries_return(names))]
        stmts, call = self._emit(names, defs, "convert_while", k)
        call.args = [_load(cname), _load(bname)] + call.args
        read_carries = tuple(n for n in names if n in reads)
        if read_carries:
            call.keywords.append(ast.keyword(
                arg="reads", value=ast.Constant(value=read_carries)))
        if names:
            stmts.append(ast.Assign(
                targets=[_names_tuple(names, ast.Store)], value=call))
        else:
            stmts.append(ast.Expr(value=call))
        self.converted_any = True
        return [ast.copy_location(s, node) for s in stmts]


def _read_first(stmts):
    """The names ``stmts`` may read before they assign them, in source
    order (a branch counts as assigning what both of its arms assign; a
    loop body as assigning nothing after it)."""
    out = []

    def loads(node):
        return [n.id for n in ast.walk(node) if isinstance(n, ast.Name)
                and isinstance(n.ctx, ast.Load)]

    def note(names, written):
        out.extend(n for n in names if n not in written and n not in out)

    def walk(body, written):
        for s in body:
            if isinstance(s, _SCOPES):
                written.add(getattr(s, "name", ""))
            elif isinstance(s, ast.If):
                note(loads(s.test), written)
                written |= walk(s.body, set(written)) & walk(s.orelse,
                                                             set(written))
            elif isinstance(s, ast.While):
                note(loads(s.test), written)
                walk(s.body, set(written))
            elif isinstance(s, (ast.For, ast.AsyncFor)):
                note(loads(s.iter), written)
                walk(s.body, set(written) | set(_assigned_names(
                    [ast.Assign(targets=[s.target], value=s.iter)])))
            else:
                if isinstance(s, ast.AugAssign) and isinstance(s.target,
                                                               ast.Name):
                    note([s.target.id], written)
                note(loads(s), written)
                written |= set(_assigned_names([s]))
        return written

    walk(stmts, set())
    return out


_CONVERT_CACHE = {}

# modules whose callables are never user control-flow candidates: wrapping
# them through the converter would be pure per-call overhead
_SKIP_MODULE_PREFIXES = ("paddle_tpu_torch", "torch", "numpy", "builtins",
                        "functools", "itertools", "operator", "math")


def convert_call(fn):
    """Transitive conversion at CALL SITES (ref dy2static convert_call
    (U)): every call inside a converted function routes through here, so
    helper functions the user did NOT decorate still get their if/while/
    for staged. Framework/builtin callables, classes, Layer instances and
    anything unconvertible pass through untouched; results cache on the
    function object (and by code object inside convert_to_static), so the
    steady-state cost is one attribute lookup.

    Under a capture this is a lookup in :data:`_CALL_CACHE` alone (dynamo
    traces it; it cannot trace a conversion): a function converts when
    the function that calls it by name converts (:func:`_preconvert`),
    or at its first call outside a capture."""
    if torch.compiler.is_compiling():
        if isinstance(fn, types.FunctionType):
            return _CALL_CACHE.get(fn, fn)
        if isinstance(fn, types.MethodType):
            conv = _CALL_CACHE.get(fn.__func__)
            if conv is not None:
                return types.MethodType(conv, fn.__self__)
        return fn
    code = getattr(fn, "__code__", None)
    if code is None:
        return fn                   # builtins, classes, callables, Layers
    if isinstance(fn, types.MethodType):
        # BEFORE the cache: bound methods proxy attribute reads to their
        # __func__, so the plain-function cache entry would come back
        # unbound and the call would drop self — convert the underlying
        # function (its own cache applies) and rebind
        conv = convert_call(fn.__func__)
        if conv is fn.__func__:
            return fn
        return types.MethodType(conv, fn.__self__)
    cached = getattr(fn, "__dy2static_call_cache__", None)
    if cached is not None:
        return cached
    if getattr(fn, "__dy2static_converted__", False) \
            or getattr(fn, "_not_to_static", False):
        return fn
    mod = getattr(fn, "__module__", "") or ""
    if mod.split(".", 1)[0] in _SKIP_MODULE_PREFIXES:
        return fn
    conv = convert_to_static(fn)
    try:
        fn.__dy2static_call_cache__ = conv
    except (AttributeError, TypeError):
        pass                        # bound methods: code-id cache applies
    if inspect.isfunction(fn):
        _CALL_CACHE[fn] = conv
    return conv


#: function -> its conversion (itself when there is nothing to convert),
#: read by :func:`convert_call` under a capture
_CALL_CACHE = {}
_CONVERTING = set()


def _preconvert(names, namespaces):
    """Convert ahead the functions that a converted function calls by
    name (found in its closure or globals now), so that a capture finds
    them converted.  Recursion through a cycle stops at a function being
    converted."""
    for name in sorted(names):
        for ns in namespaces:
            if name in ns:
                obj = ns[name]
                if inspect.isfunction(obj) and obj not in _CALL_CACHE \
                        and obj not in _CONVERTING:
                    _CONVERTING.add(obj)
                    try:
                        convert_call(obj)
                    finally:
                        _CONVERTING.discard(obj)
                break


def preconvert_methods(obj):
    """Convert ahead the methods of ``obj``'s class (and its bases) that
    are defined outside the framework, so that ``self.method(...)`` calls
    inside a captured forward find them converted."""
    for klass in type(obj).__mro__:
        mod = (getattr(klass, "__module__", "") or "").split(".", 1)[0]
        if mod in _SKIP_MODULE_PREFIXES:
            continue
        for name, attr in vars(klass).items():
            if inspect.isfunction(attr) and not name.startswith("__") \
                    and attr not in _CALL_CACHE:
                _preconvert([name], [vars(klass)])


def convert_to_static(fn):
    """Return `fn` with its `if`/`while` statements rewritten to runtime
    control-flow dispatch, or `fn` unchanged when there is nothing to
    convert or the source is unavailable. Never raises: to_static must
    keep working on functions this lite converter can't parse. Bound
    methods convert through their underlying function and rebind."""
    if isinstance(fn, types.MethodType):
        conv = convert_to_static(fn.__func__)
        if conv is fn.__func__:
            return fn
        return types.MethodType(conv, fn.__self__)
    if getattr(fn, "_not_to_static", False) \
            or getattr(fn, "__dy2static_converted__", False):
        return fn
    code = getattr(fn, "__code__", None)
    # closure-bearing functions are NEVER cached: the conversion snapshots
    # cell contents into its namespace, and sibling closures share one
    # code object — a cache hit would serve the first sibling's values
    cacheable = code is not None and not fn.__closure__
    if cacheable and id(code) in _CONVERT_CACHE:
        ent = _CONVERT_CACHE[id(code)]
        if ent[0] is code:              # id-recycling guard
            return ent[1] or fn
    converted = _convert_uncached(fn)
    if cacheable:
        # keyed on the CODE OBJECT's id with an identity pin — only
        # concrete function objects reach this store, never tracers
        _CONVERT_CACHE[id(code)] = (code, converted)  # noqa: PTA402
    return converted or fn


def _convert_uncached(fn):
    if not inspect.isfunction(fn):
        return None
    if fn.__code__.co_flags & (inspect.CO_GENERATOR | inspect.CO_COROUTINE
                               | inspect.CO_ASYNC_GENERATOR):
        # yield/await make the return rewrite (and staging generally)
        # meaningless — leave generators and coroutines untouched
        return None
    if "__class__" in fn.__code__.co_freevars:
        # zero-arg super() needs the compiler-provided __class__ cell,
        # which a module-level recompile cannot reproduce — leave such
        # methods unconverted (concrete predicates keep working; traced
        # ones get the standard concretization error)
        return None
    try:
        src_lines, src_start = inspect.getsourcelines(fn)
        src = textwrap.dedent("".join(src_lines))
        tree = ast.parse(src)
    except (OSError, TypeError, SyntaxError, IndentationError):
        return None
    fdef = tree.body[0]
    if not isinstance(fdef, ast.FunctionDef):
        return None
    has_cf = any(isinstance(n, (ast.If, ast.While, ast.For))
                 for n in ast.walk(fdef))
    has_call = any(isinstance(n, ast.Call) for n in ast.walk(fdef))
    if not (has_cf or has_call):
        return None
    fdef.decorator_list = []       # re-applying the decorator would recurse
    # pass 1: early exits (return/break/continue) -> flag-guarded dataflow
    _EarlyExit().transform(fdef)
    try:
        srcfile = inspect.getsourcefile(fn) or "<dy2static>"
    except TypeError:
        srcfile = "<dy2static>"
    tf = _Dy2StaticTransformer(filename=srcfile, line_base=src_start - 1)
    # transform only the TOP function's statements; visit() on the module
    # would treat the def itself as a nested scope
    fdef.body = [s for stmt in fdef.body
                 for s in _as_list(tf.visit(stmt))]
    # pass 3: transitive conversion — user call sites route through
    # convert_call, so undecorated helpers stage too (a function with no
    # control flow of its own still converts for its call sites)
    ct = _CallTransformer()
    fdef.body = [ct.visit(s) for s in fdef.body]
    if not (tf.converted_any or ct.wrapped or tf.guarded):
        return None
    fdef.body = _undef_inits(fdef) + fdef.body
    ast.fix_missing_locations(tree)
    # closure cells: rebuild real cells by wrapping the converted def in a
    # factory whose parameters are the (bound) freevars — values snapshot
    # at conversion time (documented lite-scope trade-off), but the names
    # never leak into module globals. Empty cells (e.g. recursive defs)
    # stay out of the factory so those names fall through to live globals.
    cell_vals = {}
    if fn.__closure__:
        for name, cell in zip(fn.__code__.co_freevars, fn.__closure__):
            try:
                cell_vals[name] = cell.cell_contents
            except ValueError:          # empty cell (e.g. recursive def)
                pass
    factory_name = f"__jst_factory_{fn.__name__}"
    # the factory is also needed whenever the body references the
    # function's OWN name (self-recursion) — nested (freevar) or
    # module-level (global load): the def inside the factory rebinds the
    # name in factory scope, so the recursive call hits the CONVERTED
    # function, as the old snapshot-namespace exec did
    use_factory = (bool(cell_vals)
                   or fn.__name__ in fn.__code__.co_freevars
                   or fn.__name__ in fn.__code__.co_names)
    if use_factory:
        # the def itself rebinds fn.__name__ in the factory scope, so a
        # SELF-RECURSIVE nested function (own name = empty cell at
        # decoration time, excluded from the args) resolves to the
        # converted function — like the pre-factory exec namespace did
        factory = ast.FunctionDef(
            name=factory_name,
            args=ast.arguments(
                posonlyargs=[],
                args=[ast.arg(arg=n) for n in cell_vals],
                vararg=None, kwonlyargs=[], kw_defaults=[], kwarg=None,
                defaults=[]),
            body=[fdef, ast.Return(value=_load(fdef.name))],
            decorator_list=[], returns=None, type_params=[])
        tree.body[0] = factory
        ast.fix_missing_locations(tree)
    try:
        code = compile(tree, f"<dy2static {fn.__name__}>", "exec")
    except (SyntaxError, ValueError):
        return None
    import sys

    helper_mod = sys.modules[__name__]
    # exec with globals = the ORIGINAL fn.__globals__ (so the converted
    # function sees later-defined / rebound module globals live — it must
    # behave like the unconverted function) and a separate locals dict so
    # the def itself never clobbers the module's own bindings. Only the
    # collision-proof `__jst` helper name is injected into live globals;
    # if the module somehow defines `__jst` itself, fall back to an
    # isolated snapshot copy rather than clobbering it.
    glb = fn.__globals__
    if _HELPER in glb and glb[_HELPER] is not helper_mod:
        glb = dict(fn.__globals__)
    glb[_HELPER] = helper_mod
    local_ns = {}
    try:
        exec(code, glb, local_ns)
        if use_factory:
            new_fn = local_ns[factory_name](**cell_vals)
        else:
            new_fn = local_ns.get(fn.__name__)
    except Exception:
        return None
    if not inspect.isfunction(new_fn):
        return None
    new_fn.__defaults__ = fn.__defaults__
    new_fn.__kwdefaults__ = fn.__kwdefaults__
    functools.update_wrapper(new_fn, fn)
    new_fn.__dy2static_converted__ = True
    _preconvert(ct.names, [cell_vals, fn.__globals__])
    return new_fn


def _as_list(x):
    if x is None:
        return []
    return x if isinstance(x, list) else [x]
