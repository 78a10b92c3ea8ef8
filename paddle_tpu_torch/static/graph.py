"""Paddle's static-graph mode, the counterpart of
``paddle_tpu/static/graph.py``.

Under ``paddle.enable_static()`` ``static.data`` returns a
:class:`SymbolicTensor`: a ``torch.Tensor`` subclass with a shape, a
dtype and a device but no storage.  A ``TorchFunctionMode`` (pushed by
``enable_static``) sees every torch call of the thread and records one
graph node for each call that

* takes a symbolic tensor (anywhere in its arguments),
* or takes a tensor that requires grad while grad is enabled (a
  parameter's ``.t()``, the concatenated q/k/v weights of
  ``nn.MultiHeadAttention``: values the training step differentiates),
* or draws from a ``torch.Generator`` inside a named op (the mask of
  ``nn.functional.dropout``: each run draws anew from the generator the
  node holds, as Paddle draws anew per run),

and returns symbolic outputs.  Every other call runs eagerly, as JAX's
recorder leaves concrete ops alone.  A node holds the torch callable
(a tensor method, a ``torch`` function, a ``torch.ops`` overload such as
the kernels' ``paddle_tpu_torch::layer_norm_fwd``), its arguments with
symbolic values as references to their producers, trainable parameters
as live references (``_ParamRef``: the replay reads their current value)
and other tensors as constants.  Output shapes come from running the
call under ``FakeTensorMode`` (JAX's ``jax.eval_shape``), so no kernel
launches and no counter counts at record time.  A node is named by the
Paddle op it belongs to: the innermost live ``amp.cast_inputs(op_name,
...)`` call on the stack (each functional of the port names itself
there), else the torch callable's name; the static AMP rewrite reads it.

Reading a symbolic tensor on the host (``item``, ``bool``, ``int``,
``float``, ``len``, iteration, ``numpy``, ``tolist``) raises
:class:`StaticGraphError`, and so does any op on one outside recording.

:class:`Executor` replays the recorded graph eagerly, through the same
kernels as eager code, in a plan (the reachable nodes in post-order,
each intermediate released after its last use) cached under JAX's
structural key of the fetched subgraph, LRU-bounded at 64: a rebuilt,
structurally identical program reuses the plan with its own parameters
by position.  With ``Optimizer.minimize`` (or fetched ``append_backward``
gradients) a run replays with the parameters as leaves, takes
``torch.autograd.grad`` of the loss and applies the optimizer's own
update (clip, regularizer, learning rate, as ``Optimizer.step``), so a
static step equals an eager step bit for bit.  The static
meta-optimizer's hooks (``distributed/fleet/meta_optimizers``) act here:
fp16 loss scaling, recompute checkpoints (``torch.utils.checkpoint``
over each segment) and gradient merge.  The mesh paths of JAX's
``_run_train`` (static dp, mp and ZeRO-1) are not ported.

A value that a function computes from ``x.shape`` at build time (a
reshape to ``[b, s, ...]``) keeps the build's size, as in JAX: a
``None`` dim of ``static.data`` stands in as 1 at build.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import importlib
import sys

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree

from ..core import _int64_off, _x64_off
from ..device import resolve_device
from ..dtype import to_torch_dtype


class StaticGraphError(RuntimeError):
    pass


def _concrete_needed(what):
    raise StaticGraphError(
        f"{what} needs concrete data, but this Tensor is symbolic (inside a "
        "static Program). Run it through Executor.run.")


class _Ref:
    """A recorded input that is symbolic: output ``idx`` of ``node``, or
    the feed ``feed``."""

    __slots__ = ("node", "idx", "feed", "prog")

    def __init__(self, node=None, idx=0, feed=None, prog=None):
        self.node, self.idx, self.feed, self.prog = node, idx, feed, prog


class _ParamRef:
    """A trainable tensor captured by the graph, kept live: a run reads
    its current value and the training path differentiates it."""

    __slots__ = ("t",)

    def __init__(self, t):
        self.t = t


class SymbolicTensor(torch.Tensor):
    """A value of a static Program: the shape, dtype and device of
    ``fake`` (a ``FakeTensor``), made by output ``out_idx`` of ``node``
    or fed as ``feed_name``.  Holds no storage."""

    @staticmethod
    def __new__(cls, fake, node=None, out_idx=0, feed_name=None):
        t = torch.Tensor._make_wrapper_subclass(
            cls, fake.shape, strides=fake.stride(), dtype=fake.dtype,
            device=fake.device, requires_grad=False)
        t._fake = fake
        t._node = node
        t._out_idx = out_idx
        t._feed_name = feed_name
        t._orig_shape = None
        t._program = None
        t._grad_of = None          # (loss ref, param) of append_backward
        t.__dict__["_sym_name"] = None
        return t

    def __init__(self, *args, **kwargs):
        pass

    __torch_function__ = torch._C._disabled_torch_function_impl

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise StaticGraphError(
            f"{func} reached a symbolic tensor outside static recording "
            "(build under paddle.enable_static(), run through "
            "Executor.run)")

    def _ref(self):
        return _Ref(self._node, self._out_idx, self._feed_name,
                    self._program)

    @property
    def name(self):
        return self.__dict__.get("_sym_name")

    @name.setter
    def name(self, value):
        self.__dict__["_sym_name"] = value

    def __repr__(self, *args, **kwargs):
        src = self._feed_name or (self._node.op_name if self._node
                                  else "?")
        return (f"SymbolicTensor({list(self.shape)}, {self.dtype}, "
                f"from={src})")

    def __format__(self, spec):
        if spec:
            _concrete_needed("__format__")
        return repr(self)

    def __hash__(self):
        return id(self)

    def __deepcopy__(self, memo):
        return self           # a graph value: immutable, shared

    def __reduce_ex__(self, proto):
        _concrete_needed("pickling")

    def item(self):
        _concrete_needed("item")

    def tolist(self):
        _concrete_needed("tolist")

    def numpy(self, *args, **kwargs):
        _concrete_needed("numpy")

    def __array__(self, *args, **kwargs):
        _concrete_needed("__array__")

    def __bool__(self):
        _concrete_needed("__bool__")

    def __int__(self):
        _concrete_needed("__int__")

    def __float__(self):
        _concrete_needed("__float__")

    def __complex__(self):
        _concrete_needed("__complex__")

    def __index__(self):
        _concrete_needed("__index__")

    def __len__(self):
        _concrete_needed("__len__")

    def __iter__(self):
        _concrete_needed("__iter__")


def is_symbolic(x):
    return isinstance(x, SymbolicTensor)


class _Node:
    """One recorded call: ``fn(*args, **kwargs)`` with the leaves of
    (args, kwargs) in ``leaves`` (refs, param refs or constants) and
    their structure in ``spec``; ``n_out`` tensor outputs, whose fakes
    are ``out_fakes``."""

    __slots__ = ("fn", "leaves", "spec", "n_args", "kw_keys", "n_out",
                 "op_name", "out_fakes", "grad_mode", "inplace")

    def __init__(self, fn, leaves, spec, n_args, kw_keys, op_name,
                 grad_mode, inplace):
        self.fn = fn
        self.leaves = leaves
        self.spec = spec
        self.n_args = n_args          # flat call: positional leaf count
        self.kw_keys = kw_keys        # flat call: keyword names, else None
        self.op_name = op_name
        self.grad_mode = grad_mode
        self.inplace = inplace
        self.n_out = 0
        self.out_fakes = ()

    def call(self, vals):
        """Run ``fn`` on the resolved leaves -> its tensor outputs."""
        if self.kw_keys is not None:
            args = vals[:self.n_args]
            kwargs = dict(zip(self.kw_keys, vals[self.n_args:]))
        else:
            args, kwargs = pytree.tree_unflatten(vals, self.spec)
        if self.inplace:
            args = list(args)
            args[0] = args[0].clone()
        if self.grad_mode or not torch.is_grad_enabled():
            out = self.fn(*args, **kwargs)
        else:
            with torch.no_grad():
                out = self.fn(*args, **kwargs)
        if self.inplace and not isinstance(out, torch.Tensor):
            out = args[0]
        return [o for o in pytree.tree_leaves(out)
                if isinstance(o, torch.Tensor)]


class Program:
    """The placeholders made under its guard and the nodes recorded
    while it was the main program (the graph itself is the web of nodes
    reachable from the fetched values)."""

    def __init__(self):
        self.placeholders = {}
        self.nodes = []
        self._train_op = None
        self._recompute_checkpoints = None

    def global_block(self):
        return self

    @property
    def vars(self):
        return dict(self.placeholders)

    def clone(self, for_test=False):
        """With ``for_test``: the same graph without the training op (an
        Executor run of the clone steps no optimizer)."""
        if for_test and self._train_op is not None:
            c = Program()
            c.placeholders = dict(self.placeholders)
            c.nodes = list(self.nodes)
            return c
        return self


_state = {"static": False, "main": Program(), "startup": Program(),
          "mode": None, "fake": None}
#: (frame, op name) of the live ``amp.cast_inputs`` calls, innermost last
_scopes = []


def _fake_mode():
    if _state["fake"] is None:
        from torch._subclasses.fake_tensor import FakeTensorMode

        _state["fake"] = FakeTensorMode(allow_non_fake_inputs=True)
    return _state["fake"]


def name_op(op_name, frame):
    """Name the nodes that ``frame`` records from now on ``op_name``
    (called by ``amp.cast_inputs`` while static mode is on)."""
    if _scopes and _scopes[-1][0] is frame:
        _scopes[-1] = (frame, op_name)
    else:
        _scopes.append((frame, op_name))


def _op_scope():
    """The op name of the innermost live ``cast_inputs`` call, or None."""
    if not _scopes:
        return None
    live = set()
    f = sys._getframe(1)
    while f is not None:
        live.add(id(f))
        f = f.f_back
    while _scopes and id(_scopes[-1][0]) not in live:
        _scopes.pop()
    return _scopes[-1][1] if _scopes else None


_REFLECTED = {"radd", "rsub", "rmul", "rtruediv", "rfloordiv", "rpow",
              "rmatmul", "rmod", "rand", "ror", "rxor"}


def _torch_op_name(func):
    n = getattr(func, "__name__", None) or type(func).__name__
    if n == "__get__":            # a property: its name (``T``, ``mT``)
        n = getattr(getattr(func, "__self__", None), "__name__", n)
    n = n.split(".")[0]
    if n.startswith("__") and n.endswith("__"):
        n = n[2:-2]
        if n in _REFLECTED:
            n = n[1:]
        elif n.startswith("i") and n[1:] in (
                "add", "sub", "mul", "truediv", "floordiv", "pow", "matmul",
                "mod", "and", "or", "xor"):
            n = n[1:]
    elif n.endswith("_") and not n.startswith("_"):
        n = n[:-1]
    return n


def _meta_funcs():
    """The torch callables that read a tensor's metadata (or detach it):
    never recorded, they answer from the symbolic tensor's shape, dtype
    and device."""
    T = torch.Tensor
    getters = ("shape", "dtype", "device", "ndim", "is_cuda", "is_cpu",
               "requires_grad", "is_leaf", "grad_fn", "layout",
               "is_sparse", "is_quantized", "is_meta", "is_mkldnn",
               "names", "grad", "is_nested", "itemsize", "nbytes",
               "output_nr", "_version", "_base", "data")
    methods = ("size", "dim", "numel", "nelement", "stride",
               "is_contiguous", "is_floating_point", "is_complex",
               "element_size", "get_device", "requires_grad_", "is_signed",
               "__hash__", "storage_offset", "retain_grad", "register_hook",
               "__reduce_ex__", "__deepcopy__", "__repr__", "__format__",
               "__setstate__")
    out = {getattr(T, g).__get__ for g in getters if hasattr(T, g)}
    out |= {getattr(T, m) for m in methods if hasattr(T, m)}
    out |= {torch.is_tensor, torch.is_floating_point, torch.is_complex,
            torch.numel, torch.is_grad_enabled}
    return out


_META = None
#: never recorded for the grad they take, but recorded on a symbolic
#: tensor (a replay detaches too)
_DETACH = {torch.Tensor.detach, torch.Tensor.detach_}
_INPLACE_DUNDER = {"__setitem__", "__iadd__", "__isub__", "__imul__",
                   "__itruediv__", "__ifloordiv__", "__ipow__",
                   "__imatmul__", "__imod__", "__iand__", "__ior__",
                   "__ixor__", "__ilshift__", "__irshift__"}


def _is_inplace(func):
    n = getattr(func, "__name__", "")
    if n in _INPLACE_DUNDER:
        return True
    return n.endswith("_") and not n.startswith("_") and \
        isinstance(func, type(torch.Tensor.add_))


class _Recorder(TorchFunctionMode):
    """The torch-function mode of static mode (see the module
    docstring)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _META:
            if func is torch.Tensor.requires_grad_ and \
                    isinstance(args[0], SymbolicTensor):
                return args[0]      # a graph value takes no grad of its own
            return func(*args, **kwargs)
        if func in _DETACH:
            if isinstance(args[0], SymbolicTensor):
                return _record(torch.Tensor.detach, args, kwargs)
            return func(*args, **kwargs)
        leaves = pytree.tree_leaves((args, kwargs))
        sym = grad_in = gen = False
        for a in leaves:
            if isinstance(a, SymbolicTensor):
                sym = True
                break
            if isinstance(a, torch.Tensor):
                grad_in = grad_in or a.requires_grad
            elif isinstance(a, torch.Generator):
                gen = True
        if sym or (grad_in and torch.is_grad_enabled()
                   and not _is_inplace(func)) or (gen and _op_scope()):
            return _record(func, args, kwargs)
        return func(*args, **kwargs)


def _record(func, args, kwargs, op_name=None, meta=None):
    """Record ``func(*args, **kwargs)`` as a node of the main program ->
    its result with every tensor symbolic.  ``meta`` (a function of the
    fake arguments) replaces running ``func`` on fakes."""
    name = op_name or _op_scope() or _torch_op_name(func)
    if kwargs.get("out") is not None:
        raise StaticGraphError(f"op {name!r}: out= cannot be recorded")
    inplace = _is_inplace(func)
    if inplace and not isinstance(args[0], SymbolicTensor):
        raise StaticGraphError(
            f"in-place op {name!r} on a concrete tensor with a symbolic "
            "argument cannot be recorded (write it out of place)")
    fm = _fake_mode()
    flat, spec = pytree.tree_flatten((tuple(args), dict(kwargs)))
    refs, fakes = [], []
    for a in flat:
        if isinstance(a, SymbolicTensor):
            refs.append(a._ref())
            fakes.append(a._fake)
        elif isinstance(a, torch.Tensor):
            if a.requires_grad and a.is_leaf:
                refs.append(_ParamRef(a))
            else:
                a = a.detach()
                refs.append(a)
            fakes.append(fm.from_tensor(a))
        else:
            refs.append(a)
            fakes.append(a)
    fargs, fkwargs = pytree.tree_unflatten(fakes, spec)
    try:
        with fm, torch.no_grad():
            if inplace:
                fargs = (fargs[0].clone(),) + tuple(fargs[1:])
            if meta is not None:
                out = meta(*fargs, **fkwargs)
            else:
                out = func(*fargs, **fkwargs)
                if inplace and not isinstance(out, torch.Tensor):
                    out = fargs[0]
    except StaticGraphError:
        raise
    except Exception as e:
        raise StaticGraphError(
            f"op {name!r} cannot be staged into the static program: "
            f"{type(e).__name__}: {e}") from e
    n_args = len(args)
    flat_call = all(not isinstance(a, (list, tuple, dict)) for a in args) \
        and all(not isinstance(v, (list, tuple, dict))
                for v in kwargs.values())
    node = _Node(func, refs, spec, n_args,
                 tuple(kwargs) if flat_call else None, name,
                 torch.is_grad_enabled(), inplace)
    outs = []

    def wrap(o):
        if isinstance(o, torch.Tensor):
            outs.append(o)
            return SymbolicTensor(o, node, len(outs) - 1)
        return o

    result = pytree.tree_map(wrap, out)
    node.n_out = len(outs)
    node.out_fakes = tuple(outs)
    _state["main"].nodes.append(node)
    if inplace:
        self = args[0]
        self._node, self._out_idx, self._fake = node, 0, outs[0]
        return self if isinstance(out, torch.Tensor) and \
            func.__name__ != "__setitem__" else None
    return result


def record_call(fn, args, op_name, meta):
    """Record ``fn(*args)`` as one node named ``op_name`` whose outputs'
    fakes ``meta(*fake_args)`` gives (``static.nn.while_loop``)."""
    return _record(fn, tuple(args), {}, op_name=op_name, meta=meta)


@contextlib.contextmanager
def concrete():
    """Inside the block torch calls run eagerly (the recorder's mode is
    off): an Executor run, an export, a parameter's initial value."""
    mode = _state["mode"]
    if mode is None:
        yield
        return
    popped = []
    while torch._C._len_torch_function_stack() > 0:
        m = torch._C._pop_torch_function_stack()
        popped.append(m)
        if m is mode:
            break
    try:
        yield
    finally:
        for m in reversed(popped):
            torch._C._push_on_torch_function_stack(m)


def enable_static():
    global _META
    if _state["static"]:
        return
    if _META is None:
        _META = _meta_funcs()
    auto_cast = importlib.import_module("..amp.auto_cast", __package__)
    _state["static"] = True
    mode = _Recorder()
    mode.__enter__()
    _state["mode"] = mode
    auto_cast._static_namer = name_op


def disable_static():
    if not _state["static"]:
        return
    auto_cast = importlib.import_module("..amp.auto_cast", __package__)
    mode = _state["mode"]
    popped = []
    while torch._C._len_torch_function_stack() > 0:
        m = torch._C._pop_torch_function_stack()
        if m is mode:
            break
        popped.append(m)
    for m in reversed(popped):
        torch._C._push_on_torch_function_stack(m)
    _state["static"] = False
    _state["mode"] = None
    auto_cast._static_namer = None
    _scopes.clear()


def in_static_mode():
    return _state["static"]


def default_main_program():
    return _state["main"]


def default_startup_program():
    return _state["startup"]


class program_guard:
    def __init__(self, main_program, startup_program=None):
        self._main = main_program
        self._startup = startup_program or Program()

    def __enter__(self):
        self._saved = (_state["main"], _state["startup"])
        _state["main"], _state["startup"] = self._main, self._startup
        return self

    def __exit__(self, *exc):
        _state["main"], _state["startup"] = self._saved
        return False


def data(name, shape, dtype="float32", lod_level=0):
    """A placeholder of the main program (``static.data``) on the current
    device (``set_device``).  A None or -1 dim stands in as 1 at build;
    a run takes any size there unless a recorded function read it."""
    if not _state["static"]:
        raise StaticGraphError("static.data requires paddle.enable_static()")
    dt = _int64_off(to_torch_dtype(dtype))
    norm = [1 if (s is None or s < 0) else int(s) for s in shape]
    with concrete(), _fake_mode():
        fake = torch.empty(norm, dtype=dt, device=resolve_device(None))
    t = SymbolicTensor(fake, feed_name=name)
    t._orig_shape = tuple(None if (s is None or s < 0) else int(s)
                          for s in shape)
    t._program = _state["main"]
    t.name = name
    _state["main"].placeholders[name] = t
    return t


# ---------------------------------------------------------------- walks


def _producers(node):
    return [r.node for r in node.leaves
            if isinstance(r, _Ref) and r.node is not None]


def _post_order(roots, stop=()):
    """Every node reachable from ``roots`` (nodes), dependencies first,
    iteratively (a chain deeper than the recursion limit walks); nodes
    in ``stop`` (ids) are leaves, not expanded or listed."""
    order, seen = [], set(stop)
    for root in roots:
        if root is None or id(root) in seen:
            continue
        stack = [(root, False)]
        while stack:
            n, done = stack.pop()
            if done:
                order.append(n)
                continue
            if id(n) in seen:
                continue
            seen.add(id(n))
            stack.append((n, True))
            for p in reversed(_producers(n)):
                if id(p) not in seen:
                    stack.append((p, False))
    return order


def _param_only(node, memo):
    """Whether ``node`` reads no feed (its value follows from the
    parameters and constants alone: a weight's ``.t()``)."""
    r = memo.get(id(node))
    if r is not None:
        return r
    ok = True
    stack, seen = [node], set()
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        for x in n.leaves:
            if isinstance(x, _Ref):
                if x.feed is not None:
                    ok = False
                    break
                if x.node is not None:
                    stack.append(x.node)
        if not ok:
            break
    memo[id(node)] = ok
    return ok


def _collect_params(refs):
    """The trainable parameters the graph under ``refs`` reads, in the
    order of JAX's ``_collect_params`` (``graph.py:414-432``): a
    last-in-first-out walk from the fetched values over each node's
    inputs in order, where a value computed from parameters alone (a
    weight's transpose) stands for those parameters in place."""
    seen_nodes, params, seen_p, only = set(), [], set(), {}
    stack = [r.node for r in refs if r.node is not None]

    def take(x, stack):
        if isinstance(x, _ParamRef):
            if id(x.t) not in seen_p:
                seen_p.add(id(x.t))
                params.append(x.t)
        elif isinstance(x, _Ref) and x.node is not None:
            if _param_only(x.node, only):
                for y in x.node.leaves:
                    take(y, stack)
            else:
                stack.append(x.node)

    while stack:
        n = stack.pop()
        if id(n) in seen_nodes:
            continue
        seen_nodes.add(id(n))
        for x in n.leaves:
            take(x, stack)
    return params


def parameters_of(fetch_list):
    """The trainable parameters the graph of ``fetch_list`` (symbolic
    tensors) reads, in JAX's order: a ``static.nn.fc`` program's weights
    pair with the JAX program's ``_collect_params`` one for one."""
    return _collect_params([t._ref() for t in fetch_list])


# ------------------------------------------------------------ signature

_digest_memo = collections.OrderedDict()
_DIGEST_MEMO_SIZE = 512


def _content_digest(t):
    """A digest of a constant tensor's bytes, memoized per (tensor,
    version): an in-place write changes the version."""
    key = id(t)
    ent = _digest_memo.get(key)
    if ent is not None and ent[0] is t and ent[1] == t._version:
        _digest_memo.move_to_end(key)
        return ent[2]
    a = t.detach().cpu()
    if a.dtype == torch.bfloat16:
        a = a.view(torch.int16)
    d = hashlib.sha1(a.contiguous().numpy().tobytes()).hexdigest()[:16]
    _digest_memo[key] = (t, t._version, d)
    if len(_digest_memo) > _DIGEST_MEMO_SIZE:
        _digest_memo.popitem(last=False)
    return d


def _describe_value(x, params_pos, pins):
    """A stable structural descriptor of a node's constant input (JAX's
    ``_describe_value``): tensors by content, Python values by value,
    other objects by identity (pinned by the cache entry)."""
    if isinstance(x, _ParamRef):
        return ("param", params_pos[id(x.t)], tuple(x.t.shape),
                str(x.t.dtype))
    if isinstance(x, (bool, int, float, str, bytes, type(None),
                      torch.dtype, torch.device, torch.Size, slice,
                      type(Ellipsis), torch.layout, torch.memory_format)):
        return ("py", type(x).__name__, repr(x))
    if isinstance(x, (tuple, list)):
        return (type(x).__name__,) + tuple(
            _describe_value(v, params_pos, pins) for v in x)
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), str(x.dtype), str(x.device),
                _content_digest(x))
    if isinstance(x, np.ndarray):
        return ("arr", x.shape, str(x.dtype),
                hashlib.sha1(x.tobytes()).hexdigest()[:16])
    pins.append(x)
    return ("obj", type(x).__name__, id(x))


def _describe_fn(fn, params_pos, pins):
    code = getattr(fn, "__code__", None)
    if code is None:
        try:
            hash(fn)
            return ("fn", fn)
        except TypeError:
            pins.append(fn)
            return ("obj", id(fn))
    pins.append(code)
    cells = getattr(fn, "__closure__", None) or ()
    return ("code", id(code), tuple(
        _describe_value(c.cell_contents, params_pos, pins) for c in cells))


def _program_signature(refs, stop=()):
    """(structural key, params, nodes in order, pins) of the subgraph
    under ``refs``: nodes keyed by op name, callable, constants and
    wiring (JAX's ``_program_signature``), params in first-use order."""
    nodes = _post_order([r.node for r in refs if r.node is not None], stop)
    pos = {id(n): i for i, n in enumerate(nodes)}
    params, params_pos, pins = [], {}, []
    for n in nodes:
        for x in n.leaves:
            if isinstance(x, _ParamRef) and id(x.t) not in params_pos:
                params_pos[id(x.t)] = len(params)
                params.append(x.t)

    def describe_input(x):
        if isinstance(x, _Ref):
            if x.feed is not None:
                return ("feed", x.feed)
            return ("sym", pos.get(id(x.node), -1), x.idx)
        return _describe_value(x, params_pos, pins)

    keys = []
    for n in nodes:
        keys.append((n.op_name, _describe_fn(n.fn, params_pos, pins),
                     str(n.spec), n.n_out, n.grad_mode, n.inplace,
                     tuple(describe_input(x) for x in n.leaves)))

    def describe_fetch(r):
        if r.feed is not None:
            return ("feed", r.feed)
        return ("sym", pos[id(r.node)], r.idx)

    key = (tuple(keys), tuple(describe_fetch(r) for r in refs))
    return key, params, nodes, pins


# ------------------------------------------------------------- replay


class _Plan:
    """The replay of ``nodes`` (in order): each node's inputs resolved
    from the memo, the feeds, the parameters (by position in
    ``params``) or its constants; each value released after its last
    reader unless kept (fetched, or in ``keep``)."""

    def __init__(self, nodes, params, keep_ids=()):
        self.nodes = nodes
        ppos = {id(p): i for i, p in enumerate(params)}
        last = {}
        for i, n in enumerate(nodes):
            for x in n.leaves:
                if isinstance(x, _Ref) and x.node is not None:
                    last[id(x.node)] = i
        keep = set(keep_ids)
        free = [[] for _ in nodes]
        for nid, i in last.items():
            if nid not in keep:
                free[i].append(nid)
        self.steps = []
        for i, n in enumerate(nodes):
            code = []
            for x in n.leaves:
                if isinstance(x, _Ref):
                    if x.feed is not None:
                        code.append((2, x.feed, 0))
                    else:
                        code.append((1, id(x.node), x.idx))
                elif isinstance(x, _ParamRef):
                    code.append((3, ppos[id(x.t)], 0))
                else:
                    code.append((0, x, 0))
            self.steps.append((n, code, free[i]))

    def run(self, memo, feeds, params):
        for n, code, free in self.steps:
            vals = []
            for kind, a, b in code:
                if kind == 0:
                    vals.append(a)
                elif kind == 1:
                    vals.append(memo[a][b])
                elif kind == 3:
                    vals.append(params[a])
                else:
                    try:
                        vals.append(feeds[a])
                    except KeyError:
                        raise StaticGraphError(
                            f"missing feed for placeholder {a!r}") from None
            memo[id(n)] = n.call(vals)
            for nid in free:
                del memo[nid]
        return memo


def _fetch(ref, memo, feeds):
    if ref.feed is not None:
        try:
            return feeds[ref.feed]
        except KeyError:
            raise StaticGraphError(
                f"missing feed for placeholder {ref.feed!r}") from None
    return memo[id(ref.node)][ref.idx]


# ------------------------------------------------------------- backward


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None):
    """``static.append_backward``: [(param, grad)] pairs whose grads are
    fetchable symbolic tensors; ``Executor.run`` computes them with one
    ``torch.autograd.grad`` over the replay."""
    if not is_symbolic(loss):
        raise StaticGraphError("append_backward expects a static loss Tensor")
    if tuple(loss.shape) not in ((), (1,)):
        raise StaticGraphError(f"append_backward: loss must be a scalar, "
                               f"got shape {tuple(loss.shape)}")
    params = list(parameter_list) if parameter_list \
        else _collect_params([loss._ref()])
    if no_grad_set:
        frozen_ids = {id(t) for t in no_grad_set
                      if isinstance(t, torch.Tensor)}
        frozen_names = {t for t in no_grad_set if isinstance(t, str)}
        params = [p for p in params if id(p) not in frozen_ids
                  and (getattr(p, "name", None) or "") not in frozen_names]
        if not params:
            raise StaticGraphError(
                "append_backward: no_grad_set excludes every parameter")
    pairs = []
    for p in params:
        with concrete(), _fake_mode():
            fake = torch.empty(p.shape, dtype=p.dtype, device=p.device)
        g = SymbolicTensor(fake)
        g._grad_of = (loss._ref(), p)
        pairs.append((p, g))
    return pairs


def register_minimize(optimizer, loss, parameters=None, no_grad_set=None):
    """``Optimizer.minimize`` in static mode: the (loss, optimizer) pair
    on the program the loss was recorded under; each Executor run of it
    steps the optimizer.  -> (None, params_grads)."""
    if not is_symbolic(loss):
        raise StaticGraphError("minimize expects a static loss Tensor")
    pairs = append_backward(loss, parameter_list=parameters,
                            no_grad_set=no_grad_set)
    params = [p for p, _ in pairs]
    if not params:
        raise StaticGraphError(
            "minimize: no trainable parameters reachable from the loss")
    if optimizer._parameter_list is None:
        for i, p in enumerate(params):
            if p.device != optimizer.device:
                raise ValueError(f"parameter {i} lives on {p.device}, the "
                                 f"optimizer on {optimizer.device}")
        optimizer._parameter_list = params
        for i, p in enumerate(params):
            optimizer._param_names[id(p)] = \
                getattr(p, "name", None) or f"param_{i}"
    program_of(loss)._train_op = (loss, optimizer)
    return None, pairs


def program_of(t):
    """The Program whose placeholders feed ``t``'s graph (the main
    program when none does)."""
    seen, refs = set(), [t._ref()]
    while refs:
        r = refs.pop()
        if r.feed is not None:
            if r.prog is not None:
                return r.prog
            continue
        if r.node is None or id(r.node) in seen:
            continue
        seen.add(id(r.node))
        refs.extend(x for x in r.node.leaves if isinstance(x, _Ref))
    return _state["main"]


def _scaler_next(state, finite, cfg):
    """Dynamic loss-scale bookkeeping (JAX's ``_scaler_next``): grow the
    scale after ``incr_every_n_steps`` finite steps in a row, shrink it
    after ``decr_every_n_nan_or_inf`` non-finite ones; on the device."""
    if not cfg.get("use_dynamic_loss_scaling", True):
        return state
    found = ~finite
    good = torch.where(found, 0, state["good"] + 1).to(torch.int32)
    bad = torch.where(found, state["bad"] + 1, 0).to(torch.int32)
    grow = good >= int(cfg.get("incr_every_n_steps", 1000))
    shrink = bad >= int(cfg.get("decr_every_n_nan_or_inf", 2))
    scale = torch.where(
        shrink, state["scale"] * float(cfg.get("decr_ratio", 0.5)),
        torch.where(grow, state["scale"] * float(cfg.get("incr_ratio", 2.0)),
                    state["scale"]))
    return {"scale": scale,
            "good": torch.where(grow, 0, good).to(torch.int32),
            "bad": torch.where(shrink, 0, bad).to(torch.int32)}


# ------------------------------------------------------------- executor


def _to_numpy(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


class Executor:
    """``static.Executor``: runs the fetched subgraph of a Program on
    ``place`` (default: the device of ``set_device``, else the card).
    Forward runs reuse a replay plan per structural key, training runs
    one per (program, loss, optimizer, fetches), in one LRU cache of
    ``CACHE_SIZE`` entries."""

    CACHE_SIZE = 64

    def __init__(self, place=None):
        self.place = place
        self.device = resolve_device(place)
        self._cache = collections.OrderedDict()
        self._front = collections.OrderedDict()

    def _lru_put(self, cache, key, value):
        cache[key] = value
        if len(cache) > self.CACHE_SIZE:
            cache.popitem(last=False)
        return value

    def _signature(self, refs):
        """(key, params, nodes, pins), memoized per fetched objects."""
        fkey = tuple((id(r.node), r.idx, r.feed) for r in refs)
        ent = self._front.get(fkey)
        if ent is not None and all(a is b.node for a, b in zip(ent[0],
                                                                 refs)):
            self._front.move_to_end(fkey)
            return ent[1]
        sig = _program_signature(refs)
        self._lru_put(self._front, fkey, ([r.node for r in refs], sig))
        return sig

    def _feeds(self, prog, feed):
        out = {}
        for name, v in feed.items():
            ph = prog.placeholders.get(name)
            dt = ph.dtype if ph is not None else None
            if isinstance(v, torch.Tensor):
                t = v.detach().to(self.device)
            else:
                a = np.asarray(v)
                t = torch.as_tensor(a, device=self.device)
                if dt is None:
                    dt = _x64_off(t.dtype)
            if dt is not None and t.dtype != dt:
                t = t.to(dt)
            out[name] = t
        return out

    def run(self, program=None, feed=None, fetch_list=None,
            return_numpy=True):
        prog = program if program is not None else _state["main"]
        fetch_list = list(fetch_list or [])
        for f in fetch_list:
            if not is_symbolic(f):
                raise StaticGraphError(
                    "fetch_list entries must be static-program Tensors")
        with concrete():
            feeds = self._feeds(prog, feed or {})
            train_op = getattr(prog, "_train_op", None)
            grads = [f for f in fetch_list if f._grad_of is not None]
            if train_op is not None or grads:
                outs = self._run_train(prog, train_op, fetch_list, grads,
                                       feeds)
            else:
                outs = self._run_forward(fetch_list, feeds)
            if return_numpy:
                return [_to_numpy(o) for o in outs]
            return [o.detach() for o in outs]

    def _run_forward(self, fetch_list, feeds):
        refs = [f._ref() for f in fetch_list]
        key, params, nodes, pins = self._signature(refs)
        ck = (key, tuple(sorted(feeds)))
        ent = self._cache.get(ck)
        if ent is None:
            plan = _Plan(nodes, params, keep_ids=[
                id(r.node) for r in refs if r.node is not None])
            ent = self._lru_put(self._cache, ck, (plan, refs, pins))
        else:
            self._cache.move_to_end(ck)
        plan, plan_refs, _ = ent
        with torch.no_grad():
            memo = plan.run({}, feeds, params)
        return [_fetch(r, memo, feeds) for r in plan_refs]

    def _train_plan(self, prog, loss_ref, fwd_refs, opt):
        """The training replay of this program, cached by identity: the
        recompute segments (checkpoint nodes in graph order) and the
        plan from them to the loss and the fetches."""
        cks = list(getattr(prog, "_recompute_checkpoints", None) or ())
        key = ("train", id(prog), id(loss_ref.node), id(opt),
               tuple(id(c) for c in cks),
               tuple((id(r.node), r.idx, r.feed) for r in fwd_refs))
        ent = self._cache.get(key)
        if ent is not None:
            self._cache.move_to_end(key)
            return ent
        order = {id(n): i for i, n in enumerate(
            _post_order([loss_ref.node]))}
        ck_nodes, seen = [], set()
        for c in cks:
            r = c._ref()
            if r.feed is not None:
                continue             # a feed is live anyway
            if r.node is None or id(r.node) not in order:
                raise StaticGraphError(
                    "recompute checkpoint is not reachable from the loss "
                    "of this program")
            if id(r.node) not in seen:
                seen.add(id(r.node))
                ck_nodes.append(r.node)
        ck_nodes.sort(key=lambda n: order[id(n)])
        params = (list(opt._parameter_list) if opt is not None
                  else _collect_params([loss_ref]))
        segs, stop = [], []
        for n in ck_nodes:
            nodes = _post_order([n], stop)
            segs.append((n, tuple(stop),
                         _Plan(nodes, params, keep_ids=[id(n)] + stop)))
            stop = stop + [id(n)]
        refs = [loss_ref] + list(fwd_refs)
        nodes = _post_order([r.node for r in refs if r.node is not None],
                            stop)
        main = _Plan(nodes, params, keep_ids=[
            id(r.node) for r in refs if r.node is not None] + stop)
        ent = (params, segs, main, (prog, loss_ref, cks, fwd_refs))
        return self._lru_put(self._cache, key, ent)

    def _run_train(self, prog, train_op, fetch_list, grad_fetch, feeds):
        """One step over the recorded graph: replay with the parameters
        as leaves (each recompute segment under
        ``torch.utils.checkpoint``), gradients of the (scaled) loss,
        then the optimizer's update, skipped where a scaled step's
        gradients are not finite, or merged over ``k`` runs."""
        if train_op is not None:
            loss_t, opt = train_op
            loss_ref = loss_t._ref()
        else:
            opt = None
            loss_ref = grad_fetch[0]._grad_of[0]
        for g in grad_fetch:
            r = g._grad_of[0]
            if (r.node, r.idx, r.feed) != (loss_ref.node, loss_ref.idx,
                                           loss_ref.feed):
                raise StaticGraphError(
                    "fetching gradients of two different losses in one run "
                    "is not supported")
        fwd = [f._ref() for f in fetch_list if f._grad_of is None]
        params, segs, main, _ = self._train_plan(prog, loss_ref, fwd, opt)
        scaler = getattr(opt, "_static_amp_scaler", None) \
            if opt is not None else None
        gm_k = int(getattr(opt, "_gm_k", 1) or 1) if opt is not None else 1
        gm_avg = bool(getattr(opt, "_gm_avg", True))
        if gm_k > 1:
            if getattr(opt, "_gm_buffers", None) is None:
                opt._gm_buffers = [torch.zeros_like(p.detach())
                                   for p in params]
                opt._gm_nacc = torch.zeros((), dtype=torch.int32,
                                           device=params[0].device)
                opt._gm_count = 0
            apply_update = (opt._gm_count + 1) % gm_k == 0
        else:
            apply_update = True
        with torch.enable_grad():
            memo = {}
            for n, stop, plan in segs:
                prev = [t for nid in stop for t in memo[nid]]
                counts = [len(memo[nid]) for nid in stop]

                def seg(*flat, _stop=stop, _counts=counts, _plan=plan,
                        _n=n):
                    sub, k = {}, 0
                    for nid, c in zip(_stop, _counts):
                        sub[nid] = list(flat[k:k + c])
                        k += c
                    _plan.run(sub, feeds, params)
                    return tuple(sub[id(_n)])

                memo[id(n)] = list(torch.utils.checkpoint.checkpoint(
                    seg, *prev, use_reentrant=False))
            main.run(memo, feeds, params)
            loss = _fetch(loss_ref, memo, feeds)
            fwd_vals = [_fetch(r, memo, feeds).detach() for r in fwd]
            scale = scaler["state"]["scale"] if scaler is not None else None
            if scale is not None:
                loss = loss * scale.to(loss.dtype)
            grads = list(torch.autograd.grad(loss, params,
                                             allow_unused=True))
        del memo, loss
        finite = None
        if scale is not None:
            inv = 1.0 / scale
            grads = [None if g is None else (g.float() * inv).to(g.dtype)
                     for g in grads]
            present = [torch.isfinite(g.float()).all() for g in grads
                       if g is not None]
            finite = torch.stack(present).all() if present else \
                torch.ones((), dtype=torch.bool, device=scale.device)
            scaler["state"] = _scaler_next(scaler["state"], finite,
                                           scaler["cfg"])
        if gm_k > 1:
            for i, g in enumerate(grads):
                if g is None:
                    continue
                if finite is not None:
                    g = torch.where(finite, g, torch.zeros_like(g))
                opt._gm_buffers[i] = opt._gm_buffers[i] + g
            opt._gm_nacc = opt._gm_nacc + (
                finite.to(torch.int32) if finite is not None else 1)
            opt._gm_count += 1
        if opt is not None and apply_update:
            if gm_k > 1:
                denom = (opt._gm_nacc.clamp_min(1).float() if gm_avg
                         else torch.ones((), device=opt._gm_nacc.device))
                eff = [a / denom.to(a.dtype) for a in opt._gm_buffers]
                keep = opt._gm_nacc > 0
                opt._gm_buffers = [torch.zeros_like(a)
                                   for a in opt._gm_buffers]
                opt._gm_nacc = torch.zeros_like(opt._gm_nacc)
            else:
                eff = grads
                keep = finite
            pairs = [(p, g) for p, g in zip(params, eff)
                     if g is not None and p.requires_grad
                     and getattr(p, "trainable", True)]
            if opt._grad_clip is not None:
                pairs = opt._grad_clip(pairs)
            opt._step_count += 1
            opt._apply(pairs, None if scale is None else ~keep)
        grad_by = {id(p): g for p, g in zip(params, grads)}
        outs, k = [], 0
        for f in fetch_list:
            if f._grad_of is not None:
                p = f._grad_of[1]
                if id(p) not in grad_by:
                    raise StaticGraphError(
                        "fetched grad is for a parameter not reachable "
                        "from the loss")
                g = grad_by[id(p)]
                outs.append(torch.zeros_like(p) if g is None else g)
            else:
                outs.append(fwd_vals[k])
                k += 1
        return outs


# ------------------------------------------------------------- save/load


class _InferenceProgram(torch.nn.Module):
    """The replay of a fetched subgraph as a module of (state, feeds):
    what ``save_inference_model`` exports; the parameters are inputs of
    the exported program, read from ``.pdiparams``."""

    def __init__(self, plan, refs, feed_names, n_state):
        super().__init__()
        self._plan, self._refs = plan, refs
        self._feed_names, self._n = feed_names, n_state

    def forward(self, *flat):
        params = list(flat[:self._n])
        feeds = dict(zip(self._feed_names, flat[self._n:]))
        memo = self._plan.run({}, feeds, params)
        return tuple(_fetch(r, memo, feeds) for r in self._refs)


def _unique(names):
    """``names`` with a repeated one suffixed ``_1``, ``_2``, ...: the
    artifact's names are handles."""
    out, used = [], set()
    for base in names:
        n, k = base, 0
        while n in used:
            k += 1
            n = f"{base}_{k}"
        used.add(n)
        out.append(n)
    return out


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None,
                         **kwargs):
    """``static.save_inference_model``: the fetched subgraph as the
    ``.pdmodel`` that ``jit.save`` writes (``torch.export`` of its replay,
    None dims symbolic, unique output names) and its parameters as
    ``.pdiparams``; ``jit.load`` and ``inference.create_predictor``
    serve it."""
    import os

    from ..framework.io import save as fsave
    from ..jit.api import export_with_dynamic_dims, write_artifact

    if not isinstance(feed_vars, (list, tuple)):
        feed_vars = [feed_vars]
    if not isinstance(fetch_vars, (list, tuple)):
        fetch_vars = [fetch_vars]
    names = []
    for v in feed_vars:
        if not (is_symbolic(v) and v._feed_name):
            raise StaticGraphError(
                "feed_vars must be static.data placeholders")
        names.append(v._feed_name)
    refs = [v._ref() for v in fetch_vars]
    _, params, nodes, _ = _program_signature(refs)
    plan = _Plan(nodes, params, keep_ids=[id(r.node) for r in refs
                                          if r.node is not None])
    state_names = _unique([getattr(p, "name", None) or f"param_{i}"
                           for i, p in enumerate(params)])
    specs, spec_shapes = [], []
    for v in feed_vars:
        orig = v._orig_shape or tuple(v.shape)
        specs.append((tuple(orig), v.dtype))
        spec_shapes.append([None if d is None else int(d) for d in orig])
    device = feed_vars[0].device
    with concrete():
        program = export_with_dynamic_dims(
            _InferenceProgram(plan, refs, names, len(params)),
            [p.detach() for p in params], specs, device)
        os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
        fsave({n: p.detach() for n, p in zip(state_names, params)},
              path_prefix + ".pdiparams")
        out_names = _unique([getattr(v, "name", None) or f"output_{i}"
                             for i, v in enumerate(fetch_vars)])
        from ..dtype import dtype_name

        write_artifact(path_prefix, program,
                       [(shape, dtype_name(v.dtype))
                        for shape, v in zip(spec_shapes, feed_vars)],
                       names, state_names, output_names=out_names)


def load_inference_model(path_prefix, executor=None, **kwargs):
    """``static.load_inference_model`` -> (program, feed names, fetch
    targets); the program is the loaded ``jit.TranslatedLayer``, on the
    executor's device (default: ``set_device``'s, else the card)."""
    from ..jit.api import load as jit_load

    device = getattr(executor, "device", None)
    layer = jit_load(path_prefix, device=device)
    return layer, list(getattr(layer, "_input_names", [])), layer
