"""``paddle.jit``: ``to_static``, ``save``, ``load``, the counterpart of
``paddle_tpu/jit/api.py``.

JAX collapses Paddle's dy2static + ProgramDesc pipeline into ``jax.jit``;
here a captured program is ``torch.compile`` of the (dy2static-converted)
function, one per input signature, whole-graph (``fullgraph=True``,
``dynamic=False``): a graph break or a capture failure raises, naming its
cause, and nothing gives way to the eager function.  On the card the
backend is Inductor; on the CPU it is ``aot_eager`` (the same dynamo
graph and AOTAutograd joint graph, run by eager kernels: Inductor's C++
code generation costs tens of seconds a program there and computes the
same function).  The hand-written kernels are ``torch.library`` custom
ops (``ops/_library.py``), so a captured program calls them, forward and
backward.

What a call does, as JAX's:

* buffers the forward rewrites (BatchNorm's running statistics) and
  parameters it rewrites in place are written back (dynamo replays the
  mutations);
* each call draws one key of the port's random stream and seeds the
  torch generator of the call's device from it for the call (the global
  generator's state is restored after), so random draws differ from call
  to call and depend only on the stream;
* ``loss.backward()`` through a ``to_static`` forward reaches the
  parameters and the differentiable inputs (AOTAutograd's backward
  graph).

``save`` writes the layer's ``state_dict`` as ``.pdiparams`` (the port's
``framework.io.save``, the same bytes as JAX's) and ``.pdmodel`` in JAX's
one schema, where the serialized ``torch.export`` program of the
dy2static-converted forward under ``no_grad`` takes the place of the
serialized StableHLO; the state is an input of that program.  ``load``
returns a :class:`TranslatedLayer` that runs it.  A ``.pdmodel`` of one
package cannot run in the other (ROADMAP.md); ``.pdiparams`` loads in
both.
"""

from __future__ import annotations

import ast
import builtins
import contextlib
import functools
import io
import os
import pickle
import re
import time

import numpy as np
import torch

from .. import random as _random
from ..core import _int64_off
from ..device import resolve_device
from ..dtype import dtype_name, to_torch_dtype
from ..observability import events as _obs_events
from ..observability import metrics as _obs_metrics

# per-function compile/cache telemetry: calling a captured function twice
# with the same input signature shows cache_hit += 1 and compile_count
# unchanged
_COMPILE_COUNT = _obs_metrics.counter(
    "jit.compile_count", "to_static trace+compile builds, by function")
_CACHE_HIT = _obs_metrics.counter(
    "jit.cache_hit", "to_static calls served from the jit cache")
_COMPILE_SECONDS = _obs_metrics.histogram(
    "jit.compile_seconds",
    "wall seconds from cache miss to first result, by function")

#: the format tag of the port's ``.pdmodel`` (JAX's holds "stablehlo")
PROGRAM_FORMAT = "torch.export"
#: dynamo settings of every capture: a program per signature (past the
#: default of 8 recompiles of one function) and a raise, never a silent
#: eager fallback, where dynamo would give up
_DYNAMO_CONFIG = {"recompile_limit": 256,
                  "fail_on_recompile_limit_hit": True}


class InputSpec:
    """``paddle.static.InputSpec``: a shape (``None`` or ``-1`` for a
    dynamic axis), a dtype taken as ``to_tensor`` takes it (an int64
    asked for is int32) and a name."""

    def __init__(self, shape, dtype="float32", name=None, stop_gradient=True):
        self.shape = list(shape)
        self.dtype = _int64_off(to_torch_dtype(dtype))
        self.name = name
        self.stop_gradient = stop_gradient

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(tensor.shape, tensor.dtype, name)

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")


def _spec_key(args, kwargs):
    def leaf_key(a):
        if isinstance(a, torch.Tensor):
            return ("T", tuple(a.shape), str(a.dtype), str(a.device))
        if isinstance(a, np.ndarray):
            return ("A", a.shape, str(a.dtype))
        if isinstance(a, (list, tuple)):
            return tuple(leaf_key(x) for x in a)
        return ("S", repr(a))

    return (tuple(leaf_key(a) for a in args),
            tuple(sorted((k, leaf_key(v)) for k, v in kwargs.items())))


def _first_device(args, kwargs, layer):
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.Tensor):
            return a.device
        if isinstance(a, (list, tuple)):
            for x in a:
                if isinstance(x, torch.Tensor):
                    return x.device
    if layer is not None:
        for t in layer.state_dict().values():
            return t.device
    return resolve_device(None)


def _backend(device):
    return "inductor" if device.type == "cuda" else "aot_eager"


@contextlib.contextmanager
def _seeded(device):
    """The torch generator of ``device`` seeded from the next key of the
    port's stream for the block, its state restored after."""
    cuda = [device] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=cuda, device_type="cuda"):
        seed = _random.key_seed(*_random.next_key())
        if cuda:
            with torch.cuda.device(device):
                torch.cuda.manual_seed(seed)
        else:
            torch.manual_seed(seed)
        yield


class StaticFunction:
    """A function (or a Layer's bound forward) captured by
    ``torch.compile``, one program per input signature (``_spec_key``)."""

    def __init__(self, function, layer=None, input_spec=None, full_graph=True):
        from .dy2static import convert_to_static, preconvert_methods

        self._orig = function
        self._fn = convert_to_static(function) if full_graph else function
        if layer is not None:
            preconvert_methods(layer)
        self._layer = layer
        self._input_spec = input_spec
        self._cache = {}
        functools.update_wrapper(self, function)

    @property
    def function(self):
        return self._fn

    @property
    def program_cache(self):
        return self._cache

    def concrete_program_specified_input_spec(self, *a, **k):
        return None

    def get_concrete_program(self, *args, **kwargs):
        return None

    def _name(self):
        return getattr(self, "__name__", None) \
            or getattr(self._fn, "__name__", "fn")

    def __call__(self, *args, **kwargs):
        key = _spec_key(args, kwargs)
        name = self._name()
        compiled = self._cache.get(key)
        if compiled is not None:
            _CACHE_HIT.inc(fn=name)
            return self._run(compiled, args, kwargs)
        # miss: a fresh capture — record WHY (first call vs a new input
        # signature) and how long the whole miss-path call takes (capture
        # + compile + first execution: the user-felt time to first
        # result)
        _obs_events.instant(
            "jit.retrace", cat="jit", fn=name,
            cause="first_call" if not self._cache else "new_input_signature",
            cached_signatures=len(self._cache), signature=repr(key)[:300])
        _obs_events.begin("jit.compile", cat="jit", fn=name,
                          signature=repr(key)[:300])
        device = _first_device(args, kwargs, self._layer)
        compiled = torch.compile(self._fn, fullgraph=True, dynamic=False,
                                 backend=_backend(device))
        t0 = time.perf_counter()
        try:
            out = self._run(compiled, args, kwargs)
        finally:
            dt = time.perf_counter() - t0
            _COMPILE_COUNT.inc(fn=name)
            _COMPILE_SECONDS.observe(dt, fn=name)
            _obs_events.end("jit.compile", cat="jit", fn=name,
                            seconds=round(dt, 9))
        self._cache[key] = compiled
        return out

    def _run(self, compiled, args, kwargs):
        device = _first_device(args, kwargs, self._layer)
        with torch._dynamo.config.patch(**_DYNAMO_CONFIG), _seeded(device):
            try:
                return compiled(*args, **kwargs)
            except torch._dynamo.exc.TorchDynamoException as e:
                user = _user_error(e)
                if user is None:
                    raise
                raise user from e


_RAISED = re.compile(r"raised exception ([A-Za-z_]\w*)\((.*)\)\s*$",
                     re.MULTILINE)


def _user_error(e):
    """The exception the captured code itself raised (dynamo reports it
    as ``raised exception NameError("...")`` inside its own error), as
    that type, or None: a capture that fails because the code raised
    (an undefined variable, a staging error of dy2static) raises what
    the code raised."""
    from . import dy2static

    m = _RAISED.search(str(e))
    if m is None:
        return None
    kind = getattr(builtins, m.group(1), None) or getattr(
        dy2static, m.group(1), None)
    if not (isinstance(kind, type) and issubclass(kind, Exception)):
        return None
    try:
        args = ast.literal_eval(f"({m.group(2)},)")
    except (ValueError, SyntaxError):
        args = (m.group(2),)
    return kind(*args)


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, full_graph=True, check=False, **kwargs):
    """Decorator/wrapper: capture a function or a Layer's forward (see
    the module docstring).  ``check=True`` would run the JAX package's
    trace-safety linter (``paddle_tpu.analysis``), which the port does
    not have: it raises ``NotImplementedError``."""
    if check:
        raise NotImplementedError(
            "to_static(check=True) runs the trace-safety linter "
            "(paddle_tpu.analysis), not ported yet (ROADMAP.md port queue: "
            "analysis/)")

    def decorate(obj):
        if isinstance(obj, torch.nn.Module):
            fwd = obj.forward
            if isinstance(fwd, StaticFunction):
                return obj
            obj.forward = StaticFunction(fwd, layer=obj,
                                         input_spec=input_spec,
                                         full_graph=full_graph)
            return obj
        return StaticFunction(obj, layer=None, input_spec=input_spec,
                              full_graph=full_graph)

    if function is not None:
        return decorate(function)
    return decorate


def not_to_static(fn):
    fn._not_to_static = True
    return fn


def ignore_module(modules):
    pass


def enable_to_static(flag):
    pass


# ---------------------------------------------------------------- save/load
class _Program(torch.nn.Module):
    """The exported function: ``(*state, *inputs) -> tuple of outputs``,
    the layer's forward (exported under ``no_grad``) with its state
    swapped for the
    state inputs (``torch.func.functional_call``; a state tensor that a
    module also keeps in a tuple attribute, as BERT's tied MLM decoder
    keeps the word embedding, is swapped there too).  The layer is not a
    submodule here, so the export lifts none of its tensors as its
    own."""

    def __init__(self, layer, names):
        super().__init__()
        object.__setattr__(self, "_layer", layer)
        self._names = names

    def forward(self, *flat):
        n = len(self._names)
        state = dict(zip(self._names, flat[:n]))
        held = {id(t): state[k] for k, t in
                self._layer.state_dict(keep_vars=True).items()}
        swapped = []
        for m in self._layer.modules():
            for attr, val in list(vars(m).items()):
                if type(val) is tuple and any(id(x) in held for x in val):
                    swapped.append((m, attr, val))
                    vars(m)[attr] = tuple(held.get(id(x), x) for x in val)
        try:
            out = torch.func.functional_call(
                self._layer, state, tuple(flat[n:]), strict=True,
                tie_weights=True)
        finally:
            for m, attr, val in swapped:
                vars(m)[attr] = val
        return tuple(out) if isinstance(out, (list, tuple)) else (out,)


def _is_dynamic(s):
    return s is None or (isinstance(s, int) and s < 0)


def export_with_dynamic_dims(program, leading, specs, device):
    """``torch.export`` of ``program(*leading, *inputs)`` with each
    dynamic (None/-1) spec axis a ``torch.export.Dim``, traced at size 2
    (``torch.export`` specialises sizes 0 and 1).  The dims start
    independent; if the export cannot relate them (two inputs whose batch
    axes must be equal), it tries again with one dim per axis index, as
    JAX's ``export_with_dynamic_dims`` does.  ``specs``: [(shape, dtype)]."""
    def build(share_by_axis):
        dims, example, shapes = {}, [], []
        for shape, dtype in specs:
            axes = {}
            for ax, s in enumerate(shape):
                if _is_dynamic(s):
                    key = ax if share_by_axis else len(dims)
                    if key not in dims:
                        dims[key] = torch.export.Dim(f"d{len(dims)}")
                    axes[ax] = dims[key]
            full = [2 if _is_dynamic(s) else int(s) for s in shape]
            example.append(torch.zeros(full, dtype=dtype, device=device))
            shapes.append(axes or None)
        return example, shapes, bool(dims)

    def export(share):
        example, shapes, dynamic = build(share)
        # one entry per argument of forward(*flat): the varargs tuple
        ds = ((tuple([None] * len(leading) + shapes),) if dynamic
              else None)
        with torch.no_grad():
            return torch.export.export(
                program, tuple(leading) + tuple(example), dynamic_shapes=ds,
                strict=False)

    try:
        return export(False)
    except Exception:
        if not any(_is_dynamic(s) for shape, _ in specs for s in shape):
            raise
        return export(True)


def _shape_of(t):
    return [d if isinstance(d, int) else -1 for d in t.shape]


def write_artifact(path, program, input_spec, input_names, state_names,
                   output_names=None):
    """The ONE ``.pdmodel`` schema (JAX's ``write_artifact``): the
    program, the input spec, the input, state and output names and the
    output spec (dynamic dims as -1)."""
    outs = [n for n in program.graph.nodes if n.op == "output"][0].args[0]
    out_vals = [o.meta["val"] for o in outs]
    n_out = len(out_vals)
    if output_names is None:
        output_names = [f"output_{i}" for i in range(n_out)]
    if len(output_names) != n_out:
        raise ValueError(f"write_artifact: {len(output_names)} output names "
                         f"for {n_out} exported outputs")
    if len(set(output_names)) != len(output_names):
        raise ValueError(f"write_artifact: duplicate output names "
                         f"{output_names}")
    # the example inputs (the state among them) stay out of the file: the
    # state is the .pdiparams beside it
    program._example_inputs = None
    buf = io.BytesIO()
    torch.export.save(program, buf)
    with open(path + ".pdmodel", "wb") as f:
        pickle.dump({
            "format": PROGRAM_FORMAT,
            "program": buf.getvalue(),
            "device": str(_program_device(program)),
            "input_spec": input_spec,
            "input_names": input_names,
            "state_names": state_names,
            "output_names": list(output_names),
            "output_spec": [(_shape_of(v), dtype_name(v.dtype))
                            for v in out_vals],
        }, f)


def _program_device(program):
    for n in program.graph.nodes:
        if n.op == "placeholder" and isinstance(n.meta.get("val"),
                                                torch.Tensor):
            return n.meta["val"].device
    return torch.device("cpu")


def save(layer, path, input_spec=None, **configs):
    """``jit.save``: ``<path>.pdiparams`` (the state) and, with an
    ``input_spec``, ``<path>.pdmodel`` (the exported program; see the
    module docstring).  Input names must be unique.  The export sees the
    dy2static-converted forward (early exits and staged control flow),
    as a ``to_static`` call does; the instance's own ``forward`` is
    restored after."""
    if not isinstance(layer, torch.nn.Module):
        raise TypeError("jit.save expects a Layer")
    from ..framework.io import save as fsave

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    sd = layer.state_dict()
    fsave(sd, path + ".pdiparams")
    if not input_spec:
        return
    from .dy2static import convert_to_static

    in_names = [getattr(sp, "name", None) or f"input_{i}"
                for i, sp in enumerate(input_spec)]
    if len(set(in_names)) != len(in_names):
        raise ValueError(f"jit.save: input_spec names must be unique, got "
                         f"{in_names}")
    names = list(sd.keys())
    fwd = layer.forward
    base = fwd._fn if isinstance(fwd, StaticFunction) else fwd
    conv = convert_to_static(base)
    # restore EXACTLY the prior instance state: a user's own
    # instance-level forward (monkey-patch, to_static wrapper) must
    # survive the export shadow
    had_inst = "forward" in layer.__dict__
    prev_inst = layer.__dict__.get("forward")
    shadow = conv is not fwd
    if shadow:
        object.__setattr__(layer, "forward", conv)
    device = next(iter(sd.values())).device if sd else resolve_device(None)
    specs = [(list(sp.shape), sp.dtype) for sp in input_spec]
    try:
        program = export_with_dynamic_dims(
            _Program(layer, names), [sd[k] for k in names], specs, device)
    finally:
        if shadow:
            if had_inst:
                object.__setattr__(layer, "forward", prev_inst)
            else:
                object.__delattr__(layer, "forward")
    write_artifact(path, program,
                   [(list(sp.shape), dtype_name(sp.dtype))
                    for sp in input_spec], in_names, names)


class TranslatedLayer(torch.nn.Module):
    """``jit.load``'s result: runs the loaded exported program on its
    device over the loaded state."""

    def __init__(self, program, state, input_spec=None, input_names=None,
                 output_names=None):
        super().__init__()
        self._program = program
        self._run = program.module()
        self._state = state
        self._input_spec = input_spec or []
        self._input_names = input_names or [
            f"input_{i}" for i in range(len(self._input_spec))]
        self._output_names = output_names
        self._device = state[0].device if state else _program_device(program)

    @property
    def device(self):
        return self._device

    def forward(self, *args):
        ins = [a.to(self._device) if isinstance(a, torch.Tensor)
               else torch.as_tensor(np.asarray(a), device=self._device)
               for a in args]
        for i, (t, spec) in enumerate(zip(ins, self._input_spec)):
            want = to_torch_dtype(spec[1])
            if t.dtype != want:
                ins[i] = t.to(want)
        outs = self._run(*self._state, *ins)
        return outs[0] if len(outs) == 1 else tuple(outs)


def load(path, params_path=None, device=None, **configs):
    """``jit.load``: the :class:`TranslatedLayer` of ``<path>.pdmodel``
    over ``params_path`` (default ``<path>.pdiparams``; a file the JAX
    package wrote loads too), on ``device`` (the card unless the caller
    asks for the CPU).  Importing the kernels' module registers the
    custom ops the program calls."""
    from .. import ops  # noqa: F401  (registers the custom ops)
    from ..framework.io import load as fload

    with open(path + ".pdmodel", "rb") as f:
        blob = pickle.load(f)
    if blob.get("format") != PROGRAM_FORMAT:
        raise ValueError(
            f"{path}.pdmodel holds no {PROGRAM_FORMAT} program (a JAX "
            "package's .pdmodel holds serialized StableHLO, which the port "
            "cannot run; its .pdiparams loads through params_path)")
    dev = resolve_device(device)
    program = torch.export.load(io.BytesIO(blob["program"]))
    if torch.device(blob["device"]).type != dev.type:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, dev)
    sd = fload(params_path or configs.get("params_path")
               or path + ".pdiparams", device=dev)
    state = [sd[k] for k in blob["state_names"]]
    return TranslatedLayer(program, state, input_spec=blob["input_spec"],
                           input_names=blob["input_names"],
                           output_names=blob["output_names"])
