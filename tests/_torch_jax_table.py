"""Shared helpers of the tests that hold the port's tensor surface, its
RNNs and its beam search against the JAX package on the CPU.

A table of cases ``{key: (jax_fn, port_fn, arrays, grad)}`` gets every
JAX reference from one ``jax.jit`` (:func:`jax_table`): the JAX
package's functions run over traced arrays wrapped in its ``Tensor``,
with ``jax.vjp`` for the gradients of every float input under a seeded
cotangent of the first output.  Compiled op by op, the same references
cost many times as much.
"""

import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.initializer.initializer as jinit
from paddle_tpu.core.tensor import Tensor as JTensor

# XLA's CPU backend at its lowest optimisation: the references compile in
# less time and compute the same functions
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def np_of(t):
    """``(array, dtype name)``; bfloat16 values come as float32."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        name = str(t.dtype).split(".")[1]
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy(), name
    a = np.asarray(t._data if isinstance(t, JTensor) else t)
    name = a.dtype.name
    return (a.astype(np.float32) if name == "bfloat16" else a), name


def close(got, want, what, rel=1e-5):
    """Equal shapes and dtypes; integers and bools exactly; NaN and the
    infinities where the reference has them; finite values within
    ``rel`` of the reference's largest finite magnitude."""
    (got, gname), (want, wname) = np_of(got), np_of(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert gname == wname, (what, gname, wname)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                  err_msg=f"{what}: NaNs")
    inf = np.isinf(want)
    np.testing.assert_array_equal(got[inf], want[inf],
                                  err_msg=f"{what}: infinities")
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin,
                                  err_msg=f"{what}: finite")
    scale = np.abs(want[fin]).max() if fin.any() else 1.0
    np.testing.assert_allclose(got[fin], want[fin], rtol=0,
                               atol=rel * max(scale, 1e-30), err_msg=what)


def compare(got, want, what, rel=1e-5):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)), (what, type(got))
        assert len(got) == len(want), (what, len(got), len(want))
        for i, (g, w) in enumerate(zip(got, want)):
            compare(g, w, f"{what}[{i}]", rel)
    elif want is None:
        assert got is None, what
    elif isinstance(want, (bool, int, float)) and not isinstance(
            got, torch.Tensor):
        assert got == want, (what, got, want)
    else:
        close(got, want, what, rel)


def first(out):
    return out[0] if isinstance(out, (list, tuple)) else out


def unwrap(out):
    if isinstance(out, JTensor):
        return out._data
    if isinstance(out, (list, tuple)):
        return [unwrap(o) for o in out]
    return out


def traced(jfn):
    """``jfn`` over raw arrays: JAX ``Tensor``s in, arrays out, the tape
    off (``jax.vjp`` differentiates)."""
    def fn(*arrs):
        with paddle.no_grad():
            return unwrap(jfn(*[JTensor(a) for a in arrs]))
    return fn


def jax_table(cases, eager=()):
    """``{key: (jax_fn, port_fn, arrays, grad)}`` -> ``{key: (port_fn,
    arrays, grad, cotangent, JAX output, JAX gradients)}`` from one
    ``jax.jit``; the keys of ``eager`` (JAX functions that read a value
    on the host) run outside it."""
    cots = {}
    for i, (k, (_, tfn, arrays, grad)) in enumerate(sorted(cases.items())):
        if grad:        # the port's output shape: a wrong one fails later
            with torch.no_grad():
                shape = first(tfn(*[torch.tensor(a) for a in arrays]))
            cots[k] = np.asarray(np.random.RandomState(i).randn(
                *shape.shape), np.float32)
    flat_in = {k: [jnp.asarray(a) for a in v[2]] for k, v in cases.items()}
    flat_cot = {k: jnp.asarray(v) for k, v in cots.items()}

    def run(flat_in, flat_cot):
        res = {}
        for k, args in flat_in.items():
            jfn, _, _, grad = cases[k]
            fn = traced(jfn)
            if grad:
                fl = [i for i, a in enumerate(args)
                      if jnp.issubdtype(a.dtype, jnp.floating)]

                def both(*fa, fn=fn, args=args, fl=fl):
                    full = list(args)
                    for i, a in zip(fl, fa):
                        full[i] = a
                    out = fn(*full)
                    return first(out), out

                _, pull, out = jax.vjp(both, *[args[i] for i in fl],
                                       has_aux=True)
                res[k] = (out, pull(flat_cot[k]))
            else:
                res[k] = (fn(*args), ())
        return res

    jit_in = {k: v for k, v in flat_in.items() if k not in eager}
    out = jax.device_get(jax.jit(run).lower(jit_in, flat_cot).compile(
        compiler_options=FAST_COMPILE)(jit_in, flat_cot))
    out.update(jax.device_get(run({k: v for k, v in flat_in.items()
                                   if k in eager}, flat_cot)))
    return {k: (v[1], v[2], v[3], cots.get(k), out[k][0], out[k][1])
            for k, v in cases.items()}


def check_case(refs, key, rel=1e-5):
    """The port's output and gradients against the JAX references of
    :func:`jax_table`."""
    tfn, arrays, grad, cot, jout, jgrads = refs[key]
    tt = [torch.tensor(a, requires_grad=grad and a.dtype.kind == "f")
          for a in arrays]
    tout = tfn(*tt)
    compare(tout, jout, str(key), rel)
    if not grad:
        return
    out = first(tout)
    if out.requires_grad:   # else the port's gradients are all zero
        (out * torch.from_numpy(cot)).sum().backward()
    for i, (t, j) in enumerate(zip([t for t in tt if t.requires_grad],
                                   jgrads)):
        got = t.grad
        if got is None or got._is_zerotensor():
            got = torch.zeros_like(t)
        close(got, j, f"{key} grad {i}", rel)


@contextlib.contextmanager
def numpy_init(seed):
    """JAX's initializers drawing from ``RandomState(seed)`` with their
    own distributions: threefry's XLA compile for each distinct weight
    shape costs ~0.5 s on the CPU, and the draws' bits do not matter
    (the port loads JAX's values)."""
    rng = np.random.RandomState(seed)

    def arr(a, dtype):
        return jnp.asarray(np.asarray(a, np.float32), dtype)

    def fan_sum(self, shape):
        fin, fout = jinit._fans(shape)
        return (self.fan_in or fin) + (self.fan_out or fout)

    calls = {
        jinit.Constant: lambda self, shape, dtype=jnp.float32: arr(
            np.full(shape, self.value), dtype),
        jinit.Normal: lambda self, shape, dtype=jnp.float32: arr(
            rng.randn(*shape) * self.std + self.mean, dtype),
        jinit.Uniform: lambda self, shape, dtype=jnp.float32: arr(
            rng.uniform(self.low, self.high, shape), dtype),
        jinit.XavierNormal: lambda self, shape, dtype=jnp.float32: arr(
            rng.randn(*shape) * self.gain * math.sqrt(
                2.0 / fan_sum(self, shape)), dtype),
        jinit.XavierUniform: lambda self, shape, dtype=jnp.float32: arr(
            rng.uniform(-1, 1, shape) * self.gain * math.sqrt(
                6.0 / fan_sum(self, shape)), dtype),
    }
    saved = {c: c.__call__ for c in calls}
    for c, f in calls.items():
        c.__call__ = f
    try:
        yield
    finally:
        for c, f in saved.items():
            c.__call__ = f
