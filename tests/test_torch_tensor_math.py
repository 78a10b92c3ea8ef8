"""The port's creation, math, logic, attribute, stat and einsum functions
against the JAX package's on numpy-seeded inputs on the CPU.

Every case holds the output (shape, dtype, values) and, where the
function is differentiable, each float input's gradient under a seeded
cotangent, to 1e-5 of the reference's largest finite magnitude (the same
f32 arithmetic in another order; 1e-4 for the special functions, whose
polynomials differ between XLA and torch); integer and bool outputs
exactly, NaN and the infinities where JAX has them.  JAX's references
come from one ``jax.jit`` of the whole table (``_torch_jax_table``);
the functions that read their data on the host (``bincount``,
``combinations``, ``increment``, the attribute predicates) run eagerly.
Then the name sets: the port's ``tensor`` exports every name of JAX's
``tensor/__init__.py`` import lists, and its root re-exports them.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.tensor as J
import paddle_tpu_torch as pt
import paddle_tpu_torch.tensor as T

from _torch_jax_table import check_case, compare, jax_table
from _torch_port_util import one_thread  # noqa: F401

CPU = {"device": "cpu"}
SPECIAL_REL = 1e-4


def _f(*shapes, seed=0, lo=-2.0, hi=2.0):
    r = np.random.RandomState(seed)
    return [r.uniform(lo, hi, s).astype(np.float32) for s in shapes]


def _ints(*shapes, seed=0, lo=-5, hi=6):
    r = np.random.RandomState(seed)
    return [r.randint(lo, hi, s).astype(np.int32) for s in shapes]


CASES = {}


def _reg(family, name, jfn, tfn, arrays, grad=True):
    CASES[f"{family}|{name}"] = (jfn, tfn, arrays, grad)


def _same(family, name, call, arrays, grad=True):
    """One call of both packages' functions: ``call(module, *args)``."""
    _reg(family, name, lambda *a: call(J, *a), lambda *a: call(T, *a),
         arrays, grad)


# ----- unary: (domain lo, hi, differentiable) -----
UNARY = {
    "sqrt": (0.5, 2, True), "rsqrt": (0.5, 2, True), "square": (-2, 2, True),
    "exp": (-2, 2, True), "expm1": (-2, 2, True), "log": (0.2, 3, True),
    "log2": (0.2, 3, True), "log10": (0.2, 3, True),
    "log1p": (-0.5, 3, True), "abs": (-2, 2, True), "neg": (-2, 2, True),
    "negative": (-2, 2, True), "sign": (-2, 2, True), "sgn": (-2, 2, True),
    "sin": (-2, 2, True), "cos": (-2, 2, True), "tan": (-1, 1, True),
    "asin": (-0.9, 0.9, True), "acos": (-0.9, 0.9, True),
    "atan": (-2, 2, True), "sinh": (-2, 2, True), "cosh": (-2, 2, True),
    "tanh": (-2, 2, True), "asinh": (-2, 2, True), "acosh": (1.1, 3, True),
    "atanh": (-0.9, 0.9, True), "floor": (-3, 3, True),
    "ceil": (-3, 3, True), "round": (-3, 3, True), "trunc": (-3, 3, True),
    "frac": (-3, 3, True), "reciprocal": (0.5, 2, True),
    "sigmoid": (-3, 3, True), "logsigmoid": (-3, 3, True),
    "erf": (-2, 2, True), "erfinv": (-0.9, 0.9, True),
    "lgamma": (0.3, 4, True), "gammaln": (0.3, 4, True),
    "digamma": (0.3, 4, True), "i0": (-3, 3, True), "i0e": (-3, 3, False),
    "i1": (-3, 3, False), "i1e": (-3, 3, False), "angle": (-2, 2, True),
    "conj": (-2, 2, True), "real": (-2, 2, True), "imag": (-2, 2, True),
    "deg2rad": (-90, 90, True), "rad2deg": (-2, 2, True),
    "isnan": (-2, 2, False), "isinf": (-2, 2, False),
    "isfinite": (-2, 2, False), "signbit": (-2, 2, False),
    "positive": (-2, 2, True), "stanh": (-2, 2, True),
    "logit": (0.1, 0.9, True), "nan_to_num": (-2, 2, True),
}
for _n, (_lo, _hi, _g) in UNARY.items():
    _same("unary", _n, lambda m, a, n=_n: getattr(m, n)(a),
          _f((3, 4), seed=len(_n), lo=_lo, hi=_hi), _g)
_same("unary", "clip", lambda m, a: m.clip(a, -0.5, 1.0), _f((3, 4)))
_same("unary", "clip_min", lambda m, a: m.clip(a, min=0.2), _f((3, 4)))
_same("unary", "scale", lambda m, a: m.scale(a, 2.0, 0.5), _f((3, 4)))
_same("unary", "scale_before", lambda m, a: m.scale(
    a, 3.0, -1.0, bias_after_scale=False), _f((3, 4)))
_same("unary", "logit_eps", lambda m, a: m.logit(a, 0.2),
      _f((3, 4), lo=0.01, hi=0.99))
_same("unary", "polygamma1", lambda m, a: m.polygamma(a, 1),
      _f((3, 4), lo=0.5, hi=3), False)
_same("unary", "polygamma2", lambda m, a: m.polygamma(a, 2),
      _f((3, 4), lo=0.5, hi=3), False)
_same("unary", "frexp", lambda m, a: m.frexp(a), _f((3, 4), lo=-9, hi=9),
      False)

# special functions at their domain edges (JAX's values there)
EDGES = {
    "digamma": [0.0, -0.0, -1.0, -1.5, 1e-30, 1.0, 2.5, -2.0],
    "lgamma": [0.0, -0.0, -1.0, -1.5, 1.0, 2.0, 1e-30, -2.5],
    "erfinv": [1.0, -1.0, 1.5, 0.0, 0.999, -0.999],
    "i0e": [0.0, -1.0, 100.0, -100.0, 1e-3],
    "i1": [0.0, -1.0, 50.0, -50.0, 1e-3],
    "i1e": [0.0, -1.0, 100.0, -100.0, 1e-3],
    "round": [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.49999997, 3.5],
    "angle": [-0.0, 0.0, -1.0, 1.0],
    "sign": [-0.0, 0.0, -1.0, 3.0],
    "log": [0.0, -1.0, 1.0],
    "sqrt": [0.0, -1.0, 4.0],
}
for _n, _v in EDGES.items():
    _same("edge", _n, lambda m, a, n=_n: getattr(m, n)(a),
          [np.array(_v, np.float32)], False)
for _k in (1, 2, 3):
    _same("edge", f"polygamma{_k}", lambda m, a, k=_k: m.polygamma(a, k),
          [np.array([0.0, -1.0, -2.0, -1.5, 2.0, 0.5], np.float32)], False)
_GA = np.array([0.0, 1.0, 2.0, -1.0, 1.0, 0.5, 3.0, 0.0], np.float32)
_GX = np.array([1.0, 0.0, 2.0, 1.0, -1.0, 0.0, 0.0, 0.0], np.float32)
for _n in ("gammainc", "gammaincc"):
    _same("edge", _n, lambda m, a, b, n=_n: getattr(m, n)(a, b), [_GA, _GX],
          False)
_same("edge", "nan_to_num", lambda m, a: m.nan_to_num(a, 1.5, 9.0, -9.0),
      [np.array([np.nan, np.inf, -np.inf, 2.0], np.float32)], False)
_same("edge", "nan_to_num_default", lambda m, a: m.nan_to_num(a),
      [np.array([np.nan, np.inf, -np.inf, 2.0], np.float32)], False)

# ----- binary: tensor-tensor with broadcasting, and tensor-number -----
BINARY = {
    "add": (-2, 2, True), "subtract": (-2, 2, True),
    "multiply": (-2, 2, True), "divide": (0.5, 2, True),
    "floor_divide": (0.5, 3, False), "remainder": (0.5, 3, True),
    "mod": (0.5, 3, True), "floor_mod": (0.5, 3, True),
    "pow": (0.5, 2, True), "maximum": (-2, 2, True),
    "minimum": (-2, 2, True), "fmax": (-2, 2, True), "fmin": (-2, 2, True),
    "atan2": (-2, 2, True), "hypot": (-2, 2, True),
    "heaviside": (-2, 2, True), "nextafter": (-2, 2, False),
    "copysign": (-2, 2, True), "ldexp": (-2, 2, True),
    "logaddexp": (-2, 2, True), "gammainc": (0.5, 3, False),
    "gammaincc": (0.5, 3, False),
}
for _n, (_lo, _hi, _g) in BINARY.items():
    _same("binary", _n, lambda m, a, b, n=_n: getattr(m, n)(a, b),
          _f((3, 4), (4,), seed=len(_n), lo=_lo, hi=_hi), _g)
    _same("binary", _n + "_scalar", lambda m, a, n=_n: getattr(m, n)(a, 1.5),
          _f((3, 4), seed=len(_n) + 1, lo=_lo, hi=_hi), _g)
_same("binary", "heaviside_zeros", lambda m, a, b: m.heaviside(a, b),
      [np.array([0.0, -1.0, 2.0, 0.0], np.float32),
       np.array([0.3, 0.4, 0.5, 0.6], np.float32)])
_same("binary", "lerp", lambda m, a, b: m.lerp(a, b, 0.3), _f((3, 4), (3, 4)))
_same("binary", "lerp_tensor_weight", lambda m, a, b, w: m.lerp(a, b, w),
      _f((3, 4), (3, 4), (4,)))
_same("binary", "scalar_left", lambda m, a: m.subtract(2.5, a), _f((3, 4)))

# integer and bool operands: dtypes by JAX's rules (int32, x64 off)
for _n in ("add", "subtract", "multiply", "floor_divide", "remainder",
           "maximum", "minimum", "gcd", "lcm", "divide"):
    _same("int", _n, lambda m, a, b, n=_n: getattr(m, n)(a, b),
          [_ints((3, 4), seed=1)[0], _ints((4,), seed=2, lo=1)[0]], False)
_same("int", "add_float_scalar", lambda m, a: m.add(a, 2.5),
      _ints((3, 4)), False)
_same("int", "pow_int", lambda m, a: m.pow(a, 2), _ints((3, 4)), False)
_same("int", "mean", lambda m, a: m.mean(a, 1), _ints((3, 4)), False)
_same("int", "sqrt", lambda m, a: m.sqrt(m.abs(a)), _ints((3, 4)), False)
_same("int", "sum", lambda m, a: m.sum(a), _ints((3, 4)), False)
_same("int", "sum_dtype", lambda m, a: m.sum(a, 1, dtype="int64"),
      _ints((3, 4)), False)
_same("int", "sum_float_dtype", lambda m, a: m.sum(a, 0, dtype="float32"),
      _ints((3, 4)), False)
_same("int", "prod", lambda m, a: m.prod(a, 0), _ints((3, 4)), False)
_same("int", "cumsum", lambda m, a: m.cumsum(a), _ints((3, 4)), False)
_same("int", "cumprod", lambda m, a: m.cumprod(a, 1), _ints((3, 4)), False)
_same("int", "count_nonzero", lambda m, a: m.count_nonzero(a, 1, True),
      _ints((3, 4)), False)
_same("int", "trace", lambda m, a: m.trace(a), _ints((4, 4)), False)
_same("int", "bool_sum", lambda m, a: m.sum(a > 0), _ints((3, 4)), False)
_same("int", "bool_add", lambda m, a: m.add(a > 0, 1), _ints((3, 4)), False)
_same("int", "max", lambda m, a: m.max(a, 0), _ints((3, 4)), False)
_same("int", "abs_sign", lambda m, a: (m.abs(a), m.sign(a), m.neg(a)),
      _ints((3, 4)), False)
_same("int", "floor_round", lambda m, a: (m.floor(a), m.round(a)),
      _ints((3, 4)), False)
_same("int", "reciprocal_deg2rad", lambda m, a: (m.reciprocal(m.abs(a) + 1),
                                                 m.deg2rad(a)),
      _ints((3, 4)), False)

# ----- reductions over None, an int, a tuple, with keepdim -----
REDUCE = ("sum", "nansum", "mean", "nanmean", "max", "min", "amax", "amin",
          "prod", "logsumexp", "std", "var", "count_nonzero")
for _n in REDUCE:
    for _ax, _tag in ((None, "all"), (1, "ax1"), ((0, 2), "ax02"),
                      (-1, "last")):
        for _kd in (False, True):
            _same("reduce", f"{_n}_{_tag}_{int(_kd)}",
                  lambda m, a, n=_n, ax=_ax, kd=_kd: getattr(m, n)(
                      a, ax, keepdim=kd),
                  _f((2, 3, 4), seed=len(_n), lo=0.5, hi=2.0),
                  _n != "count_nonzero")
_same("reduce", "std_biased", lambda m, a: m.std(a, 1, unbiased=False),
      _f((3, 5)))
_same("reduce", "var_biased", lambda m, a: m.var(a, None, False, True),
      _f((3, 5)))
_same("reduce", "max_ties", lambda m, a: m.max(a, 1),
      [np.array([[1.0, 3.0, 3.0, 2.0], [0.0, 0.0, 0.0, 0.0]], np.float32)])
_same("reduce", "amin_ties", lambda m, a: m.amin(a),
      [np.array([[1.0, -3.0, -3.0, 2.0]], np.float32)])
_NAN = np.array([[1.0, np.nan, 2.0], [np.nan, 3.0, 4.0]], np.float32)
_same("reduce", "nansum_nan", lambda m, a: m.nansum(a, 1), [_NAN])
_same("reduce", "nanmean_nan", lambda m, a: m.nanmean(a, 0), [_NAN])
_same("reduce", "nansum_dtype", lambda m, a: m.nansum(a, dtype="float64"),
      [_NAN])
_same("reduce", "prod_dtype", lambda m, a: m.prod(a, 1, dtype="float64"),
      _f((3, 4)))
for _n in ("cumsum", "cumprod", "logcumsumexp"):
    for _ax in (None, 0, 1):
        _same("cum", f"{_n}_{_ax}", lambda m, a, n=_n, ax=_ax: getattr(m, n)(
            a, ax), _f((3, 4), seed=3, lo=0.5, hi=1.5))
for _n in ("cummax", "cummin"):
    for _ax in (None, 0, 1):
        _same("cum", f"{_n}_{_ax}", lambda m, a, n=_n, ax=_ax: getattr(m, n)(
            a, ax), _f((3, 4), seed=4))
    _same("cum", f"{_n}_ties", lambda m, a, n=_n: getattr(m, n)(a, 1),
          [np.array([[1.0, 3.0, 3.0, 2.0, 3.0], [2.0, 2.0, 1.0, 1.0, 5.0]],
                    np.float32)])
_same("cum", "logcumsumexp_dtype", lambda m, a: m.logcumsumexp(
    a, 1, dtype="float32"), _f((3, 4)))

# ----- the rest of math -----
MISC = {
    "diff": (lambda m, a: m.diff(a), [(3, 5)]),
    "diff_n2_axis0": (lambda m, a: m.diff(a, 2, 0), [(5, 3)]),
    "diff_prepend_scalar": (lambda m, a: m.diff(a, prepend=1.0,
                                                append=2.0), [(3, 5)]),
    "diff_prepend_tensor": (lambda m, a, p: m.diff(a, 1, 0, prepend=p),
                            [(3, 5), (2, 5)]),
    "trace": (lambda m, a: m.trace(a), [(4, 5)]),
    "trace_offset": (lambda m, a: m.trace(a, 1, 1, 2), [(2, 4, 5)]),
    "add_n": (lambda m, a, b, c: m.add_n([a, b, c]), [(3, 4)] * 3),
    "add_n_one": (lambda m, a: m.add_n([a]), [(3, 4)]),
    "matmul": (lambda m, a, b: m.matmul(a, b), [(3, 4), (4, 5)]),
    "matmul_t": (lambda m, a, b: m.matmul(a, b, True, True),
                 [(2, 4, 3), (2, 5, 4)]),
    "matmul_vec": (lambda m, a, b: m.matmul(a, b, transpose_x=True),
                   [(4,), (4, 3)]),
    "mm": (lambda m, a, b: m.mm(a, b), [(3, 4), (4, 2)]),
    "bmm": (lambda m, a, b: m.bmm(a, b), [(2, 3, 4), (2, 4, 2)]),
    "dot": (lambda m, a, b: m.dot(a, b), [(3, 4), (3, 4)]),
    "inner": (lambda m, a, b: m.inner(a, b), [(3, 4), (2, 4)]),
    "outer": (lambda m, a, b: m.outer(a, b), [(3,), (2, 2)]),
    "kron": (lambda m, a, b: m.kron(a, b), [(2, 3), (3, 2)]),
    "mv": (lambda m, a, b: m.mv(a, b), [(3, 4), (4,)]),
    "addmm": (lambda m, i, a, b: m.addmm(i, a, b, 0.5, 2.0),
              [(3, 2), (3, 4), (4, 2)]),
    "cross": (lambda m, a, b: m.cross(a, b), [(4, 3), (4, 3)]),
    "cross_axis": (lambda m, a, b: m.cross(a, b, axis=0), [(3, 4), (3, 4)]),
    "trapezoid": (lambda m, a: m.trapezoid(a), [(3, 5)]),
    "trapezoid_dx": (lambda m, a: m.trapezoid(a, dx=0.5, axis=0), [(3, 5)]),
    "trapezoid_x": (lambda m, a, b: m.trapezoid(a, b), [(3, 5), (3, 5)]),
    "cumulative_trapezoid": (lambda m, a: m.cumulative_trapezoid(a),
                             [(3, 5)]),
    "cumulative_trapezoid_x": (lambda m, a, b: m.cumulative_trapezoid(
        a, b, axis=0), [(4, 3), (4, 3)]),
    "cumulative_trapezoid_dx": (lambda m, a: m.cumulative_trapezoid(
        a, dx=0.3), [(3, 5)]),
    "vander": (lambda m, a: m.vander(a), [(4,)]),
    "vander_n_inc": (lambda m, a: m.vander(a, 3, True), [(5,)]),
    "renorm": (lambda m, a: m.renorm(a, 2.0, 0, 1.5), [(3, 4)]),
    "renorm_p1": (lambda m, a: m.renorm(a, 1.0, 1, 2.0), [(3, 4, 2)]),
    "dist2": (lambda m, a, b: m.dist(a, b), [(3, 4), (4,)]),
    "dist1": (lambda m, a, b: m.dist(a, b, 1), [(3, 4), (3, 4)]),
    "dist3": (lambda m, a, b: m.dist(a, b, 3), [(3, 4), (3, 4)]),
    "dist_inf": (lambda m, a, b: m.dist(a, b, float("inf")),
                 [(3, 4), (3, 4)]),
    "dist_ninf": (lambda m, a, b: m.dist(a, b, float("-inf")),
                  [(3, 4), (3, 4)]),
    "inverse": (lambda m, a: m.inverse(a), [(4, 4)]),
    "multiplex": (lambda m, a, b, c: m.multiplex(
        [a, b, c], m.to_tensor(np.array([[2], [0], [1], [2]], np.int32))
        if m is J else torch.tensor([[2], [0], [1], [2]])), [(4, 3)] * 3),
    "einsum": (lambda m, a, b: m.einsum("ij,jk->ik", a, b), [(3, 4), (4, 2)]),
    "einsum_batch": (lambda m, a, b: m.einsum("bij,bkj->bik", a, b),
                     [(2, 3, 4), (2, 5, 4)]),
    "einsum_diag": (lambda m, a: m.einsum("ii->i", a), [(4, 4)]),
    "einsum_dot": (lambda m, a, b: m.einsum("i,i->", a, b), [(5,), (5,)]),
}
for _c, (_fn, _shapes) in MISC.items():
    _same("misc", _c, _fn, _f(*_shapes, seed=len(_c)))
_same("misc", "dist0", lambda m, a, b: m.dist(a, b, 0),
      [np.array([1.0, 2.0, 3.0], np.float32),
       np.array([1.0, 0.0, 3.0], np.float32)], False)
_same("misc", "allclose", lambda m, a, b: (m.allclose(a, a + 1e-7),
                                           m.allclose(a, b)),
      _f((3, 4), (3, 4)), False)
_same("misc", "isclose", lambda m, a, b: m.isclose(a, b, 0.5, 0.3),
      _f((3, 4), (3, 4)), False)
_same("misc", "isclose_nan", lambda m, a: (m.isclose(a, a),
                                           m.isclose(a, a, equal_nan=True)),
      [_NAN], False)
_same("misc", "equal_all", lambda m, a, b: (m.equal_all(a, a),
                                            m.equal_all(a, b)),
      _f((3, 4), (3, 4)), False)

# ----- creation -----


def _c(name, call, grad=False, arrays=()):
    _reg("creation", name, lambda *a: call(J, {}, *a),
         lambda *a: call(T, CPU, *a), list(arrays), grad)


_c("zeros", lambda m, d: m.zeros([2, 3], **d))
_c("zeros_int", lambda m, d: m.zeros([2], "int32", **d))
_c("zeros_int64", lambda m, d: m.zeros([2], "int64", **d))
_c("ones", lambda m, d: m.ones((3,), "float32", **d))
_c("ones_bool", lambda m, d: m.ones([2], "bool", **d))
_c("full_int", lambda m, d: m.full([2], 3, **d))
_c("full_bool", lambda m, d: m.full([2, 2], True, **d))
_c("full_float", lambda m, d: m.full([2, 3], 1.5, **d))
_c("full_dtype", lambda m, d: m.full([3], 2, "float32", **d))
_c("empty", lambda m, d: m.empty([2, 3], **d))
_c("arange_int", lambda m, d: m.arange(5, **d))
_c("arange_range", lambda m, d: m.arange(2, 11, 3, **d))
_c("arange_float", lambda m, d: m.arange(0.0, 1.0, 0.25, **d))
_c("arange_neg", lambda m, d: m.arange(5, -3, -2, **d))
_c("arange_dtype", lambda m, d: m.arange(4, dtype="float32", **d))
_c("linspace", lambda m, d: m.linspace(-1.0, 2.0, 7, **d))
_c("linspace_one", lambda m, d: m.linspace(3.0, 5.0, 1, **d))
_c("linspace_int", lambda m, d: m.linspace(0, 10, 4, "int32", **d))
_c("logspace", lambda m, d: m.logspace(0.0, 2.0, 5, **d))
_c("logspace_base2", lambda m, d: m.logspace(1.0, 4.0, 4, 2.0, **d))
_c("eye", lambda m, d: m.eye(3, **d))
_c("eye_rect", lambda m, d: m.eye(2, 4, "int32", **d))
_c("tril_indices", lambda m, d: m.tril_indices(4, 3, 0, **d))
_c("tril_indices_off", lambda m, d: m.tril_indices(3, None, -1, **d))
_c("triu_indices", lambda m, d: m.triu_indices(4, 5, 1, **d))
_c("like", lambda m, d, a: (m.zeros_like(a), m.ones_like(a, "int32"),
                            m.full_like(a, 2.5), m.empty_like(a),
                            m.full_like(a, 7, "int64")),
   arrays=_f((2, 3)))
_c("tril_triu", lambda m, d, a: (m.tril(a), m.triu(a, 1), m.tril(a, -1)),
   True, _f((4, 5)))
_c("diag_vec", lambda m, d, a: (m.diag(a), m.diag(a, 1), m.diag(a, -2)),
   True, _f((4,)))
_c("diag_pad", lambda m, d, a: m.diag(a, 1, 2.5), True, _f((3,)))
_c("diag_mat", lambda m, d, a: (m.diag(a), m.diag(a, 1), m.diag(a, -1)),
   True, _f((3, 4)))
_c("diagflat", lambda m, d, a: (m.diagflat(a), m.diagflat(a, -1)), True,
   _f((2, 2)))
_c("diag_embed", lambda m, d, a: m.diag_embed(a), True, _f((2, 3)))
_c("diag_embed_pos", lambda m, d, a: m.diag_embed(a, 1), True, _f((2, 3)))
_c("diag_embed_neg", lambda m, d, a: m.diag_embed(a, -1), True, _f((2, 3)))
_c("meshgrid", lambda m, d, a, b: m.meshgrid(a, b), True, _f((3,), (4,)))
_c("meshgrid_list", lambda m, d, a, b: m.meshgrid([a, b]), True,
   _f((2,), (3,)))
_c("assign_clone", lambda m, d, a: (m.assign(a), m.clone(a)), True,
   _f((3, 4)))
_c("complex_polar", lambda m, d, a, b: (m.complex(a, b), m.polar(
    m.abs(a), b)), False, _f((3,), (3,)))
_c("one_hot", lambda m, d: m.one_hot(
    paddle.to_tensor(np.array([0, 2, 1, 3], np.int32)) if m is J else
    torch.tensor([0, 2, 1, 3]), 4))

# ----- logic -----
CMP = ("equal", "not_equal", "greater_than", "greater_equal", "less_than",
       "less_equal")
for _n in CMP:
    _same("logic", _n, lambda m, a, b, n=_n: getattr(m, n)(
        a, m.floor(b)), [np.floor(_f((3, 4), seed=1)[0]),
                         _f((4,), seed=2)[0]], False)
    _same("logic", _n + "_scalar", lambda m, a, n=_n: getattr(m, n)(a, 1.0),
          [np.floor(_f((3, 4), seed=3)[0])], False)
    _same("logic", _n + "_int", lambda m, a, b, n=_n: getattr(m, n)(a, b),
          [_ints((3, 4), seed=1)[0], _ints((4,), seed=2)[0]], False)
for _n in ("logical_and", "logical_or", "logical_xor"):
    _same("logic", _n, lambda m, a, b, n=_n: getattr(m, n)(a > 0, b > 0),
          _f((3, 4), (4,)), False)
    _same("logic", _n + "_float", lambda m, a, b, n=_n: getattr(m, n)(a, b),
          [np.array([0.0, 1.0, 2.0, 0.0], np.float32),
           np.array([0.0, 0.0, 3.0, 1.0], np.float32)], False)
_same("logic", "logical_not", lambda m, a: m.logical_not(a > 0), _f((3, 4)),
      False)
for _n in ("bitwise_and", "bitwise_or", "bitwise_xor"):
    _same("logic", _n, lambda m, a, b, n=_n: getattr(m, n)(a, b),
          _ints((3, 4), (4,), lo=-20, hi=20), False)
    _same("logic", _n + "_bool", lambda m, a, b, n=_n: getattr(m, n)(
        a > 0, b > 0), _ints((3, 4), (4,)), False)
_same("logic", "bitwise_not", lambda m, a: (m.bitwise_not(a),
                                            m.bitwise_not(a > 0)),
      _ints((3, 4)), False)
_same("logic", "shifts", lambda m, a, b: (m.bitwise_left_shift(a, b),
                                          m.bitwise_right_shift(a, b)),
      [_ints((3, 4), lo=-50, hi=50)[0], _ints((4,), lo=0, hi=4)[0]], False)
for _ax, _tag in ((None, "all"), (1, "ax1"), ([0, 2], "list")):
    for _kd in (False, True):
        _same("logic", f"all_any_{_tag}_{int(_kd)}",
              lambda m, a, ax=_ax, kd=_kd: (m.all(a > -1, ax, kd),
                                            m.any(a > 1.5, ax, kd)),
              _f((2, 3, 4)), False)
_same("logic", "is_empty", lambda m, a: m.is_empty(a), _f((2, 3)), False)
_same("logic", "attribute", lambda m, a: (
    m.shape_fn(a), m.rank(a), m.numel(a), m.shape(a)), _f((2, 3, 4)), False)
_same("logic", "stat", lambda m, a: (
    m.stat.mean(a, 1), m.stat.std(a), m.stat.var(a, 0), m.stat.median(a),
    m.stat.quantile(a, 0.3), m.stat.nanmedian(a, 1), m.stat.nansum(a),
    m.stat.nanmean(a), m.stat.numel(a)), _f((3, 4)), False)


# AMP: a function named as a JAX op casts its inputs under the scope's
# rule (O1: the white list to bf16, the black list to f32; O2: every named
# op to bf16 but the black list)
AMP_REL = 1e-2          # bf16 results: a bf16 ulp apart at most


def _amp(level, call):
    def run(pkg, mod, *a):
        with pkg.amp.auto_cast(level=level, dtype="bfloat16"):
            return call(mod, *a)
    return run


for _lvl in ("O1", "O2"):
    for _n, _call in {
            "add": lambda m, a, b: m.add(a, b),
            "exp_sum": lambda m, a, b: (m.exp(a), m.sum(b), m.mean(a, 1)),
            "matmul_einsum": lambda m, a, b: (
                m.matmul(a, b, transpose_y=True),
                m.einsum("ij,kj->ik", a, b)),
            "sort_cumsum": lambda m, a, b: (m.sort(a), m.cumsum(b, 1)),
            "tril_clip": lambda m, a, b: (m.tril(a), m.clip(b, -1.0, 1.0))
    }.items():
        _amp_run = _amp(_lvl, _call)
        _reg("amp", f"{_lvl}_{_n}",
             lambda *a, r=_amp_run: r(paddle, J, *a),
             lambda *a, r=_amp_run: r(pt, T, *a), _f((3, 4), (3, 4)), False)

# JAX's ``dist`` branches on ``jnp.isinf(p)``, which cannot be traced
EAGER = {k for k in CASES if k.startswith("misc|dist")}


@pytest.fixture(scope="module")
def jax_refs():
    return jax_table(CASES, EAGER)


def _keys(family):
    return sorted(k for k in CASES if k.startswith(family + "|"))


def _rel(key):
    name = key.split("|")[1]
    special = ("gamma", "digamma", "lgamma", "i0", "i1", "erfinv",
               "polygamma", "logaddexp", "logcumsumexp")
    return SPECIAL_REL if any(s in name for s in special) else 1e-5


@pytest.mark.parametrize("key", _keys("unary"))
def test_unary_matches_jax(jax_refs, key):
    check_case(jax_refs, key, _rel(key))


@pytest.mark.parametrize("key", _keys("edge"))
def test_special_functions_at_their_edges_match_jax(jax_refs, key):
    check_case(jax_refs, key, _rel(key))


@pytest.mark.parametrize("key", _keys("binary"))
def test_binary_matches_jax(jax_refs, key):
    check_case(jax_refs, key, _rel(key))


@pytest.mark.parametrize("key", _keys("int"))
def test_integer_dtypes_match_jax(jax_refs, key):
    check_case(jax_refs, key)


@pytest.mark.parametrize("key", _keys("reduce"))
def test_reduction_matches_jax(jax_refs, key):
    check_case(jax_refs, key)


@pytest.mark.parametrize("key", _keys("cum"))
def test_cumulative_matches_jax(jax_refs, key):
    check_case(jax_refs, key, _rel(key))


@pytest.mark.parametrize("key", _keys("misc"))
def test_math_matches_jax(jax_refs, key):
    check_case(jax_refs, key)


@pytest.mark.parametrize("key", _keys("creation"))
def test_creation_matches_jax(jax_refs, key):
    check_case(jax_refs, key)


@pytest.mark.parametrize("key", _keys("amp"))
def test_amp_casts_match_jax(jax_refs, key):
    check_case(jax_refs, key, AMP_REL)


@pytest.mark.parametrize("key", _keys("logic"))
def test_logic_attribute_stat_match_jax(jax_refs, key):
    check_case(jax_refs, key)


def test_round_is_half_to_even_as_jax():
    """JAX's ``round`` is ``jnp.round`` (half to even); upstream Paddle
    rounds half away from zero.  The port follows JAX."""
    x = np.array([0.5, 1.5, 2.5, -0.5, -2.5], np.float32)
    want = np.array([0.0, 2.0, 2.0, -0.0, -2.0], np.float32)
    np.testing.assert_array_equal(J.round(paddle.to_tensor(x)).numpy(), want)
    np.testing.assert_array_equal(T.round(torch.from_numpy(x)).numpy(), want)


def test_host_read_functions_match_jax():
    """The functions that read their data on the host, run eagerly."""
    x = np.array([0, 3, 1, 3, 5, 1, 3], np.int32)
    w = np.random.RandomState(0).rand(7).astype(np.float32)
    jx, tx = paddle.to_tensor(x), torch.from_numpy(x)
    compare(T.bincount(tx), J.bincount(jx), "bincount")
    compare(T.bincount(tx, minlength=9), J.bincount(jx, minlength=9),
            "bincount minlength")
    compare(T.bincount(tx, torch.from_numpy(w)),
            J.bincount(jx, paddle.to_tensor(w)), "bincount weights")
    with pytest.raises(ValueError):
        T.bincount(torch.tensor([1, -1]))
    v = np.arange(4).astype(np.float32)
    for r, rep in ((2, False), (3, False), (2, True)):
        compare(T.combinations(torch.from_numpy(v), r, rep),
                J.combinations(paddle.to_tensor(v), r, rep),
                f"combinations {r} {rep}")
    for start, val in ((np.int32, 1.0), (np.float32, 2)):
        a = np.array([1, 2], start)
        jt, tt = paddle.to_tensor(a), torch.from_numpy(a.copy())
        J.increment(jt, val)
        assert T.increment(tt, val) is tt
        compare(tt, jt, f"increment {start.__name__}")
    f = np.ones((2, 3), np.float32)
    for fn in ("is_complex", "is_floating_point", "is_integer"):
        for a in (f, f.astype(np.int32), f > 0):
            assert (getattr(T, fn)(torch.from_numpy(a))
                    == bool(getattr(J, fn)(paddle.to_tensor(a)))), (fn, a.dtype)
    assert T.is_tensor(torch.zeros(1)) and not T.is_tensor(np.zeros(1))
    assert T.in_dynamic_mode() is True


def test_number_on_the_left_and_device_rules():
    """A number on the left becomes a tensor beside the right operand;
    creation functions take ``device=`` and build on the card by
    default, which raises without one."""
    y = torch.tensor([1.0, 2.0])
    assert T.subtract(3, y).tolist() == [2.0, 1.0]
    assert T.add(2, torch.tensor([1, 2], dtype=torch.int32)).dtype == \
        torch.int32
    if not torch.cuda.is_available():
        for fn in (lambda: T.zeros([2]), lambda: T.arange(3),
                   lambda: T.eye(2), lambda: T.full([1], 1.0),
                   lambda: T.linspace(0.0, 1.0, 3),
                   lambda: T.tril_indices(3)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                fn()


def _jax_import_lists():
    """Every name JAX's ``tensor/__init__.py`` imports from its modules
    (``shape as shape_fn`` under its alias)."""
    src = pathlib.Path(J.__file__).read_text()
    names = set()
    for node in ast.parse(src).body:
        if isinstance(node, ast.ImportFrom) and node.level == 1 \
                and node.module:
            names |= {a.asname or a.name for a in node.names}
    return names


def test_export_sets_match_jax():
    """The port's ``tensor`` exports every name of JAX's import lists
    (and ``manipulation``); its root re-exports each, as JAX's ``from
    .tensor import *``; ``torch.Tensor`` is not patched."""
    want = _jax_import_lists()
    assert len(want) > 290
    assert set(T.__all__) - {"manipulation"} == want
    assert {n for n in want if not hasattr(pt, n)} == set()
    assert {n for n in want if not hasattr(paddle, n)} == set()
    for n in ("seed", "get_rng_state", "set_rng_state", "linalg", "fft",
              "signal"):
        assert hasattr(pt, n), n
    assert pt.random.__name__ == "paddle_tpu_torch.random"
    for n in ("mod", "pow", "norm", "topk", "cummax", "logsumexp"):
        assert getattr(torch.Tensor, n, None) is not getattr(T, n), n
    x = torch.tensor([5.0, -3.0])
    assert (x % 2).tolist() == [1.0, 1.0]    # torch's operator
    assert T.shape_fn is T.shape
