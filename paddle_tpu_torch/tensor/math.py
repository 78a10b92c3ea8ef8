"""Math functions, the counterparts of ``paddle_tpu/tensor/math.py`` (all
of ``paddle_tpu/tensor/__init__.py:17-33``).

Each runs where its tensors lie.  A binary function takes a tensor and a
tensor or a Python number (a number on the left becomes a tensor on the
other operand's device, int32 or the default float dtype as JAX's
``to_tensor``); numbers keep torch's scalar promotion, which is JAX's
weak typing.  Integer results are int32 where JAX's are (``sum``,
``cumsum``, ``prod``, ``count_nonzero``, ``cummax``'s indices, ...: x64
off), and a function the JAX package names as an op asks
:func:`~paddle_tpu_torch.amp.auto_cast.cast_inputs` for its inputs'
dtype under that name.

JAX's rules, kept where Paddle's differ (``ROADMAP.md`` Queue 3):
``round`` rounds half to even; ``prod`` and ``nansum`` ignore ``dtype``;
``cumsum``/``cumprod``/``logcumsumexp`` flatten when the axis is None;
``cummax``/``cummin`` take the last index among equal extremes;
``increment`` replaces the tensor's data (an int tensor plus 1.0 turns
float).  The special functions compute ``jax.scipy.special``'s: torch's
where it agrees on the whole domain, and JAX's value at the edges where
it does not (``digamma`` is NaN at 0, ``polygamma`` +inf for odd n and
NaN for even n at the non-positive integers, ``angle(-0.0)`` is pi).
"""

from __future__ import annotations

import builtins
import itertools
import math as _math

import numpy as np
import torch
import torch.nn.functional as TF

from ..amp.auto_cast import cast_inputs
from .creation import as_int32

__all__ = [
    "abs", "acos", "acosh", "add", "add_n", "addmm", "allclose", "amax",
    "amin", "angle", "asin", "asinh", "atan", "atan2", "atanh", "bincount",
    "bmm", "ceil", "clip", "combinations", "conj", "copysign", "cos",
    "cosh", "count_nonzero", "cross", "cummax", "cummin", "cumprod",
    "cumsum", "cumulative_trapezoid", "deg2rad", "diff", "digamma", "dist",
    "divide", "dot", "equal_all", "erf", "erfinv", "exp", "expm1",
    "floor", "floor_divide", "floor_mod", "fmax", "fmin", "frac", "frexp",
    "gammainc", "gammaincc", "gammaln", "gcd", "heaviside", "hypot", "i0",
    "i0e", "i1", "i1e", "imag", "increment", "inner", "inverse",
    "isclose", "isfinite", "isinf", "isnan", "kron", "lcm", "ldexp",
    "lerp", "lgamma", "log", "log10", "log1p", "log2", "logaddexp",
    "logcumsumexp", "logit", "logsigmoid", "logsumexp", "matmul", "max",
    "maximum", "mean", "min", "minimum", "mm", "mod", "multiplex",
    "multiply", "mv", "nan_to_num", "nanmean", "nansum", "neg", "negative",
    "nextafter", "outer", "polygamma", "positive", "pow", "prod",
    "rad2deg", "real", "reciprocal", "remainder", "renorm", "round",
    "rsqrt", "scale", "sgn", "sigmoid", "sign", "signbit", "sin", "sinh",
    "sqrt", "square", "stanh", "std", "subtract", "sum", "tan", "tanh",
    "trace", "trapezoid", "trunc", "var", "vander",
]


def _tensor_like(v, ref):
    """A Python number as a 0-d tensor on ``ref``'s device (JAX's
    ``to_tensor``: bool, int32 or the default float dtype)."""
    if isinstance(v, torch.Tensor):
        return v
    dt = (torch.bool if isinstance(v, bool) else torch.int32
          if isinstance(v, (int, np.integer)) else None)
    return torch.tensor(v, dtype=dt, device=ref.device)


def _binary(fn, x, y, name):
    """``fn(x, y)`` after JAX's op cast; ``y`` may stay a number."""
    if not isinstance(x, torch.Tensor):
        x = _tensor_like(x, y)
    if isinstance(y, torch.Tensor):
        x, y = cast_inputs(name, x, y)
    else:
        (x,) = cast_inputs(name, x)
    return as_int32(fn(x, y))


def _unary(fn, x, name):
    (x,) = cast_inputs(name, x)
    return as_int32(fn(x))


def _operand(v, ref):
    """``v`` as a tensor beside ``ref`` (for torch functions that take
    no numbers)."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.full((), v, dtype=ref.dtype, device=ref.device)


# ----- elementwise binary -----
def add(x, y):
    return _binary(torch.add, x, y, "add")


def subtract(x, y):
    return _binary(torch.subtract, x, y, "subtract")


def multiply(x, y):
    return _binary(torch.multiply, x, y, "multiply")


def divide(x, y):
    return _binary(torch.true_divide, x, y, "divide")


def floor_divide(x, y):
    return _binary(torch.floor_divide, x, y, "floor_divide")


def remainder(x, y):
    return _binary(torch.remainder, x, y, "remainder")


mod = remainder
floor_mod = remainder


def pow(x, y):
    return _binary(torch.pow, x, y, "pow")


def maximum(x, y):
    return _binary(lambda a, b: torch.maximum(a, _operand(b, a)), x, y,
                   "maximum")


def minimum(x, y):
    return _binary(lambda a, b: torch.minimum(a, _operand(b, a)), x, y,
                   "minimum")


def fmax(x, y):
    return _binary(lambda a, b: torch.fmax(a, _operand(b, a)), x, y, "fmax")


def fmin(x, y):
    return _binary(lambda a, b: torch.fmin(a, _operand(b, a)), x, y, "fmin")


def atan2(x, y):
    return _binary(lambda a, b: torch.atan2(a, _operand(b, a)), x, y,
                   "atan2")


def hypot(x, y):
    return _binary(lambda a, b: torch.hypot(a, _operand(b, a)), x, y,
                   "hypot")


def gcd(x, y):
    return _binary(lambda a, b: torch.gcd(a, _operand(b, a)), x, y, "gcd")


def lcm(x, y):
    return _binary(lambda a, b: torch.lcm(a, _operand(b, a)), x, y, "lcm")


def heaviside(x, y):
    """``y`` where ``x`` is 0, else 0 below and 1 above (``jnp``'s)."""
    def f(a, b):
        b = _operand(b, a)
        return torch.where(a < 0, torch.zeros_like(a),
                           torch.where(a > 0, torch.ones_like(a), b))
    return _binary(f, x, y, "heaviside")


def nextafter(x, y):
    return _binary(lambda a, b: torch.nextafter(a, _operand(b, a)), x, y,
                   "nextafter")


def copysign(x, y):
    return _binary(torch.copysign, x, y, "copysign")


def ldexp(x, y):
    """``x * 2.0 ** y``."""
    return _binary(lambda a, b: a * (2.0 ** b), x, y, "ldexp")


def logaddexp(x, y):
    return _binary(lambda a, b: torch.logaddexp(a, _operand(b, a)), x, y,
                   "logaddexp")


# ----- elementwise unary -----
def sqrt(x):
    return _unary(torch.sqrt, x, "sqrt")


def rsqrt(x):
    return _unary(torch.rsqrt, x, "rsqrt")


def square(x):
    return _unary(torch.square, x, "square")


def exp(x):
    return _unary(torch.exp, x, "exp")


def expm1(x):
    return _unary(torch.expm1, x, "expm1")


def log(x):
    return _unary(torch.log, x, "log")


def log2(x):
    return _unary(torch.log2, x, "log2")


def log10(x):
    return _unary(torch.log10, x, "log10")


def log1p(x):
    return _unary(torch.log1p, x, "log1p")


def abs(x):
    return _unary(torch.abs, x, "absolute")


def neg(x):
    return _unary(torch.negative, x, "neg")


negative = neg


def sign(x):
    return _unary(torch.sign, x, "sign")


def sgn(x):
    return _unary(torch.sgn, x, "sign")


def sin(x):
    return _unary(torch.sin, x, "sin")


def cos(x):
    return _unary(torch.cos, x, "cos")


def tan(x):
    return _unary(torch.tan, x, "tan")


def asin(x):
    return _unary(torch.asin, x, "asin")


def acos(x):
    return _unary(torch.acos, x, "acos")


def atan(x):
    return _unary(torch.atan, x, "atan")


def sinh(x):
    return _unary(torch.sinh, x, "sinh")


def cosh(x):
    return _unary(torch.cosh, x, "cosh")


def tanh(x):
    return _unary(torch.tanh, x, "tanh")


def asinh(x):
    return _unary(torch.asinh, x, "asinh")


def acosh(x):
    return _unary(torch.acosh, x, "acosh")


def atanh(x):
    return _unary(torch.atanh, x, "atanh")


def floor(x):
    return _unary(torch.floor, x, "floor")


def ceil(x):
    return _unary(torch.ceil, x, "ceil")


def round(x):
    """Half to even (``jnp.round``): 0.5 -> 0, 2.5 -> 2, -0.5 -> -0."""
    return _unary(torch.round, x, "round")


def trunc(x):
    return _unary(torch.trunc, x, "trunc")


def frac(x):
    return _unary(lambda a: a - torch.trunc(a), x, "frac")


def reciprocal(x):
    return _unary(torch.reciprocal, x, "reciprocal")


def sigmoid(x):
    return _unary(torch.sigmoid, x, "sigmoid")


def logsigmoid(x):
    return _unary(TF.logsigmoid, x, "logsigmoid")


def erf(x):
    return _unary(torch.erf, x, "erf")


def erfinv(x):
    return _unary(torch.erfinv, x, "erfinv")


def lgamma(x):
    return _unary(torch.lgamma, x, "lgamma")


def gammaln(x):
    return _unary(torch.lgamma, x, "gammaln")


def _digamma(a):
    # jax.scipy.special.digamma is NaN at 0 (torch: -inf, or +inf at -0)
    return torch.where(a == 0, torch.full_like(a, _math.nan),
                       torch.digamma(a))


def digamma(x):
    return _unary(_digamma, x, "digamma")


def gammainc(x, y):
    """The regularized lower incomplete gamma ``P(x, y)``."""
    return _binary(lambda a, b: torch.special.gammainc(a, _operand(b, a)),
                   x, y, "gammainc")


def gammaincc(x, y):
    """The regularized upper incomplete gamma ``Q(x, y)``."""
    return _binary(lambda a, b: torch.special.gammaincc(a, _operand(b, a)),
                   x, y, "gammaincc")


def i0(x):
    return _unary(torch.special.i0, x, "i0")


def i0e(x):
    return _unary(torch.special.i0e, x, "i0e")


def i1(x):
    return _unary(torch.special.i1, x, "i1")


def i1e(x):
    return _unary(torch.special.i1e, x, "i1e")


def polygamma(x, n):
    """``jax.scipy.special.polygamma(n, x)``: ``digamma`` at n = 0; at
    the non-positive integers +inf for odd n and NaN for even n."""
    def f(a):
        if n == 0:
            return _digamma(a)
        out = torch.special.polygamma(n, a)
        pole = (a <= 0) & (a == torch.floor(a))
        return torch.where(pole, torch.full_like(
            out, _math.inf if n % 2 else _math.nan), out)
    (x,) = cast_inputs("polygamma", x)
    return f(x)


def angle(x):
    """The argument; for real ``x`` ``atan2(0, x)`` (pi at -0.0)."""
    def f(a):
        if a.is_complex():
            return torch.angle(a)
        a = a if a.is_floating_point() else a.to(torch.get_default_dtype())
        return torch.atan2(torch.zeros_like(a), a)
    return _unary(f, x, "angle")


def conj(x):
    return _unary(lambda a: torch.conj(a).resolve_conj(), x, "conj")


def real(x):
    return _unary(lambda a: torch.real(a) if a.is_complex() else a, x,
                  "real")


def imag(x):
    return _unary(lambda a: torch.imag(a) if a.is_complex()
                  else torch.zeros_like(a), x, "imag")


def deg2rad(x):
    return _unary(torch.deg2rad, x, "deg2rad")


def rad2deg(x):
    return _unary(torch.rad2deg, x, "rad2deg")


def isnan(x):
    return _unary(torch.isnan, x, "isnan")


def isinf(x):
    return _unary(torch.isinf, x, "isinf")


def isfinite(x):
    return _unary(torch.isfinite, x, "isfinite")


def nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return _unary(lambda a: torch.nan_to_num(a, nan, posinf, neginf), x,
                  "nan_to_num")


def clip(x, min=None, max=None):
    """``minimum(maximum(x, min), max)``; either bound may be None."""
    if min is None and max is None:
        return _unary(lambda a: a, x, "clip")
    return _unary(lambda a: torch.clamp(a, min, max), x, "clip")


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None):
    if bias_after_scale:
        return _unary(lambda a: a * scale + bias, x, "scale")
    return _unary(lambda a: (a + bias) * scale, x, "scale")


def stanh(x, scale_a=0.67, scale_b=1.7159):
    return _unary(lambda a: scale_b * torch.tanh(scale_a * a), x, "stanh")


def lerp(x, y, weight):
    """``x + weight * (y - x)``."""
    x, y = cast_inputs("lerp", x, y)
    return x + weight * (y - x)


# ----- reductions -----
def _dims(x, axis):
    """The reduced dims as a tuple (every dim for None)."""
    if axis is None:
        return tuple(range(x.dim()))
    if isinstance(axis, torch.Tensor):
        return tuple(int(a) for a in axis.reshape(-1).tolist())
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return (int(axis),)


def _floating(a):
    return a if a.is_floating_point() or a.is_complex() else a.to(
        torch.get_default_dtype())


def sum(x, axis=None, dtype=None, keepdim=False):
    from .creation import jax_dtype

    dt = None if dtype is None else jax_dtype(dtype)
    return _unary(lambda a: torch.sum(a, _dims(a, axis), keepdim=keepdim,
                                      dtype=dt), x, "sum")


def nansum(x, axis=None, dtype=None, keepdim=False):
    """``dtype`` is ignored, as JAX's."""
    return _unary(lambda a: torch.nansum(a, _dims(a, axis), keepdim=keepdim),
                  x, "nansum")


def mean(x, axis=None, keepdim=False):
    return _unary(lambda a: torch.mean(_floating(a), _dims(a, axis),
                                       keepdim=keepdim), x, "mean")


def nanmean(x, axis=None, keepdim=False):
    return _unary(lambda a: torch.nanmean(_floating(a), _dims(a, axis),
                                          keepdim=keepdim), x, "nanmean")


def max(x, axis=None, keepdim=False):
    """The largest values (a gradient shared among equal maxima)."""
    return _unary(lambda a: torch.amax(a, _dims(a, axis), keepdim=keepdim),
                  x, "max")


def min(x, axis=None, keepdim=False):
    return _unary(lambda a: torch.amin(a, _dims(a, axis), keepdim=keepdim),
                  x, "min")


def amax(x, axis=None, keepdim=False):
    return max(x, axis, keepdim)


def amin(x, axis=None, keepdim=False):
    return min(x, axis, keepdim)


def prod(x, axis=None, keepdim=False, dtype=None):
    """``dtype`` is ignored, as JAX's."""
    def f(a):
        for d in sorted((d % builtins.max(a.dim(), 1) for d in
                         _dims(a, axis)), reverse=True):
            a = torch.prod(a, d, keepdim=keepdim)
        return a
    return _unary(f, x, "prod")


def std(x, axis=None, unbiased=True, keepdim=False):
    return _unary(lambda a: torch.std(_floating(a), _dims(a, axis),
                                      correction=int(unbiased),
                                      keepdim=keepdim), x, "std")


def var(x, axis=None, unbiased=True, keepdim=False):
    return _unary(lambda a: torch.var(_floating(a), _dims(a, axis),
                                      correction=int(unbiased),
                                      keepdim=keepdim), x, "var")


def logsumexp(x, axis=None, keepdim=False):
    return _unary(lambda a: torch.logsumexp(_floating(a), _dims(a, axis),
                                            keepdim=keepdim), x,
                  "logsumexp")


def _along(a, axis):
    """``(a, dim)``: ``a`` flattened with dim 0 for a None axis."""
    return (a.reshape(-1), 0) if axis is None else (a, int(axis))


def cumsum(x, axis=None, dtype=None):
    """Over the flattened tensor when ``axis`` is None; ``dtype`` is
    ignored, as JAX's."""
    return _unary(lambda a: torch.cumsum(*_along(a, axis)), x, "cumsum")


def cumprod(x, dim=None, dtype=None):
    return _unary(lambda a: torch.cumprod(*_along(a, dim)), x, "cumprod")


def _cum_extreme(x, axis, fn):
    a, d = _along(x, axis)
    vals = fn(a, d).values
    n = a.shape[d]
    shape = [1] * a.dim()
    shape[d] = n
    pos = torch.arange(n, device=a.device).reshape(shape)
    # the last index where the running extreme is reached (JAX's scan
    # takes the later of two equal values)
    hit = torch.where(a == vals, pos, torch.full_like(pos, -1))
    idx = torch.cummax(hit.expand_as(a), d).values
    return torch.gather(a, d, idx), idx.to(torch.int32)


def cummax(x, axis=None, dtype=None):
    """Running maxima and their indices (the last among equals)."""
    return _cum_extreme(x, axis, torch.cummax)


def cummin(x, axis=None, dtype=None):
    return _cum_extreme(x, axis, torch.cummin)


def count_nonzero(x, axis=None, keepdim=False):
    return _unary(lambda a: torch.sum(a != 0, _dims(a, axis),
                                      keepdim=keepdim), x, "count_nonzero")


def _edge(v, a, axis):
    """``prepend``/``append`` as a tensor ``diff`` can concatenate: a
    number broadcast to one slice of ``a`` along ``axis``."""
    if v is None:
        return None
    v = _operand(v, a)
    if v.dim() == 0:
        shape = list(a.shape)
        shape[axis] = 1
        v = v.expand(shape)
    return v


def diff(x, n=1, axis=-1, prepend=None, append=None):
    return _unary(lambda a: torch.diff(a, n, axis, _edge(prepend, a, axis),
                                       _edge(append, a, axis)), x, "diff")


def trace(x, offset=0, axis1=0, axis2=1):
    return _unary(lambda a: torch.diagonal(a, offset, axis1, axis2).sum(-1),
                  x, "trace")


def add_n(inputs):
    if isinstance(inputs, torch.Tensor):
        return inputs
    xs = cast_inputs("add_n", *inputs)
    return xs[0] if len(xs) == 1 else torch.stack(xs).sum(0)


# ----- matmul family -----
def matmul(x, y, transpose_x=False, transpose_y=False):
    """``x @ y``, with the last two dims of either transposed first (a
    1-D operand is not transposed)."""
    x, y = cast_inputs("matmul", x, y)
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def mm(x, y):
    return matmul(x, y)


def bmm(x, y):
    return matmul(x, y)


def dot(x, y):
    """``sum(x * y, -1)``."""
    x, y = cast_inputs("dot", x, y)
    return torch.sum(x * y, -1)


def inner(x, y):
    x, y = cast_inputs("inner", x, y)
    return torch.inner(x, y)


def outer(x, y):
    x, y = cast_inputs("outer", x, y)
    return torch.outer(x.reshape(-1), y.reshape(-1))


def kron(x, y):
    x, y = cast_inputs("kron", x, y)
    return torch.kron(x, y)


def mv(x, vec):
    x, vec = cast_inputs("mv", x, vec)
    return torch.matmul(x, vec)


def addmm(input, x, y, beta=1.0, alpha=1.0):
    """``beta * input + alpha * (x @ y)``."""
    input, x, y = cast_inputs("addmm", input, x, y)
    return beta * input + alpha * (x @ y)


def cross(x, y, axis=None):
    x, y = cast_inputs("cross", x, y)
    return torch.linalg.cross(x, y, dim=-1 if axis is None else axis)


# ----- comparisons that return values -----
def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    """A 0-d bool tensor."""
    return torch.isclose(x, y, rtol, atol, equal_nan).all()


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    return torch.isclose(x, y, rtol, atol, equal_nan)


def equal_all(x, y):
    """A 0-d bool tensor: equal shapes and every element equal."""
    if x.shape != y.shape:
        return torch.zeros((), dtype=torch.bool, device=x.device)
    return (x == y).all()


def increment(x, value=1.0):
    """``x``'s data replaced by ``x + value`` (its dtype follows the
    sum, as JAX's)."""
    x.data = (x.detach() + value)
    return x


def multiplex(inputs, index):
    """Row r of the output is row r of ``inputs[index[r]]``."""
    xs = cast_inputs("multiplex", *inputs)
    stacked = torch.stack(xs)
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    return stacked[index.reshape(-1).long(), rows]


def bincount(x, weights=None, minlength=0):
    """Counts (int32) or summed ``weights`` of each value of a
    non-negative 1-D ``x``; the length, read on the host, is
    ``max(x) + 1`` or ``minlength``."""
    if x.numel() and int(x.min()) < 0:
        raise ValueError("bincount: input must be non-negative")
    n = int(x.max()) + 1 if x.numel() else 0
    n = builtins.max(n, int(minlength))
    if weights is None:
        return torch.bincount(x.long(), minlength=n).to(torch.int32)
    (weights,) = cast_inputs("bincount", weights)
    out = torch.zeros(n, dtype=weights.dtype, device=weights.device)
    return out.index_add(0, x.long(), weights)


def trapezoid(y, x=None, dx=None, axis=-1):
    (y,) = cast_inputs("trapezoid", y)
    if x is not None:
        return torch.trapezoid(y, x, dim=axis)
    return torch.trapezoid(y, dx=1.0 if dx is None else dx, dim=axis)


def cumulative_trapezoid(y, x=None, dx=None, axis=-1):
    """The running trapezoid sums ``cumsum(mean of neighbours * step)``."""
    (y,) = cast_inputs("cumulative_trapezoid", y)
    a = torch.movedim(y, axis, -1)
    mids = (a[..., 1:] + a[..., :-1]) / 2.0
    if x is not None:
        xv = torch.movedim(x, axis, -1)
        steps = xv[..., 1:] - xv[..., :-1]
    else:
        steps = 1.0 if dx is None else dx
    return torch.movedim(torch.cumsum(mids * steps, -1), -1, axis)


def vander(x, n=None, increasing=False):
    """``x[:, None] ** powers``, the powers falling unless
    ``increasing``."""
    (x,) = cast_inputs("vander", x)
    cols = x.shape[0] if n is None else n
    powers = torch.arange(cols, device=x.device).to(x.dtype)
    if not increasing:
        powers = (cols - 1) - powers
    return torch.pow(x[..., None], powers)


def logcumsumexp(x, axis=None, dtype=None):
    """The running ``logaddexp`` (over the flattened tensor for a None
    axis), in ``dtype`` if given."""
    if dtype is not None:
        from .creation import jax_dtype

        x = x.to(jax_dtype(dtype))
    return torch.logcumsumexp(*_along(x, axis))


def frexp(x):
    """``(mantissa, exponent)``, the exponent in ``x``'s dtype."""
    m, e = torch.frexp(x)
    return m, e.to(x.dtype)


def renorm(x, p, axis, max_norm):
    """Each slice along ``axis`` whose p-norm exceeds ``max_norm``
    scaled to it (``max_norm / (norm + 1e-7)``)."""
    ax = axis % x.dim()
    dims = tuple(i for i in range(x.dim()) if i != ax)
    norms = torch.sum(torch.abs(x) ** p, dims, keepdim=True) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                         torch.ones_like(norms))
    return x * factor.to(x.dtype)


def logit(x, eps=None):
    """``log(x / (1 - x))``, ``x`` clipped to ``[eps, 1 - eps]`` first
    when ``eps`` is given."""
    def f(a):
        if eps is not None:
            a = torch.clamp(a, eps, 1.0 - eps)
        return torch.log(a / (1 - a))
    return _unary(f, x, "logit")


def signbit(x):
    return _unary(torch.signbit, x, "signbit")


def positive(x):
    return x


def dist(x, y, p=2):
    """The p-norm of ``x - y`` (p = 0 counts the nonzeros, +-inf takes
    the largest or smallest magnitude)."""
    x, y = cast_inputs("dist", x, y)
    d = (x - y).reshape(-1)
    if p == 0:
        return torch.sum(d != 0).to(x.dtype)
    if _math.isinf(p):
        return (torch.max(torch.abs(d)) if p > 0 else
                torch.min(torch.abs(d))).to(x.dtype)
    return torch.sum(torch.abs(d) ** p) ** (1.0 / p)


def inverse(x):
    from .linalg import inv

    return inv(x)


def combinations(x, r=2, with_replacement=False):
    """Every r-combination of a 1-D tensor's elements, in
    ``itertools``' order (indices made on the host)."""
    n = int(x.shape[0])
    it = (itertools.combinations_with_replacement(range(n), r)
          if with_replacement else itertools.combinations(range(n), r))
    idx = np.asarray(list(it), np.int64).reshape(-1, r)
    (x,) = cast_inputs("combinations", x)
    return x[torch.from_numpy(idx).to(x.device)]
