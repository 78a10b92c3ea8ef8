"""The port's ``autograd`` and ``incubate.autograd`` against the JAX
package's on the CPU, on numpy-seeded f32 inputs.

* ``PyLayer``: a cube, a two-output op with a non-Tensor argument, an
  input that stops the gradient, saved non-Tensor values, the custom
  backward honored under ``distributed.recompute``
  (``tests/test_autograd.py:194`` is the oracle), and an RMSNorm
  ``PyLayer`` over the kernel's forward and backward equal to
  ``rms_norm``'s own autograd path bit for bit.
* ``backward``, ``jacobian``, ``hessian``, ``jvp`` and ``vjp``: JAX's
  output structures (one input against a list, several outputs,
  ``v=None`` as ones) and values.  First-order transforms go through a
  port kernel's autograd function (``rms_norm``); ``hessian`` through
  one raises, as JAX's through a Pallas ``custom_vjp``.
* ``incubate.autograd.Jacobian``/``Hessian`` slicing and their rejected
  cases (``is_batched``, several inputs, several outputs).

Tolerance: the same f32 arithmetic on both sides; 1e-5 relative (XLA
may fuse a product and a sum that torch rounds apart), and exact where
the op is one rounding (the cube, the PyLayer gradients).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.autograd as JAG
import paddle_tpu.incubate.autograd as JIAG
from paddle_tpu.distributed.recompute import recompute as jax_recompute

import paddle_tpu_torch.autograd as AG
import paddle_tpu_torch.incubate.autograd as IAG
from paddle_tpu_torch.distributed.recompute import recompute
from paddle_tpu_torch.ops.rms_norm import (rms_norm, rms_norm_bwd,
                                           rms_norm_fwd)

from _torch_port_util import one_thread  # noqa: F401

RTOL = 1e-5


def _r(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _j(a, grad=False):
    t = paddle.to_tensor(a)
    t.stop_gradient = not grad
    return t


def _t(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t.numpy())


def _cube(base):
    class Cube(base):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x ** 3

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor()
            return dy * 3 * x ** 2

    return Cube


def _mul_add(base):
    """(x * y * scale, x + y); ``scale`` a Python float."""
    class MulAdd(base):
        @staticmethod
        def forward(ctx, x, y, scale):
            ctx.save_for_backward(x, y, scale)
            return x * y * scale, x + y

        @staticmethod
        def backward(ctx, da, db):
            x, y, scale = ctx.saved_tensor()
            return da * y * scale + db, da * x * scale + db

    return MulAdd


def test_pylayer_cube_matches_jax():
    a = _r(0, 3, 4)
    jx, tx = _j(a, True), _t(a, True)
    jy, ty = _cube(JAG.PyLayer).apply(jx), _cube(AG.PyLayer).apply(tx)
    (jy * 2.0).sum().backward()
    (ty * 2.0).sum().backward()
    np.testing.assert_array_equal(_np(ty), _np(jy))
    np.testing.assert_array_equal(_np(tx.grad), _np(jx.grad))


@pytest.mark.parametrize("stop_y", [False, True], ids=["both", "stop_y"])
def test_pylayer_two_outputs_non_tensor_argument_and_stop_gradient(stop_y):
    """Two outputs, a float passed through, and an input that stops the
    gradient: it gets none, the other input gets backward's first."""
    a, b = _r(1, 5), _r(2, 5)
    jx, jy = _j(a, True), _j(b, not stop_y)
    tx, ty = _t(a, True), _t(b, not stop_y)
    jo = _mul_add(JAG.PyLayer).apply(jx, jy, 0.5)
    to = _mul_add(AG.PyLayer).apply(tx, ty, 0.5)
    for j, t in zip(jo, to):
        np.testing.assert_array_equal(_np(t), _np(j))
    (jo[0].sum() + (jo[1] * 3.0).sum()).backward()
    (to[0].sum() + (to[1] * 3.0).sum()).backward()
    np.testing.assert_array_equal(_np(tx.grad), _np(jx.grad))
    if stop_y:
        assert ty.grad is None and jy.grad is None
    else:
        np.testing.assert_array_equal(_np(ty.grad), _np(jy.grad))


def test_pylayer_without_a_gradient_input_records_nothing():
    out = _cube(AG.PyLayer).apply(_t(_r(3, 4)))
    assert not out.requires_grad
    assert not AG.is_pylayer_op(out)
    assert AG.is_pylayer_op(_cube(AG.PyLayer)())


def test_custom_backward_honored_inside_recompute():
    """The oracle's TripleGrad: identity forward, backward times 3, under
    recompute on both sides: the gradient is 6, not AD's 2."""
    def triple(base):
        class TripleGrad(base):
            @staticmethod
            def forward(ctx, x):
                ctx.save_for_backward(x)
                return x * 1.0

            @staticmethod
            def backward(ctx, dy):
                return dy * 3.0

        return TripleGrad

    jt, tt = triple(JAG.PyLayer), triple(AG.PyLayer)
    a = np.array([1.0, 2.0], np.float32)
    jx, tx = _j(a, True), _t(a, True)
    jax_recompute(lambda x: jt.apply(x) * 2.0, jx).sum().backward()
    recompute(lambda x: tt.apply(x) * 2.0, tx).sum().backward()
    np.testing.assert_array_equal(_np(tx.grad), [6.0, 6.0])
    np.testing.assert_array_equal(_np(tx.grad), _np(jx.grad))


class RMSNormLayer(AG.PyLayer):
    """RMSNorm as a PyLayer over the kernel's forward and backward (the
    Triton kernels on a card tensor, their plain twins here)."""

    @staticmethod
    def forward(ctx, x, w, eps):
        y, rstd = rms_norm_fwd(x, w, eps)
        ctx.save_for_backward(x, w, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, rstd = ctx.saved_tensor()
        return rms_norm_bwd(x, w, rstd, dy.contiguous())


def test_rms_norm_pylayer_equals_the_kernel_path_bitwise():
    x0, w0, g = _r(4, 16, 64), _r(5, 64) + 1.0, _r(6, 16, 64)
    out = {}
    for name, fn in (("pylayer", lambda x, w: RMSNormLayer.apply(x, w, 1e-6)),
                     ("kernel", lambda x, w: rms_norm(x, w, 1e-6))):
        x, w = _t(x0, True), _t(w0, True)
        y = fn(x, w)
        y.backward(torch.from_numpy(g))
        out[name] = (y.detach(), x.grad, w.grad)
    for a, b in zip(out["pylayer"], out["kernel"]):
        assert torch.equal(a, b)


def test_backward_matches_jax():
    a, b = _r(7, 3), _r(8, 3)
    jx, tx = _j(a, True), _t(a, True)
    JAG.backward([(jx * jx).sum(), jx * 2.0],
                 [None, _j(b)])
    AG.backward([(tx * tx).sum(), tx * 2.0], [None, _t(b)])
    np.testing.assert_allclose(_np(tx.grad), _np(jx.grad), rtol=RTOL)


def _same(got, want):
    """Equal structure (tuple/list nesting) and values within RTOL."""
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    assert isinstance(got, torch.Tensor)
    w = _np(want)
    assert tuple(got.shape) == w.shape
    np.testing.assert_allclose(_np(got), w, rtol=RTOL, atol=1e-6)


FUNCS = {
    "one_in_one_out": (lambda x: x * x * x.sum(), 1, (4,)),
    "two_in_one_out": (lambda x, y: x * y + x.sum(), 2, (3,)),
    "one_in_two_out": (lambda x: (x * x, x.sum(0, keepdim=True)), 1, (2, 3)),
    "two_in_two_out": (lambda x, y: [x * y, x - y * y], 2, (3,)),
}


def _args(n, shape, seed, wrap):
    xs = [wrap(_r(seed + i, *shape)) for i in range(n)]
    return xs[0] if n == 1 else xs


@pytest.mark.parametrize("case", list(FUNCS))
def test_jacobian_jvp_vjp_match_jax(case):
    fn, n, shape = FUNCS[case]
    jfn = fn                            # the same code over JAX's Tensor
    jx, tx = _args(n, shape, 10, _j), _args(n, shape, 10, _t)
    _same(AG.jacobian(fn, tx), JAG.jacobian(jfn, jx))
    for v_seed in (None, 20):
        jv = None if v_seed is None else _args(n, shape, v_seed, _j)
        tv = None if v_seed is None else _args(n, shape, v_seed, _t)
        _same(AG.jvp(fn, tx, tv), JAG.jvp(jfn, jx, jv))
    # vjp's cotangent has the outputs' structure
    jout = JAG.vjp(jfn, jx)
    _same(AG.vjp(fn, tx), jout)
    outs = jout[0] if isinstance(jout[0], (tuple, list)) else [jout[0]]
    cot = [_r(30 + i, *_np(o).shape) for i, o in enumerate(outs)]
    jcot = [_j(c) for c in cot] if len(cot) > 1 else _j(cot[0])
    tcot = [_t(c) for c in cot] if len(cot) > 1 else _t(cot[0])
    _same(AG.vjp(fn, tx, tcot), JAG.vjp(jfn, jx, jcot))
    with pytest.raises(ValueError, match="leaves"):
        AG.vjp(fn, tx, [_t(c) for c in cot] + [_t(cot[0])])


@pytest.mark.parametrize("n", [1, 2], ids=["one_in", "two_in"])
def test_hessian_matches_jax(n):
    def f(*xs):
        return (xs[0] ** 3).sum() + (xs[0] * xs[-1]).sum() * 0.5

    _same(AG.hessian(f, _args(n, (3,), 40, _t)),
          JAG.hessian(f, _args(n, (3,), 40, _j)))


def test_first_order_goes_through_a_kernel_hessian_does_not():
    """jacobian/jvp/vjp of rms_norm run its autograd function (the
    kernel's backward) and equal those of the plain formula; hessian
    through it raises, and of the plain formula it works."""
    x, w = _t(_r(50, 2, 8)), _t(_r(51, 8) + 1.0)

    def plain(t):
        rstd = torch.rsqrt(t.pow(2).mean(-1, keepdim=True) + 1e-6)
        return t * rstd * w

    kern = lambda t: rms_norm(t, w, 1e-6)       # noqa: E731
    torch.testing.assert_close(AG.jacobian(kern, x), AG.jacobian(plain, x),
                               rtol=RTOL, atol=1e-6)
    v = _t(_r(52, 2, 8))
    for a, b in zip(AG.jvp(kern, x, v), AG.jvp(plain, x, v)):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=1e-6)
    for a, b in zip(AG.vjp(kern, x, v), AG.vjp(plain, x, v)):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=1e-6)
    with pytest.raises(RuntimeError, match="first order"):
        AG.hessian(lambda t: kern(t).pow(2).sum(), x)
    assert AG.hessian(lambda t: plain(t).pow(2).sum(), x).shape == \
        (2, 8, 2, 8)


def test_incubate_jacobian_and_hessian_objects_match_jax():
    a = _r(60, 4)
    f = lambda x: x * x * x.sum()                # noqa: E731
    g = lambda x: (x ** 3).sum()                 # noqa: E731
    jj, tj = JIAG.Jacobian(f, _j(a)), IAG.Jacobian(f, _t(a))
    assert tuple(tj.shape) == tuple(jj.shape) == (4, 4)
    for idx in ((slice(None), slice(None)), (1, slice(None)),
                (slice(1, 3), 2)):
        _same(tj[idx], jj[idx])
    jh, th = JIAG.Hessian(g, _j(a)), IAG.Hessian(g, _t(a))
    _same(th[:], jh[:])
    _same(IAG.jvp(f, _t(a))[1], JIAG.jvp(f, _j(a))[1])
    for mod, wrap in ((JIAG, _j), (IAG, _t)):
        x = wrap(a)
        with pytest.raises(NotImplementedError, match="is_batched"):
            mod.Jacobian(f, x, is_batched=True)
        with pytest.raises(NotImplementedError, match="is_batched"):
            mod.Hessian(g, x, is_batched=True)
        with pytest.raises(NotImplementedError, match="multiple xs"):
            mod.Jacobian(lambda p, q: p * q, [x, x])
        with pytest.raises(NotImplementedError, match="multi-output"):
            mod.Jacobian(lambda p: (p, p * 2.0), x)
