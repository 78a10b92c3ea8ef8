"""The port's LayerNorm (the plain PyTorch twins of its Triton kernels,
run on CPU tensors, and the autograd.Function over them) against the JAX
Pallas kernel ``layer_norm`` in interpret mode and its ``jax.grad``
(``_ln_bwd_kernel``), on numpy-seeded inputs: a row count that is not a
multiple of the Pallas row block (JAX pads to 256 rows), one above it,
and a 3-D input.

Tolerances.  f32: both sides compute the statistics and the output in
f32 and differ only in summation order, so y agrees to 1e-5 absolute on
O(3) outputs and the gradients to 1e-5 of their largest magnitude.
bf16: both round the f32 result once to bf16, so y is at most one bf16
step apart (2**-7 relative), and mean / rstd, kept in f32 on both sides,
agree to 1e-5 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.functional as PF
from paddle_tpu.ops.pallas.norms import layer_norm as pallas_layer_norm
from paddle_tpu_torch.nn import LayerNorm
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.layer_norm import (
    layer_norm, layer_norm_bwd, layer_norm_bwd_kernel, layer_norm_bwd_plain,
    layer_norm_fwd_plain, layer_norm_kernel, layer_norm_plain,
)

from _torch_port_util import one_thread  # noqa: F401

SHAPES = pytest.mark.parametrize(
    "shape", [(37, 64), (300, 96), (4, 33, 32)],
    ids=["37x64", "300x96", "4x33x32"])


def _inputs(shape, seed=0):
    r = np.random.RandomState(seed)
    x = (r.randn(*shape) * 3 + 2).astype(np.float32)
    w = (1.0 + 0.1 * r.randn(shape[-1])).astype(np.float32)
    b = (0.1 * r.randn(shape[-1])).astype(np.float32)
    g = r.randn(*shape).astype(np.float32)
    return x, w, b, g


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@SHAPES
def test_forward_matches_pallas_kernel_interpret(shape):
    x, w, b, _ = _inputs(shape)
    ref = np.asarray(pallas_layer_norm(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b), 1e-5, interpret=True))
    out = layer_norm(*_t(x, w, b), 1e-5).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@SHAPES
def test_gradients_match_pallas_jax_grad(shape):
    x, w, b, g = _inputs(shape, seed=1)

    def loss(x, w, b):
        return jnp.sum(pallas_layer_norm(x, w, b, 1e-5, interpret=True)
                       * jnp.asarray(g))

    ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, b)))
    ts = [t.requires_grad_(True) for t in _t(x, w, b)]
    (layer_norm(*ts, 1e-5) * torch.from_numpy(g)).sum().backward()
    for got, want in zip(ts, ref):
        want = np.asarray(want)
        np.testing.assert_allclose(got.grad.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_bf16_rounds_once_with_f32_statistics():
    x, w, b, _ = _inputs((300, 96), seed=2)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    bb = torch.from_numpy(b).to(torch.bfloat16)
    y, mean, rstd = layer_norm_fwd_plain(xb, wb, bb, 1e-5)
    assert y.dtype == torch.bfloat16
    assert mean.dtype == rstd.dtype == torch.float32
    assert tuple(mean.shape) == tuple(rstd.shape) == (300,)
    as_j = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    ref = pallas_layer_norm(as_j(xb), as_j(wb), as_j(bb), 1e-5,
                            interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(y.float().numpy(), ref, rtol=2.0 ** -7,
                               atol=1e-6)
    xf = xb.float()
    np.testing.assert_allclose(mean.numpy(), xf.mean(-1).numpy(), rtol=1e-5)
    np.testing.assert_allclose(
        rstd.numpy(), torch.rsqrt(xf.var(-1, unbiased=False) + 1e-5).numpy(),
        rtol=1e-5)


def test_backward_twin_equals_autograd_of_the_plain_forward():
    """layer_norm_bwd_plain (the kernel's twin) and torch autograd through
    layer_norm_plain compute one function."""
    x, w, b, g = _t(*_inputs((37, 64), seed=3))
    _, mean, rstd = layer_norm_fwd_plain(x, w, b, 1e-5)
    dx, dw, db = layer_norm_bwd_plain(x, w, mean, rstd, g)
    ts = [t.clone().requires_grad_(True) for t in (x, w, b)]
    (layer_norm_plain(*ts, 1e-5) * g).sum().backward()
    for got, t in zip((dx, dw, db), ts):
        torch.testing.assert_close(got, t.grad, rtol=0, atol=1e-5)


def test_functional_and_layer_match_paddle():
    """F.layer_norm routes 1-D affine params to the op; the layer has
    paddle's parameter names and defaults (weight 1, bias 0, eps 1e-5);
    without affine params the plain path matches too."""
    x, w, b, _ = _inputs((4, 33, 32), seed=4)
    ref = PF.layer_norm(paddle.to_tensor(x), 32, paddle.to_tensor(w),
                        paddle.to_tensor(b)).numpy()
    out = F.layer_norm(*_t(x, w, b)[:1], 32, *_t(w, b)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    ref = PF.layer_norm(paddle.to_tensor(x), [33, 32]).numpy()
    out = F.layer_norm(torch.from_numpy(x), [33, 32]).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    ln = LayerNorm(32, device="cpu")
    assert [n for n, _ in ln.named_parameters()] == ["weight", "bias"]
    assert ln._epsilon == 1e-5
    ref = paddle.nn.LayerNorm(32)(paddle.to_tensor(x)).numpy()
    np.testing.assert_allclose(ln(torch.from_numpy(x)).detach().numpy(), ref,
                               rtol=0, atol=1e-5)


def test_cpu_runs_the_plain_twins_uncounted_and_other_devices_raise():
    x, w, b, g = _t(*_inputs((8, 16), seed=5))
    counts = (layer_norm.launches, layer_norm_bwd.launches)
    ts = [t.clone().requires_grad_(True) for t in (x, w, b)]
    layer_norm(*ts).sum().backward()
    assert (layer_norm.launches, layer_norm_bwd.launches) == counts
    with pytest.raises(ValueError, match="unsupported device"):
        layer_norm(x.to("meta"), w.to("meta"), b.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        layer_norm_kernel(x, w, b)
    with pytest.raises(ValueError, match="CUDA"):
        _, mean, rstd = layer_norm_fwd_plain(x, w, b)
        layer_norm_bwd_kernel(x, w, mean, rstd, g)
