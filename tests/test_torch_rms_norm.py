"""The port's RMSNorm (the plain PyTorch twin of its Triton kernel)
against the JAX Pallas kernel ``rms_norm`` in interpret mode and the
functional ``F.rms_norm``, on numpy-seeded inputs.

Tolerance: f32 statistics on both sides; in f32 the sums differ only in
order (1e-6 relative).  In bf16 the kernel rounds the f32 product once,
as the port does: at most one bf16 step apart (relative 2**-7).
``F.rms_norm`` rounds before the weight multiply, so it is compared in
f32 only.

Backward: dx and dw of the port's autograd path (the plain twin of the
Triton backward on CPU tensors) against ``jax.grad`` of the
interpret-mode Pallas kernel (``_rms_bwd_kernel``), in f32: the same f32
arithmetic in another summation order, 1e-5 of the gradient's scale."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.functional as F
from paddle_tpu.ops.pallas.norms import rms_norm as pallas_rms_norm
from paddle_tpu_torch.models import RMSNorm
from paddle_tpu_torch.ops.rms_norm import (
    rms_norm, rms_norm_bwd, rms_norm_bwd_kernel, rms_norm_bwd_plain,
    rms_norm_fwd_plain, rms_norm_kernel, rms_norm_plain,
)

from _torch_port_util import one_thread  # noqa: F401

SHAPES = pytest.mark.parametrize(
    "shape", [(8, 64), (13, 96), (2, 5, 128)], ids=["8x64", "13x96", "2x5x128"])


def _inputs(shape, seed=0):
    r = np.random.RandomState(seed)
    x = (r.randn(*shape) * 3).astype(np.float32)
    w = (1.0 + 0.1 * r.randn(shape[-1])).astype(np.float32)
    return x, w


@SHAPES
def test_matches_pallas_kernel_interpret(shape):
    x, w = _inputs(shape)
    ref = np.asarray(pallas_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6,
                                     interpret=True))
    out = rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


@SHAPES
def test_matches_functional_rms_norm(shape):
    x, w = _inputs(shape, seed=1)
    ref = F.rms_norm(paddle.to_tensor(x), paddle.to_tensor(w), None,
                     1e-6).numpy()
    out = rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_bf16_matches_pallas_kernel_to_one_step():
    x, w = _inputs((16, 128), seed=2)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    out = rms_norm(xb, wb, 1e-6)
    assert out.dtype == torch.bfloat16
    ref = pallas_rms_norm(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                          jnp.asarray(wb.float().numpy()).astype(jnp.bfloat16),
                          1e-6, interpret=True)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2.0 ** -7, atol=1e-6)


def test_module_forward_uses_its_weight_and_eps():
    x, w = _inputs((4, 64), seed=3)
    m = RMSNorm(64, eps=1e-5, device="cpu")
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(w))
        out = m(torch.from_numpy(x))
    ref = np.asarray(pallas_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5,
                                     interpret=True))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_cpu_tensors_run_the_plain_version_uncounted():
    x, w = (torch.from_numpy(a) for a in _inputs((4, 64)))
    before = rms_norm.launches
    assert torch.equal(rms_norm(x, w), rms_norm_plain(x, w))
    assert rms_norm.launches == before


def test_other_devices_raise():
    x, w = (torch.from_numpy(a).to("meta") for a in _inputs((4, 64)))
    with pytest.raises(ValueError, match="unsupported device"):
        rms_norm(x, w)


def test_kernel_wrapper_refuses_cpu_tensors():
    x, w = (torch.from_numpy(a) for a in _inputs((4, 64)))
    with pytest.raises(ValueError, match="CUDA device"):
        rms_norm_kernel(x, w)


def _grad_inputs(shape, seed):
    x, w = _inputs(shape, seed)
    g = np.random.RandomState(seed + 100).randn(*shape).astype(np.float32)
    return x, w, g


def _jax_grads(x, w, g, eps):
    loss = lambda x, w: jnp.sum(pallas_rms_norm(x, w, eps, interpret=True)
                                * jnp.asarray(g))
    return jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@SHAPES
def test_gradients_match_pallas_kernel_interpret_grad(shape):
    x, w, g = _grad_inputs(shape, seed=4)
    jdx, jdw = _jax_grads(x, w, g, 1e-6)
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    (rms_norm(tx, tw, 1e-6) * torch.from_numpy(g)).sum().backward()
    _close(tx.grad.numpy(), jdx)
    _close(tw.grad.numpy(), jdw)


@SHAPES
def test_backward_twin_matches_pallas_kernel_interpret_grad(shape):
    """rms_norm_bwd (the plain twin of the Triton backward) from the
    forward's own rstd."""
    x, w, g = _grad_inputs(shape, seed=5)
    jdx, jdw = _jax_grads(x, w, g, 1e-5)
    tx, tw, tg = (torch.from_numpy(a) for a in (x, w, g))
    _, rstd = rms_norm_fwd_plain(tx, tw, 1e-5)
    assert rstd.dtype == torch.float32 and rstd.shape == (x.size // x.shape[-1],)
    dx, dw = rms_norm_bwd(tx, tw, rstd, tg)
    _close(dx.numpy(), jdx)
    _close(dw.numpy(), jdw)


def test_plain_autograd_equals_the_backward_twin():
    """rms_norm_plain differentiated by torch autograd and the custom
    backward give one gradient: the kernel path's reference is sound."""
    x, w, g = (torch.from_numpy(a) for a in _grad_inputs((6, 40), seed=6))
    grads = []
    for fn in (rms_norm, rms_norm_plain):
        tx, tw = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        (fn(tx, tw, 1e-6) * g).sum().backward()
        grads.append((tx.grad, tw.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_bf16_gradients_keep_the_input_dtypes():
    x, w, g = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _grad_inputs((5, 64), seed=7))
    tx, tw = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    (rms_norm(tx, tw) * g).sum().backward()
    assert tx.grad.dtype == tw.grad.dtype == torch.bfloat16
    _, rstd = rms_norm_fwd_plain(x, w, 1e-6)
    dx, dw = rms_norm_bwd_plain(x, w, rstd, g)
    assert torch.equal(tx.grad, dx) and torch.equal(tw.grad, dw)


def test_backward_on_cpu_is_uncounted_and_kernel_refuses_cpu():
    x, w, g = (torch.from_numpy(a) for a in _grad_inputs((4, 64), seed=8))
    before = rms_norm_bwd.launches
    tx = x.clone().requires_grad_(True)
    (rms_norm(tx, w) * g).sum().backward()
    assert rms_norm_bwd.launches == before
    _, rstd = rms_norm_fwd_plain(x, w)
    with pytest.raises(ValueError, match="CUDA device"):
        rms_norm_bwd_kernel(x, w, rstd, g)
    with pytest.raises(ValueError, match="unsupported device"):
        rms_norm_bwd(*(t.to("meta") for t in (x, w, rstd, g)))
