"""The port's RMSNorm (the plain PyTorch twin of its Triton kernel)
against the JAX Pallas kernel ``rms_norm`` in interpret mode and the
functional ``F.rms_norm``, on numpy-seeded inputs.

Tolerance: f32 statistics on both sides; in f32 the sums differ only in
order (1e-6 relative).  In bf16 the kernel rounds the f32 product once,
as the port does: at most one bf16 step apart (relative 2**-7).
``F.rms_norm`` rounds before the weight multiply, so it is compared in
f32 only."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.functional as F
from paddle_tpu.ops.pallas.norms import rms_norm as pallas_rms_norm
from paddle_tpu_torch.models import RMSNorm
from paddle_tpu_torch.ops.rms_norm import (
    rms_norm, rms_norm_kernel, rms_norm_plain,
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
