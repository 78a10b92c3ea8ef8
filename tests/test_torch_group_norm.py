"""The port's GroupNorm (the plain PyTorch twins of its Triton kernels,
run on CPU tensors, and the autograd.Function over them) against the JAX
Pallas kernel ``group_norm`` in interpret mode and its ``jax.grad``
(``_gn_bwd_kernel``), on numpy-seeded inputs over the shapes of
``TestFusedGroupNorm`` in ``tests/test_pallas_kernels.py`` (4-D, odd
spatial sizes, 3-D), with gradients and a bf16 case.

Tolerances.  f32: the same f32 arithmetic in another summation order:
y to 2e-5 absolute on O(3) outputs, the gradients to 1e-5 of their
largest magnitude.  bf16 (mean 100, std 3, as activations with a large
offset): both sides take the statistics in f32 from the same bf16
values and round the output once, so y is at most one bf16 step apart
(2**-7 relative, 2**-8 absolute near 0) and mean / rstd agree to 1e-5
relative; a variance taken as E[x^2] - mean^2 would miss by far more.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.functional as PF
from paddle_tpu.ops.pallas.norms import group_norm as pallas_group_norm
from paddle_tpu_torch.nn import GroupNorm
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.group_norm import (
    group_norm, group_norm_bwd, group_norm_bwd_kernel, group_norm_bwd_plain,
    group_norm_fwd_plain, group_norm_kernel, group_norm_plain,
)

from _torch_port_util import one_thread  # noqa: F401

CASES = pytest.mark.parametrize(
    "shape,groups", [((3, 32, 8, 8), 8), ((2, 20, 5, 7), 4),
                     ((4, 16, 10), 16), ((3, 24, 6, 5), 8)],
    ids=["3x32x8x8", "2x20x5x7", "4x16x10", "3x24x6x5"])


def _inputs(shape, seed=0):
    r = np.random.RandomState(seed)
    x = (r.randn(*shape) * 3 + 2).astype(np.float32)
    w = r.randn(shape[1]).astype(np.float32)
    b = r.randn(shape[1]).astype(np.float32)
    g = r.randn(*shape).astype(np.float32)
    return x, w, b, g


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@CASES
def test_forward_matches_pallas_kernel_interpret(shape, groups):
    x, w, b, _ = _inputs(shape)
    ref = np.asarray(pallas_group_norm(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b), groups, 1e-5, True))
    out = group_norm(*_t(x, w, b), groups, 1e-5).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5)


@CASES
def test_gradients_match_pallas_jax_grad(shape, groups):
    x, w, b, g = _inputs(shape, seed=1)

    def loss(x, w, b):
        return jnp.sum(pallas_group_norm(x, w, b, groups, 1e-5, True)
                       * jnp.asarray(g))

    ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, b)))
    ts = [t.requires_grad_(True) for t in _t(x, w, b)]
    (group_norm(*ts, groups, 1e-5) * torch.from_numpy(g)).sum().backward()
    for got, want in zip(ts, ref):
        want = np.asarray(want)
        np.testing.assert_allclose(got.grad.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_bf16_large_mean_rounds_once_with_f32_statistics():
    r = np.random.RandomState(3)
    x = torch.from_numpy((r.randn(2, 16, 8, 8) * 3 + 100)
                         .astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((1 + 0.1 * r.randn(16)).astype(np.float32)) \
        .to(torch.bfloat16)
    b = torch.from_numpy((0.1 * r.randn(16)).astype(np.float32)) \
        .to(torch.bfloat16)
    y, mean, rstd = group_norm_fwd_plain(x, w, b, 4, 1e-5)
    assert y.dtype == torch.bfloat16
    assert mean.dtype == rstd.dtype == torch.float32
    assert tuple(mean.shape) == (8,)
    as_j = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    ref = pallas_group_norm(as_j(x), as_j(w), as_j(b), 4, 1e-5, True)
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2.0 ** -7, atol=2.0 ** -8)
    rows = x.float().reshape(8, -1).double()
    np.testing.assert_allclose(mean.numpy(), rows.mean(-1).numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(
        rstd.numpy(), torch.rsqrt(rows.var(-1, unbiased=False) + 1e-5)
        .numpy(), rtol=1e-5)


def test_backward_twin_equals_autograd_of_the_plain_forward():
    """group_norm_bwd_plain (the kernel's twin: per-channel partials,
    dw and db summed over N) and torch autograd through group_norm_plain
    compute one function."""
    x, w, b, g = _t(*_inputs((3, 24, 6, 5), seed=4))
    _, mean, rstd = group_norm_fwd_plain(x, w, b, 8, 1e-5)
    dx, dw, db = group_norm_bwd_plain(x, w, mean, rstd, g, 8)
    ts = [t.clone().requires_grad_(True) for t in (x, w, b)]
    (group_norm_plain(*ts, 8, 1e-5) * g).sum().backward()
    for got, t in zip((dx, dw, db), ts):
        torch.testing.assert_close(got, t.grad, rtol=0,
                                   atol=1e-5 * t.grad.abs().max().item())


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_functional_and_layer_match_paddle(data_format):
    """F.group_norm routes NC* to the op and runs its own torch code for
    NHWC (JAX is jnp there); the layer has paddle's parameter names and
    defaults (weight 1, bias 0, eps 1e-5)."""
    x, w, b, _ = _inputs((2, 12, 6, 6), seed=5)
    if data_format == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    ref = PF.group_norm(paddle.to_tensor(x), 4, 1e-5, paddle.to_tensor(w),
                        paddle.to_tensor(b), data_format).numpy()
    out = F.group_norm(torch.from_numpy(x), 4, 1e-5, *_t(w, b),
                       data_format).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5)
    layer = GroupNorm(4, 12, data_format=data_format, device="cpu")
    assert [n for n, _ in layer.named_parameters()] == ["weight", "bias"]
    assert layer._epsilon == 1e-5
    ref = paddle.nn.GroupNorm(4, 12, data_format=data_format)(
        paddle.to_tensor(x)).numpy()
    np.testing.assert_allclose(layer(torch.from_numpy(x)).detach().numpy(),
                               ref, rtol=0, atol=2e-5)


@pytest.mark.parametrize("shape,groups,match", [
    ((4, 16), 4, "spatial dim"),                  # no spatial dim
    ((4, 18, 8, 8), 4, "C % G"),                  # channels over groups
    ((4, 16, 8, 8), 0, "C % G"),
    ((1, 32, 2 ** 13, 2 ** 13), 1, "row of"),     # 2**31 elements a row
], ids=["2d", "c_mod_g", "zero_groups", "row_2e31"])
def test_unsupported_shapes_raise(shape, groups, match):
    """The kernels' own guard (the TPU's VMEM budget does not apply: the
    Triton kernel walks any row in tiles) raises on a shape it does not
    take; meta tensors, so the 2**31 row allocates nothing."""
    x = torch.empty(shape, device="meta")
    w = torch.empty(shape[1], device="meta")
    with pytest.raises(ValueError, match=match):
        group_norm_kernel(x, w, w, groups)
    with pytest.raises(ValueError, match=match):
        group_norm_bwd_kernel(x, w, w, w, x, groups)


@pytest.mark.parametrize("shape,data_format,affine,to_op", [
    ((4, 16, 8, 8), "NCHW", True, True),
    ((4, 16), "NCHW", True, True),               # the kernel raises on it
    ((4, 8, 8, 16), "NHWC", True, False),
    ((4, 16, 8, 8), "NCHW", False, False),
], ids=["nchw", "nc_2d", "nhwc", "no_affine"])
def test_functional_routes_every_nc_shape_with_affine_to_the_op(
        monkeypatch, shape, data_format, affine, to_op):
    """F.group_norm sends NC* input with 1-D weight and bias to the op
    whatever its shape, so on the card a shape the kernel does not take
    raises there instead of running plain torch; NHWC and a missing
    affine are plain torch, as in the JAX package."""
    calls = []

    def op(x, weight, bias, num_groups, eps):
        calls.append(tuple(x.shape))
        return x

    monkeypatch.setattr(F, "_group_norm_op", op)
    c = shape[1] if data_format == "NCHW" else shape[-1]
    wb = (torch.ones(c), torch.zeros(c)) if affine else (None, None)
    F.group_norm(torch.randn(shape), 4, 1e-5, *wb, data_format)
    assert calls == ([shape] if to_op else [])


def test_cpu_runs_the_plain_twins_uncounted_and_other_devices_raise():
    x, w, b, g = _t(*_inputs((2, 8, 4, 4), seed=6))
    counts = (group_norm.launches, group_norm_bwd.launches)
    ts = [t.clone().requires_grad_(True) for t in (x, w, b)]
    group_norm(*ts, 4).sum().backward()
    assert (group_norm.launches, group_norm_bwd.launches) == counts
    with pytest.raises(ValueError, match="unsupported device"):
        group_norm(x.to("meta"), w.to("meta"), b.to("meta"), 4)
    with pytest.raises(ValueError, match="CUDA"):
        group_norm_kernel(x, w, b, 4)
    with pytest.raises(ValueError, match="CUDA"):
        _, mean, rstd = group_norm_fwd_plain(x, w, b, 4)
        group_norm_bwd_kernel(x, w, mean, rstd, g, 4)
