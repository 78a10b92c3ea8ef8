"""The port's BatchNorm and InstanceNorm (``nn.functional.batch_norm``,
``instance_norm``, ``nn.BatchNorm*``, ``nn.InstanceNorm*``) against the
JAX package's on numpy-seeded inputs: the output, the gradients of the
input, weight and bias, and the running buffers (``_mean``,
``_variance``: Paddle's momentum, the unbiased variance) after each of
three training steps; eval and ``use_global_stats`` (the running buffers
normalise); NHWC and NC / NCL inputs; a layer without weight or bias; a
bf16 layer whose buffers are bf16 (``Layer.to`` casts them).

Tolerances.  f32: the same f32 arithmetic in another summation order,
within 1e-5 of each tensor's largest magnitude (the input gradient,
whose terms cancel, within 1e-5 of its largest magnitude plus 1e-6 of
the cotangent's).  bf16: both sides take the batch statistics in f32
from the same bf16 values and round them to bf16, then run the same bf16
elementwise chain; a statistic that lands on the other side of a bf16
rounding boundary moves its whole channel by one bf16 step, so outputs
are held to 2 bf16 steps (2**-6 relative to their largest magnitude) and
the buffers to one step of theirs (2**-7 relative).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as F

from _torch_port_util import one_thread  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """The layers here are built without ``device=``, as a Paddle script
    builds them: ``set_device("cpu")`` puts them on the CPU, and the
    default is restored when the file ends."""
    prev = tdevice._CURRENT[0]
    tdevice.set_device("cpu")
    yield
    tdevice._CURRENT[0] = prev


def _close(got, want, what, rel=1e-5, extra=0.0):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max() + extra,
                               err_msg=what)


def _pair(layer, **kw):
    """The JAX layer and the port's, with the JAX layer's parameters."""
    jl = getattr(jnn, layer)(**kw)
    tl = getattr(tnn, layer)(**kw)
    tl.load_state_dict({k: torch.tensor(np.asarray(v.numpy()))
                        for k, v in jl.state_dict().items()})
    return jl, tl


def _step(jl, tl, x, cot):
    """One forward and backward of both layers; checks the outputs and
    the gradients of the input and of every parameter."""
    jx = paddle.to_tensor(x, stop_gradient=False)
    jout = jl(jx)
    (jout * paddle.to_tensor(cot)).sum().backward()
    tx = torch.tensor(x, requires_grad=True)
    tout = tl(tx)
    (tout * torch.from_numpy(cot)).sum().backward()
    _close(tout.detach().numpy(), jout.numpy(), "output")
    _close(tx.grad.numpy(), jx.grad.numpy(), "input grad",
           extra=1e-6 * np.abs(cot).max())
    jp = dict(jl.named_parameters())
    for n, p in tl.named_parameters():
        _close(p.grad.numpy(), jp[n].grad.numpy(), f"{n} grad")
        p.grad = None
        jp[n].clear_gradient()


def _buffers_close(jl, tl):
    jsd = jl.state_dict()
    for n in ("_mean", "_variance"):
        _close(getattr(tl, n).numpy(), jsd[n].numpy(), n)


@pytest.mark.parametrize("layer,shape,kw", [
    ("BatchNorm2D", (4, 6, 5, 7), {}),
    ("BatchNorm2D", (4, 6, 5, 7), dict(momentum=0.7, epsilon=1e-3)),
    ("BatchNorm2D", (3, 5, 4, 6), dict(data_format="NHWC")),
    ("BatchNorm1D", (16, 6), {}),
    ("BatchNorm1D", (4, 6, 9), {}),
    ("BatchNorm3D", (2, 4, 3, 5, 4), {}),
    ("BatchNorm", (4, 6, 5, 5), dict(weight_attr=False, bias_attr=False)),
], ids=["2d", "2d_momentum_eps", "2d_nhwc", "1d_nc", "1d_ncl", "3d",
        "no_affine"])
def test_train_three_steps_then_eval_match_jax(layer, shape, kw):
    c = shape[-1] if kw.get("data_format") == "NHWC" else shape[1]
    jl, tl = _pair(layer, num_features=c, **kw)
    r = np.random.RandomState(sum(shape))
    for _ in range(3):
        x = (r.randn(*shape) * 2 + 0.5).astype(np.float32)
        _step(jl, tl, x, r.randn(*shape).astype(np.float32))
        _buffers_close(jl, tl)
    jl.eval()
    tl.eval()
    _step(jl, tl, r.randn(*shape).astype(np.float32),
          r.randn(*shape).astype(np.float32))
    _buffers_close(jl, tl)


def test_use_global_stats_normalises_by_the_buffers_in_training():
    jl, tl = _pair("BatchNorm2D", num_features=4, use_global_stats=True)
    r = np.random.RandomState(3)
    mean, var = r.randn(4).astype(np.float32), r.rand(4).astype(np.float32)
    jl._mean.set_value(mean)
    jl._variance.set_value(var + 0.5)
    tl._mean.copy_(torch.from_numpy(mean))
    tl._variance.copy_(torch.from_numpy(var + 0.5))
    x = r.randn(3, 4, 5, 5).astype(np.float32)
    _step(jl, tl, x, r.randn(*x.shape).astype(np.float32))
    _buffers_close(jl, tl)
    np.testing.assert_array_equal(tl._mean.numpy(), mean)


def test_functional_batch_norm_running_buffers_and_unbiased_variance():
    r = np.random.RandomState(5)
    x = r.randn(6, 3, 4, 4).astype(np.float32)
    w, b = r.randn(3).astype(np.float32), r.randn(3).astype(np.float32)
    jm, jv = paddle.to_tensor(np.zeros(3, np.float32)), \
        paddle.to_tensor(np.ones(3, np.float32))
    tm, tv = torch.zeros(3), torch.ones(3)
    want = JF.batch_norm(paddle.to_tensor(x), jm, jv, paddle.to_tensor(w),
                         paddle.to_tensor(b), training=True, momentum=0.6)
    got = F.batch_norm(torch.from_numpy(x), tm, tv, torch.from_numpy(w),
                       torch.from_numpy(b), training=True, momentum=0.6)
    _close(got.numpy(), want.numpy(), "output")
    _close(tm.numpy(), jm.numpy(), "running mean")
    _close(tv.numpy(), jv.numpy(), "running var")
    n = 6 * 4 * 4
    unbiased = x.transpose(1, 0, 2, 3).reshape(3, -1).var(1) * n / (n - 1)
    _close(tv.numpy(), 0.6 + 0.4 * unbiased, "var is Paddle's momentum "
           "over the unbiased variance")


def test_bf16_layer_keeps_bf16_buffers_and_matches_jax():
    jl = jnn.BatchNorm2D(8)
    tl = tnn.BatchNorm2D(8)
    jl.to(dtype="bfloat16")
    tl.to(torch.bfloat16)
    assert tl._mean.dtype == tl._variance.dtype == torch.bfloat16
    assert str(jl.state_dict()["_mean"].dtype).endswith("bfloat16")
    r = np.random.RandomState(11)
    for _ in range(3):
        x = (r.randn(4, 8, 6, 6) * 3 + 1).astype(np.float32)
        jout = jl(paddle.cast(paddle.to_tensor(x), "bfloat16"))
        tout = tl(torch.from_numpy(x).to(torch.bfloat16))
        assert tout.dtype == torch.bfloat16
        _close(tout.detach().float().numpy(), jout.astype("float32").numpy(),
               "bf16 output", rel=2.0 ** -6)
        jsd = jl.state_dict()
        for n in ("_mean", "_variance"):
            assert getattr(tl, n).dtype == torch.bfloat16
            _close(getattr(tl, n).float().numpy(),
                   jsd[n].astype("float32").numpy(), f"bf16 {n}",
                   rel=2.0 ** -7)


@pytest.mark.parametrize("layer,shape", [
    ("InstanceNorm1D", (3, 4, 9)), ("InstanceNorm2D", (2, 5, 6, 7)),
    ("InstanceNorm3D", (2, 3, 4, 3, 5))])
def test_instance_norm_matches_jax(layer, shape):
    jl, tl = _pair(layer, num_features=shape[1])
    r = np.random.RandomState(len(shape))
    with torch.no_grad():
        for p in tl.parameters():
            p.copy_(torch.from_numpy(r.randn(*p.shape).astype(np.float32)))
    for n, p in jl.named_parameters():
        p.set_value(dict(tl.named_parameters())[n].detach().numpy())
    x = (r.randn(*shape) * 2 + 1).astype(np.float32)
    _step(jl, tl, x, r.randn(*shape).astype(np.float32))


def test_instance_norm_functional_channels_last():
    r = np.random.RandomState(9)
    x = r.randn(2, 5, 6, 3).astype(np.float32)
    w, b = r.randn(3).astype(np.float32), r.randn(3).astype(np.float32)
    want = F.instance_norm(torch.from_numpy(x).permute(0, 3, 1, 2),
                           weight=torch.from_numpy(w),
                           bias=torch.from_numpy(b)).permute(0, 2, 3, 1)
    got = F.instance_norm(torch.from_numpy(x), weight=torch.from_numpy(w),
                          bias=torch.from_numpy(b), data_format="NHWC")
    _close(got.numpy(), want.numpy(), "NHWC vs NCHW")
