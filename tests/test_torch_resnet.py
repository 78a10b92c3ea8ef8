"""The port's ResNet family (``vision.models``) against the JAX package's
on the same weights (``convert.state_from_jax``), in f32 on
the CPU, 10 classes, b2, in training mode.

* ``resnet18`` and ``resnet50`` (the bottleneck net) at 64 px: the
  logits, the loss, every parameter's gradient, then two
  ``jit.TrainStep`` steps with ``Momentum(0.1, 0.9)`` against
  ``paddle.jit.TrainStep``, one at a time: each step's loss, every
  parameter and both BatchNorm buffers after the first, the buffers
  (ResNet-18: and the parameters) after the second.
* All nine constructors' ``state_dict`` shapes (and so their parameter
  counts) against JAX's;
  ``pretrained=True`` raises.
* The converter: buffers carried, ``fc.weight`` as it is (paddle's
  ``[in, out]`` in both), a missing or an extra key raises.

Sizes and weights.  Training-mode BatchNorm normalises each channel over
the batch and the positions.  At 32 px the last stage is 1 x 1, so at b2
its BatchNorms see two values a channel, give +-1 and pass back a
gradient that is 0 in exact arithmetic: there the same weights' loss
differs by 14 % between the two frameworks' f32 (ResNet-50).  At 64 px
the last stage is 2 x 2, and ResNet-18's step is well conditioned (the
frameworks' gradients agree to 3e-5 of each tensor's largest magnitude).
ResNet-50's is not at JAX's initial weights: through 16 residual
branches whose last BatchNorm weight is 1 its gradients differ by up to
2 % norm-wise between f32 and f64 of the same port (also at b8, b16 and
b32), and by as much between the frameworks.  With each bottleneck's
``bn3.weight`` at 0.25 in both (a down-weighted residual branch, as the
zero-init-residual practice of Goyal et al. 2017 does at 0), f32 and f64
agree to 2.2e-5, and so the frameworks are held directly.  After one
Momentum step at lr 0.1 its gradients are ill conditioned again, so its
parameters are held after the first step only; the second step's loss
and buffers come from the forward over them.

Tolerances: logits to 1e-5 of their largest magnitude, losses to 1e-5
relative (a step's loss: 1e-4), gradients to 1e-4 of each tensor's
largest magnitude plus 1e-6 of the model's largest gradient, and after a
step each parameter and buffer to 1e-4 of its largest magnitude plus
1e-4 of the learning rate.
"""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch.convert import state_from_jax
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision import models as tmodels

from _torch_jax_table import numpy_init
from _torch_port_util import one_thread  # noqa: F401

#: the constructors
ARCH = ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
        "wide_resnet50_2", "wide_resnet101_2", "resnext50_32x4d",
        "resnext101_64x4d")
LR = 0.1


def _state(m):
    return {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}


def _models(name, seed=0, branch_scale=None):
    """The JAX model (10 classes) and the port's on its weights; with
    ``branch_scale`` each bottleneck's ``bn3.weight`` scaled by it, in
    both."""
    paddle.seed(seed)
    jm = getattr(jmodels, name)(num_classes=10)
    state = _state(jm)
    if branch_scale is not None:
        state = {k: v * branch_scale if k.endswith("bn3.weight") else v
                 for k, v in state.items()}
        jm.set_state_dict(state)
    tm = getattr(tmodels, name)(num_classes=10, device="cpu")
    tm.load_state_dict(state_from_jax(state, tm, device="cpu"))
    return jm, tm


def _batch(hw, seed=1):
    r = np.random.RandomState(seed)
    return (r.randn(2, 3, hw, hw).astype(np.float32),
            r.randint(0, 10, (2,)).astype(np.int64))


def _jax_loss(net, x, y):
    return jnn.functional.cross_entropy(net(x), y)


def _port_loss(net, x, y):
    return F.cross_entropy(net(x), y)


def _jax_forward_backward(jm, x, y):
    """The JAX model's training forward, loss and parameter gradients as
    one ``jax.jit`` over its state (``jax.value_and_grad``; compiled op
    by op, the same reference took most of a minute).  The BatchNorm
    buffers the forward moved are written back to ``jm``, as its eager
    forward does."""
    sd = jm.state_dict()
    names = list(sd)
    pnames = [n for n, _ in jm.named_parameters()]

    def run(params, state, xa, ya):
        def loss_of(params):
            full = dict(state, **params)
            with paddle.no_grad(), jm.use_state(full) as live:
                logits = jm(JTensor(xa))
                loss = jnn.functional.cross_entropy(logits, JTensor(ya))
                new = {k: live[k]._data for k in names}
            return loss._data, (logits._data, new)

        (loss, (logits, new)), grads = jax.value_and_grad(
            loss_of, has_aux=True)(params)
        return logits, loss, grads, new

    params = {n: sd[n]._data for n in pnames}
    state = {n: v._data for n, v in sd.items()}
    logits, loss, grads, new = jax.jit(run)(params, state, x, y)
    for n in names:
        if n not in params:
            sd[n]._data = new[n]
    return (np.asarray(logits), float(loss),
            {n: np.asarray(g) for n, g in grads.items()})


def _forward_backward(jm, tm, x, y):
    """Logits, loss and gradients of both (one layout: paddle's)."""
    jout = _jax_forward_backward(jm, x, y)
    tlogits = tm(torch.from_numpy(x))
    tloss = F.cross_entropy(tlogits, torch.from_numpy(y))
    tloss.backward()
    tgrads = {n: p.grad.clone() for n, p in tm.named_parameters()}
    tm.zero_grad(set_to_none=True)
    return jout, (tlogits.detach().numpy(), tloss.item(), tgrads)


def _close(got, want, what, rel=1e-5, extra=0.0):
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max() + extra,
                               err_msg=what)


def _check_direct(jax_out, port_out, loss_rel=1e-5):
    (jlogits, jloss, jgrads), (tlogits, tloss, tgrads) = jax_out, port_out
    _close(tlogits, jlogits, "logits")
    assert abs(tloss - jloss) <= loss_rel * abs(jloss), (tloss, jloss)
    assert set(tgrads) == set(jgrads)
    top = max(np.abs(g).max() for g in jgrads.values())
    for n, g in tgrads.items():
        _close(g.numpy(), jgrads[n], f"{n} grad", rel=1e-4,
               extra=1e-6 * top)


def _two_steps_close(jm, tm, x, y, name, params_after_second=True):
    """Two Momentum steps of each, one at a time: the losses, every
    parameter and buffer after the first, the buffers (and with
    ``params_after_second`` the parameters) after the second."""
    jopt = paddle.optimizer.Momentum(learning_rate=LR, momentum=0.9,
                                     parameters=jm.parameters())
    jstep = paddle.jit.TrainStep(jm, _jax_loss, jopt)
    topt = Momentum(learning_rate=LR, momentum=0.9,
                    parameters=tm.named_parameters(), device="cpu")
    tstep = TrainStep(tm, _port_loss, topt, device="cpu")
    for i in range(2):
        jl = float(jstep(paddle.to_tensor(x), paddle.to_tensor(y)))
        tl = tstep(torch.from_numpy(x), torch.from_numpy(y)).item()
        assert abs(tl - jl) <= 1e-4 * abs(jl), (i, tl, jl)
        want = state_from_jax(_state(jm), tm, device="cpu")
        got = tm.state_dict()
        assert set(got) == set(want)
        for n, w in want.items():
            if i == 0 or params_after_second or n.endswith(
                    ("_mean", "_variance")):
                _close(got[n].numpy(), w.numpy(), f"step {i + 1} {n}",
                       rel=1e-4, extra=1e-4 * LR)


def test_resnet18_train_gradients_and_two_momentum_steps_match_jax():
    jm, tm = _models("resnet18")
    x, y = _batch(64)
    _check_direct(*_forward_backward(jm, tm, x, y))
    # the forward above already moved both models' running buffers
    _two_steps_close(jm, tm, x, y, "resnet18")


def test_resnet50_train_gradients_and_two_momentum_steps_match_jax():
    """Training mode at 64 px, each bottleneck's last BatchNorm weight
    at 0.25 (see the module docstring)."""
    jm, tm = _models("resnet50", branch_scale=0.25)
    x, y = _batch(64)
    _check_direct(*_forward_backward(jm, tm, x, y))
    _two_steps_close(jm, tm, x, y, "resnet50", params_after_second=False)


@pytest.mark.parametrize("name", sorted(ARCH))
def test_constructor_shapes_match_jax(name):
    with numpy_init(0):     # shapes only: the values do not matter
        jm = getattr(jmodels, name)(num_classes=1000)
    tm = getattr(tmodels, name)(num_classes=1000, device="cpu")
    want = {k: tuple(v.shape) for k, v in jm.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == want
    assert sum(p.numel() for p in tm.parameters()) == sum(
        int(np.prod(p.shape)) for p in jm.parameters())


def test_pretrained_raises():
    with pytest.raises(NotImplementedError):
        tmodels.resnet50(pretrained=True, device="cpu")


def test_converter_carries_buffers_transposes_fc_and_checks_keys():
    paddle.seed(3)
    jm = jmodels.resnet18(num_classes=10)
    _jax_forward_backward(jm, *_batch(32))       # moves the buffers
    state = _state(jm)
    tm = tmodels.resnet18(num_classes=10, device="cpu")
    sd = state_from_jax(state, tm, device="cpu")
    np.testing.assert_array_equal(sd["fc.weight"].numpy(),
                                  state["fc.weight"])
    np.testing.assert_array_equal(sd["layer2.0.downsample.1._variance"]
                                  .numpy(),
                                  state["layer2.0.downsample.1._variance"])
    assert not np.allclose(state["bn1._mean"], 0.0)
    missing = dict(state)
    del missing["layer3.1.bn2._mean"]
    with pytest.raises(KeyError, match="layer3.1.bn2._mean"):
        state_from_jax(missing, tm, device="cpu")
    extra = dict(state, **{"layer9.weight": state["fc.bias"]})
    with pytest.raises(KeyError, match="layer9"):
        state_from_jax(extra, tm, device="cpu")


def test_zoo_ops_match_jax():
    """``vision.models._ops``: ``make_divisible`` and ``ConvBNReLU``'s
    parameters and forward on the JAX block's weights."""
    from paddle_tpu.vision.models import _ops as jops
    from paddle_tpu_torch.vision.models import _ops as tops

    for v in (3, 8, 13.5, 30, 37, 100, 250):
        for d in (4, 8, 16):
            assert tops.make_divisible(v, d) == jops.make_divisible(v, d)
    paddle.seed(1)
    jb = jops.ConvBNReLU(3, 8, 3, stride=2, padding=1)
    tb = tops.ConvBNReLU(3, 8, 3, stride=2, padding=1, device="cpu")
    tb.load_state_dict({k: torch.tensor(np.asarray(v.numpy()))
                        for k, v in jb.state_dict().items()})
    x = _batch(16)[0]
    want = jb(paddle.to_tensor(x)).numpy()
    _close(tb(torch.from_numpy(x)).detach().numpy(), want, "ConvBNReLU")
