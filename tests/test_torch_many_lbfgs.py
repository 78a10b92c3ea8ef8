"""The port's ``jit.TrainStep.many`` and ``optimizer.LBFGS`` against the
JAX package's, on the CPU in f32 with numpy-seeded weights and data.

* ``many``: K = 4 equal-shape batches through an MLP with Adam give the
  port's K sequential ``__call__`` losses and parameters bit for bit (the
  same eager steps), and JAX's ``TrainStep.many`` losses and parameters
  within 1e-5 relative (f32 in another summation order); an empty pack,
  a ragged pack and ``has_aux`` raise.
* ``LBFGS``: the iterates after each ``step(closure)`` on a 2-D
  Rosenbrock-like function (strong-Wolfe line search) and on a small
  least-squares MLP (fixed step), against JAX's LBFGS from the same
  start, within 1e-4 of the largest coordinate: both run the same scalar
  tests on f32 values that differ by rounding alone.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import LBFGS, Adam

from _torch_port_util import one_thread  # noqa: F401


def _weights(seed):
    r = np.random.RandomState(seed)
    return [r.randn(4, 8).astype(np.float32) * 0.5,
            r.randn(8).astype(np.float32) * 0.1,
            r.randn(8, 1).astype(np.float32) * 0.5,
            r.randn(1).astype(np.float32) * 0.1]


def _jax_mlp(ws):
    m = jnn.Sequential(jnn.Linear(4, 8), jnn.Tanh(), jnn.Linear(8, 1))
    for p, w in zip(m.parameters(), ws):
        p.set_value(w)
    return m


def _port_mlp(ws):
    m = tnn.Sequential(tnn.Linear(4, 8, device="cpu"), tnn.Tanh(),
                       tnn.Linear(8, 1, device="cpu"))
    with torch.no_grad():
        for p, w in zip(m.parameters(), ws):
            p.copy_(torch.from_numpy(w))
    return m


def _batches(k=4, seed=1):
    r = np.random.RandomState(seed)
    return [(r.rand(16, 4).astype(np.float32), r.rand(16, 1).astype(
        np.float32)) for _ in range(k)]


def _port_step(ws):
    m = _port_mlp(ws)
    opt = Adam(learning_rate=0.05, parameters=m.parameters(), device="cpu")
    return m, TrainStep(m, lambda net, x, y: F.mse_loss(net(x), y), opt,
                        device="cpu")


def test_many_equals_sequential_calls_and_jax_many():
    ws, batches = _weights(0), _batches()
    tb = [tuple(torch.from_numpy(a) for a in b) for b in batches]
    m1, s1 = _port_step(ws)
    seq = torch.stack([s1(*b) for b in tb])
    m2, s2 = _port_step(ws)
    many = s2.many(tb)
    assert many.shape == (4,)
    assert torch.equal(many, seq)
    for a, b in zip(m1.parameters(), m2.parameters()):
        assert torch.equal(a, b)
    assert s2.optimizer._step_count == 4
    jm = _jax_mlp(ws)
    jopt = paddle.optimizer.Adam(learning_rate=0.05,
                                 parameters=jm.parameters())
    js = paddle.jit.TrainStep(jm, lambda net, x, y: JF.mse_loss(net(x), y),
                              jopt)
    jl = js.many([tuple(paddle.to_tensor(a) for a in b)
                  for b in batches]).numpy()
    np.testing.assert_allclose(many.numpy(), jl, rtol=1e-5)
    for p, w in zip(m2.parameters(), jm.parameters()):
        w = w.numpy()
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def test_many_refuses_empty_ragged_and_aux_packs():
    ws = _weights(0)
    _, step = _port_step(ws)
    x = torch.zeros(16, 4)
    with pytest.raises(ValueError, match="at least one"):
        step.many([])
    with pytest.raises(ValueError, match="equal-shape"):
        step.many([(x, torch.zeros(16, 1)), (x[:8], torch.zeros(8, 1))])
    step.has_aux = True
    with pytest.raises(ValueError, match="has_aux"):
        step.many([(x, torch.zeros(16, 1))])


def _rosen(x, y):
    return (1 - x) ** 2 + 5.0 * (y - x * x) ** 2


def test_lbfgs_strong_wolfe_iterates_match_jax():
    start = np.array([-1.0, 2.0], np.float32)
    jp = paddle.Parameter(start.copy())
    jopt = paddle.optimizer.LBFGS(learning_rate=0.5, max_iter=8,
                                  history_size=10,
                                  line_search_fn="strong_wolfe",
                                  parameters=[jp])
    tp = torch.tensor(start, requires_grad=True)
    topt = LBFGS(learning_rate=0.5, max_iter=8, history_size=10,
                 line_search_fn="strong_wolfe", parameters=[tp],
                 device="cpu")

    def jclosure():
        jopt.clear_grad()
        loss = _rosen(jp[0], jp[1])
        loss.backward()
        return loss

    def tclosure():
        loss = _rosen(tp[0], tp[1])
        loss.backward()
        return loss

    for _ in range(4):
        jl = float(jopt.step(jclosure))
        tl = topt.step(tclosure).item()
        np.testing.assert_allclose(tp.detach().numpy(), jp.numpy(), rtol=0,
                                   atol=1e-4 * np.abs(jp.numpy()).max())
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-7)
    assert topt._step_count == 4 and len(topt._s) == len(jopt._s)


def test_lbfgs_fixed_step_on_an_mlp_matches_jax():
    ws = _weights(2)
    r = np.random.RandomState(3)
    x, y = r.randn(32, 4).astype(np.float32), r.randn(32, 1).astype(
        np.float32)
    jm, tm = _jax_mlp(ws), _port_mlp(ws)
    jopt = paddle.optimizer.LBFGS(learning_rate=0.2, max_iter=5,
                                  history_size=4, parameters=jm.parameters())
    topt = LBFGS(learning_rate=0.2, max_iter=5, history_size=4,
                 parameters=tm.parameters(), device="cpu")
    jx, jy = paddle.to_tensor(x), paddle.to_tensor(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)

    def jclosure():
        jopt.clear_grad()
        loss = JF.mse_loss(jm(jx), jy)
        loss.backward()
        return loss

    def tclosure():
        loss = F.mse_loss(tm(tx), ty)
        loss.backward()
        return loss

    losses = []
    for _ in range(3):
        jl = float(jopt.step(jclosure))
        losses.append(topt.step(tclosure).item())
        np.testing.assert_allclose(losses[-1], jl, rtol=1e-4)
        for p, w in zip(tm.parameters(), jm.parameters()):
            w = w.numpy()
            np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                       atol=1e-4 * np.abs(w).max())
    assert losses[-1] < losses[0]
    with pytest.raises(ValueError, match="closure"):
        topt.step()
