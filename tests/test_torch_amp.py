"""The port's ``amp`` (``auto_cast``, ``decorate``, ``GradScaler``) and
``jit.TrainStep(scaler=)`` against the JAX package's, on the CPU.

* ``amp_dtype_for`` op by op (white, black and unlisted names, the empty
  name) under O1 and O2, bfloat16 and float16, with and without custom
  lists, against JAX's; and the output dtype of each port functional
  that JAX names (``linear``, ``matmul``, ``conv2d``,
  ``conv2d_transpose``, the pools, ``batch_norm``, ``layer_norm``,
  ``group_norm``, ``instance_norm``, ``cross_entropy``, ``relu``,
  ``flatten``) against the JAX functional's under the same scope.
* ``GradScaler``'s eager ``scale`` / ``unscale_`` / ``step`` /
  ``update`` over a scripted run of a small net with SGD, whose inputs
  overflow on some steps: the scale and the parameters after every step,
  the ``state_dict`` after the run, against JAX's ``AmpScaler``;
  ``minimize``; ``load_state_dict``.
* Three ``TrainStep(scaler=)`` steps with Momentum on a net with
  BatchNorm, the second forced to overflow (the scale set to 2**124):
  each step's loss, the parameters, the running buffers, the scale and
  the good/bad counters against JAX's ``TrainStep(scaler=)``; over the
  overflowing step the parameters and the velocities bit for bit
  unchanged, the buffers moved.
* Attention under a float16 scope computes in float16 as JAX's
  ``scaled_dot_product_attention`` does (it raised, naming ROADMAP.md,
  before float16 attention was ported; the test keeps its name).

Tolerance: f32 arithmetic in another order, within 1e-5 of each
tensor's largest magnitude (losses 1e-5 relative); the scale and the
counters exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.amp.auto_cast import amp_dtype_for as jax_amp_dtype_for
from paddle_tpu_torch import amp, flatten, matmul
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.flash_attention import flash_attention
from paddle_tpu_torch.optimizer import SGD, AdamW, Momentum

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


OPS = ["matmul", "linear", "conv2d", "conv3d_transpose", "flash_attention",
       "scaled_dot_product_attention", "einsum", "cross_entropy",
       "batch_norm", "layer_norm", "group_norm", "instance_norm", "rms_norm",
       "softmax", "mean", "relu", "max_pool2d", "avg_pool2d",
       "adaptive_avg_pool2d", "flatten", "dropout", "embedding", "gelu", ""]
SCOPES = {
    "O1_bf16": dict(level="O1", dtype="bfloat16"),
    "O1_fp16": dict(level="O1", dtype="float16"),
    "O2_bf16": dict(level="O2", dtype="bfloat16"),
    "O2_fp16": dict(level="O2", dtype="float16"),
    "O1_custom": dict(level="O1", dtype="float16",
                      custom_white_list=["relu", "max_pool2d"],
                      custom_black_list=["conv2d", "linear"]),
    "O2_custom": dict(level="O2", dtype="bfloat16",
                      custom_black_list=["relu", "flatten"]),
    "off": dict(enable=False, level="O2", dtype="float16"),
}


def _name(dt):
    return None if dt is None else jnp.dtype(dt).name if not isinstance(
        dt, torch.dtype) else str(dt).replace("torch.", "")


@pytest.mark.parametrize("scope", sorted(SCOPES))
def test_amp_dtype_for_matches_jax_op_by_op(scope):
    kw = SCOPES[scope]
    with paddle.amp.auto_cast(**kw):
        want = {op: _name(jax_amp_dtype_for(op)) for op in OPS}
    with amp.auto_cast(**kw):
        got = {op: _name(amp.amp_dtype_for(op)) for op in OPS}
    assert got == want
    assert amp.amp_dtype_for("conv2d") is None       # the scope has ended


def _functional_cases(r):
    f = lambda *s: r.randn(*s).astype(np.float32)   # noqa: E731
    x4, w4, xt = f(2, 4, 6, 6), f(3, 4, 3, 3), f(2, 3, 5, 5)
    m, v = np.zeros(4, np.float32), np.ones(4, np.float32)
    lbl = r.randint(0, 5, (3,)).astype(np.int64)
    return {
        "linear": (lambda P, t: P.linear(t(f(3, 4)), t(f(4, 5))),) * 2,
        "matmul": (lambda P, t: matmul(t(f(3, 4)), t(f(4, 2))),
                   lambda P, t: paddle.matmul(t(f(3, 4)), t(f(4, 2)))),
        "conv2d": (lambda P, t: P.conv2d(t(x4), t(w4), padding=1),) * 2,
        "conv2d_transpose": (lambda P, t: P.conv2d_transpose(
            t(xt), t(f(3, 2, 2, 2)), stride=2),) * 2,
        "max_pool2d": (lambda P, t: P.max_pool2d(t(x4), 2),) * 2,
        "avg_pool2d": (lambda P, t: P.avg_pool2d(t(x4), 3, 2, 1),) * 2,
        "adaptive_avg_pool2d": (lambda P, t: P.adaptive_avg_pool2d(
            t(x4), 1),) * 2,
        "batch_norm": (lambda P, t: P.batch_norm(t(x4), t(m.copy()),
                                                 t(v.copy()),
                                                 training=True),) * 2,
        "layer_norm": (lambda P, t: P.layer_norm(t(x4), 6, t(f(6)),
                                                 t(f(6))),) * 2,
        "group_norm": (lambda P, t: P.group_norm(t(x4), 2, 1e-5, t(f(4)),
                                                 t(f(4))),) * 2,
        "instance_norm": (lambda P, t: P.instance_norm(t(x4)),) * 2,
        "cross_entropy": (lambda P, t: P.cross_entropy(t(f(3, 5)),
                                                       t(lbl)),) * 2,
        "relu": (lambda P, t: P.relu(t(x4)),) * 2,
        "flatten": (lambda P, t: flatten(t(x4), 1),
                    lambda P, t: paddle.flatten(t(x4), 1)),
    }


@pytest.mark.parametrize("scope", ["O1_fp16", "O2_bf16", "O1_custom",
                                   "O2_custom"])
def test_functionals_cast_as_jax_ops_do(scope):
    kw = SCOPES[scope]
    cases = _functional_cases(np.random.RandomState(0))
    for op, (port_fn, jax_fn) in cases.items():
        with paddle.amp.auto_cast(**kw):
            want = jnp.dtype(jax_fn(JF, paddle.to_tensor)._data.dtype).name
        with amp.auto_cast(**kw):
            got = _name(port_fn(F, torch.from_numpy).dtype)
        assert got == want, (op, got, want)


def test_float16_attention_raises_naming_the_roadmap():
    """No raise any more: a float16 scope casts attention to float16 and
    the port's output is JAX's under the same scope, within float16's
    rounding of one output (2**-10 relative, 1e-3 of the largest)."""
    x = np.random.RandomState(0).randn(1, 8, 2, 64).astype(np.float32)
    q = torch.from_numpy(x)
    with paddle.amp.auto_cast(dtype="float16"):
        want = JF.scaled_dot_product_attention(*(paddle.to_tensor(x),) * 3)
    want = np.asarray(want._data.astype(jnp.float32))
    with amp.auto_cast(dtype="float16"):
        for got in (F.scaled_dot_product_attention(q, q, q),
                    flash_attention(q, q, q)):
            assert got.dtype == torch.float16
            np.testing.assert_allclose(got.float().numpy(), want,
                                       rtol=2.0 ** -10,
                                       atol=1e-3 * np.abs(want).max())
    with amp.auto_cast(dtype="bfloat16"):
        assert F.scaled_dot_product_attention(q, q, q).dtype == \
            torch.bfloat16


def test_decorate_o2_casts_the_model_and_flags_master_weights():
    model = tnn.Sequential(tnn.Linear(4, 4), tnn.BatchNorm1D(4))
    opt = AdamW(parameters=model.named_parameters(), device="cpu")
    m2, o2 = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    assert m2 is model and o2 is opt and opt._multi_precision
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    assert model[1]._mean.dtype == torch.bfloat16
    assert amp.decorate(model, level="O1") is model


# ------------------------------------------------------------ GradScaler
def _nets(seed=0, bn=False):
    """A JAX net and the port's on its weights: Linear(4, 8) [BatchNorm1D]
    ReLU Linear(8, 3)."""
    paddle.seed(seed)
    jl = [jnn.Linear(4, 8)] + ([jnn.BatchNorm1D(8)] if bn else []) + \
        [jnn.ReLU(), jnn.Linear(8, 3)]
    tl = [tnn.Linear(4, 8)] + ([tnn.BatchNorm1D(8)] if bn else []) + \
        [tnn.ReLU(), tnn.Linear(8, 3)]
    jm, tm = jnn.Sequential(*jl), tnn.Sequential(*tl)
    state = {}
    for k, v in jm.state_dict().items():
        a = np.asarray(v.numpy())
        state[k] = torch.tensor(a)
    tm.load_state_dict(state)
    return jm, tm


def _params_close(jm, tm, what):
    jsd = jm.state_dict()
    for k, v in tm.state_dict().items():
        want = np.asarray(jsd[k].numpy())
        np.testing.assert_allclose(v.detach().numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max() + 1e-7,
                                   err_msg=f"{what} {k}")


def _loss_inputs(step, r):
    x = r.randn(6, 4).astype(np.float32)
    if step in (2, 3, 6):                 # overflowing steps
        x[1, 2] = np.inf
    return x, r.randint(0, 3, (6,)).astype(np.int64)


def test_grad_scaler_scripted_run_matches_jax():
    jm, tm = _nets()
    kw = dict(init_loss_scaling=1024.0, incr_ratio=2.0, decr_ratio=0.25,
              incr_every_n_steps=2, decr_every_n_nan_or_inf=2)
    js, ts = paddle.amp.GradScaler(**kw), amp.GradScaler(**kw, device="cpu")
    jopt = paddle.optimizer.SGD(learning_rate=0.1,
                                parameters=jm.parameters())
    topt = SGD(learning_rate=0.1, parameters=tm.named_parameters(),
               device="cpu")
    r = np.random.RandomState(0)
    for step in range(8):
        x, y = _loss_inputs(step, r)
        jloss = JF.cross_entropy(jm(paddle.to_tensor(x)), paddle.to_tensor(y))
        tloss = F.cross_entropy(tm(torch.from_numpy(x)), torch.from_numpy(y))
        if step == 5:
            js.minimize(jopt, jloss)
            ts.minimize(topt, tloss)
        else:
            js.scale(jloss).backward()
            ts.scale(tloss).backward()
            if step % 2:
                js.unscale_(jopt)
                ts.unscale_(topt)
            js.step(jopt)
            ts.step(topt)
            js.update()
            ts.update()
            jopt.clear_grad()
            topt.clear_grad()
        assert ts.get_loss_scaling().item() == float(js.get_loss_scaling()), \
            step
        _params_close(jm, tm, f"step {step}")
    assert ts.state_dict() == {k: (float(v) if k == "scale" else v)
                               for k, v in js.state_dict().items()}
    fresh = amp.GradScaler(device="cpu")
    fresh.load_state_dict(ts.state_dict())
    assert fresh.state_dict() == ts.state_dict()


def test_train_step_with_scaler_skips_an_overflowing_step_as_jax():
    jm, tm = _nets(seed=4, bn=True)
    kw = dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2)
    js, ts = paddle.amp.GradScaler(**kw), amp.GradScaler(**kw, device="cpu")
    jopt = paddle.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                     parameters=jm.parameters())
    topt = Momentum(learning_rate=0.1, momentum=0.9,
                    parameters=tm.named_parameters(), device="cpu")

    def jloss_fn(net, x, y):
        return JF.cross_entropy(net(x), y)

    def tloss_fn(net, x, y):
        return F.cross_entropy(net(x), y)

    jstep = paddle.jit.TrainStep(jm, jloss_fn, jopt, scaler=js)
    tstep = TrainStep(tm, tloss_fn, topt, scaler=ts, device="cpu")
    r = np.random.RandomState(1)
    for step in range(3):
        # inputs of 1e3 (the BatchNorm takes the scale out of the
        # forward): the first layer's gradients are ~1e3 times the loss,
        # so a scale of 2**124 overflows them and not the loss
        x = (r.randn(6, 4) * 1e3).astype(np.float32)
        y = r.randint(0, 3, (6,)).astype(np.int64)
        if step == 1:
            js.set_init_loss_scaling(2.0 ** 124)
            ts.set_init_loss_scaling(2.0 ** 124)
            before = {k: v.clone() for k, v in tm.state_dict().items()}
            vel = {k: v.clone() for k, v in topt.state_dict().items()
                   if k.endswith("velocity")}
        jl = float(jstep(paddle.to_tensor(x), paddle.to_tensor(y)))
        tl = tstep(torch.from_numpy(x), torch.from_numpy(y)).item()
        assert abs(tl - jl) <= 1e-5 * abs(jl), (step, tl, jl)
        _params_close(jm, tm, f"step {step}")
        assert ts.get_loss_scaling().item() == float(js._scale), step
        assert (int(ts._good_steps), int(ts._bad_steps)) == (
            int(js._good_steps), int(js._bad_steps)), step
        if step == 1:
            after = tm.state_dict()
            for k, v in before.items():
                moved = not torch.equal(after[k], v)
                assert moved == k.endswith(("_mean", "_variance")), k
            for k, v in topt.state_dict().items():
                if k.endswith("velocity"):
                    assert torch.equal(v, vel[k]), k
            assert ts.get_loss_scaling().item() == 2.0 ** 123
            assert np.isfinite(tl)
    assert topt._step_count == 3


def test_train_step_returns_aux_detached():
    _, tm = _nets()
    opt = SGD(learning_rate=0.1, parameters=tm.named_parameters(),
              device="cpu")

    def loss_fn(net, x, y):
        logits = net(x)
        return F.cross_entropy(logits, y), (logits, {"x": x})

    step = TrainStep(tm, loss_fn, opt, has_aux=True, device="cpu")
    loss, (logits, extra) = step(torch.randn(6, 4),
                                 torch.randint(0, 3, (6,)))
    assert loss.dim() == 0 and not loss.requires_grad
    assert logits.shape == (6, 3) and not logits.requires_grad
    assert extra["x"].shape == (6, 4)
