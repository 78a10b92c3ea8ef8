"""The port's vision model zoo (``paddle_tpu_torch.vision.models``) against
the JAX package's on the same weights (``convert.state_from_jax``),
in f32 on the CPU.

* Blocks: MobileNetV1's ``_DepthwiseSeparable``, MobileNetV2's and
  ShuffleNetV2's ``InvertedResidual`` (both strides), MobileNetV3's
  ``_Bneck`` with and without ``SqueezeExcite`` and ``SqueezeExcite``
  alone, DenseNet's ``_DenseLayer`` and ``_Transition``, SqueezeNet's
  ``Fire``, GoogLeNet's ``Inception`` and ``InceptionAux``,
  Inception-v3's ``InceptionA``-``E`` and VGG's ``make_layers`` with and
  without BatchNorm: eval outputs and the input's gradient.
* Whole models at 10 classes: ``LeNet`` (1 x 28 x 28), and
  ``shufflenet_v2_x0_25``, ``mobilenet_v1(scale=0.25)`` and
  ``mobilenet_v3_small(scale=0.25)`` at 32 px: eval logits and the
  input's gradient, ``state_dict`` keys and shapes against JAX's.
* One train-mode step of ``mobilenet_v3_small(scale=0.25)`` at b8 x 64
  px (batch statistics in every BatchNorm; the head's ``Dropout`` at
  p 0 on both sides, whose masks come from different streams by design):
  the logits, the cross-entropy, every parameter's gradient and every
  BatchNorm's running buffers after it.
* The constructors: ``pretrained=True`` raises, the default device is
  the card (raising without one), GoogLeNet's train-mode return is
  ``(out, aux1, aux2)``, ShuffleNetV2's ``act="swish"``.

Weights.  The JAX models draw their initial values from NumPy here
(``numpy_init``: each JAX initializer's distribution, drawn by a seeded
``RandomState`` instead of threefry, whose XLA compile for each distinct
weight shape costs ~0.6 s on the CPU: 19 s for MobileNetV3-Small alone).
The forwards under test are untouched.  The BatchNorm weights, biases
and running buffers are then set to random values in both models, so
the eval forwards use nontrivial statistics.

The JAX side runs its models inside one ``jax.jit`` (a module fixture):
eval forwards with ``jax.vjp`` for the input gradients, and the train
step under ``Layer.use_state`` with ``jax.vjp`` over the parameters.

Tolerances: outputs to 1e-5 of their largest magnitude, gradients to
1e-4 of each tensor's largest magnitude plus 1e-6 of the model's largest
gradient, the loss to 1e-5 relative, buffers to 1e-5 of their largest.
"""

import contextlib
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.nn import layer as jlayer
from paddle_tpu.nn.initializer import initializer as jinit
from paddle_tpu.vision import models as jmodels
from paddle_tpu.vision.models import densenet as jdensenet
from paddle_tpu.vision.models import inceptionv3 as jinception
from paddle_tpu.vision.models import mobilenetv1 as jmv1
from paddle_tpu.vision.models import mobilenetv2 as jmv2
from paddle_tpu.vision.models import mobilenetv3 as jmv3
from paddle_tpu.vision.models import shufflenetv2 as jshuffle
from paddle_tpu.vision.models import squeezenet as jsqueeze
from paddle_tpu.vision.models import vgg as jvgg
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import state_from_jax
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.vision import models as tmodels
from paddle_tpu_torch.vision.models import densenet as tdensenet
from paddle_tpu_torch.vision.models import inceptionv3 as tinception
from paddle_tpu_torch.vision.models import mobilenetv1 as tmv1
from paddle_tpu_torch.vision.models import mobilenetv2 as tmv2
from paddle_tpu_torch.vision.models import mobilenetv3 as tmv3
from paddle_tpu_torch.vision.models import shufflenetv2 as tshuffle
from paddle_tpu_torch.vision.models import squeezenet as tsqueeze
from paddle_tpu_torch.vision.models import vgg as tvgg

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


# the packages export a function of the module's name
jgooglenet = importlib.import_module("paddle_tpu.vision.models.googlenet")
tgooglenet = importlib.import_module(
    "paddle_tpu_torch.vision.models.googlenet")


@contextlib.contextmanager
def numpy_init(seed):
    """JAX's initializers drawing from ``RandomState(seed)`` with their
    own distributions (see the module docstring)."""
    rng = np.random.RandomState(seed)

    def arr(a, dtype):
        return jnp.asarray(np.asarray(a, np.float32), dtype)

    def fan_sum(self, shape):
        fin, fout = jinit._fans(shape)
        return (self.fan_in or fin) + (self.fan_out or fout)

    calls = {
        jinit.Constant: lambda self, shape, dtype=jnp.float32: arr(
            np.full(shape, self.value), dtype),
        jinit.Normal: lambda self, shape, dtype=jnp.float32: arr(
            rng.randn(*shape) * self.std + self.mean, dtype),
        jinit.Uniform: lambda self, shape, dtype=jnp.float32: arr(
            rng.uniform(self.low, self.high, shape), dtype),
        jinit.XavierNormal: lambda self, shape, dtype=jnp.float32: arr(
            rng.randn(*shape) * self.gain * math.sqrt(
                2.0 / fan_sum(self, shape)), dtype),
        jinit.XavierUniform: lambda self, shape, dtype=jnp.float32: arr(
            rng.uniform(-1, 1, shape) * self.gain * math.sqrt(
                6.0 / fan_sum(self, shape)), dtype),
    }
    saved = {c: c.__call__ for c in calls}
    for c, f in calls.items():
        c.__call__ = f
    try:
        yield
    finally:
        for c, f in saved.items():
            c.__call__ = f


def _jax_state(jm):
    return {k: np.array(v.numpy()) for k, v in jm.state_dict().items()}


def _randomize_norms(jm, seed):
    """Every BatchNorm's weight, bias and running buffers at random
    values (weights and variances in [0.5, 1.5])."""
    rng = np.random.RandomState(seed)
    state = _jax_state(jm)
    norms = {n for n, m in jm.named_sublayers()
             if isinstance(m, jlayer.BatchNorm2D)}
    for key in state:
        owner, leaf = key.rsplit(".", 1) if "." in key else ("", key)
        if owner not in norms:
            continue
        if leaf in ("weight", "_variance"):
            state[key] = rng.uniform(0.5, 1.5, state[key].shape)
        else:
            state[key] = rng.randn(*state[key].shape) * 0.1
        state[key] = state[key].astype(np.float32)
    jm.set_state_dict(state)
    return state


def _pair(jbuild, tbuild, seed):
    """The JAX model or block (NumPy initial values, random norms) and
    the port's on its weights, both in eval mode."""
    with numpy_init(seed):
        jm = jbuild()
    state = _randomize_norms(jm, seed + 1)
    tm = tbuild()
    tm.load_state_dict(state_from_jax(state, tm, device="cpu"))
    jm.eval()
    tm.eval()
    return jm, tm, state


CPU = dict(device="cpu")
BLOCKS = {
    "DepthwiseSeparable": (lambda: jmv1._DepthwiseSeparable(8, 12, 2),
                           lambda: tmv1._DepthwiseSeparable(8, 12, 2),
                           (2, 8, 9, 9)),
    "InvertedResidual_v2_res": (
        lambda: jmv2.InvertedResidual(8, 8, 1, 6),
        lambda: tmv2.InvertedResidual(8, 8, 1, 6), (2, 8, 6, 6)),
    "InvertedResidual_v2_s2": (
        lambda: jmv2.InvertedResidual(8, 16, 2, 1),
        lambda: tmv2.InvertedResidual(8, 16, 2, 1), (2, 8, 7, 7)),
    "InvertedResidual_shuffle_s1": (
        lambda: jshuffle.InvertedResidual(16, 16, 1),
        lambda: tshuffle.InvertedResidual(16, 16, 1), (2, 16, 5, 5)),
    "InvertedResidual_shuffle_s2": (
        lambda: jshuffle.InvertedResidual(8, 16, 2),
        lambda: tshuffle.InvertedResidual(8, 16, 2), (2, 8, 7, 7)),
    "Bneck_se_hardswish": (
        lambda: jmv3._Bneck(8, 24, 8, 3, 1, True, jmv3.Hardswish),
        lambda: tmv3._Bneck(8, 24, 8, 3, 1, True, tnn.Hardswish),
        (2, 8, 6, 6)),
    "Bneck_relu_s2": (
        lambda: jmv3._Bneck(8, 16, 12, 5, 2, False, jmv3.ReLU),
        lambda: tmv3._Bneck(8, 16, 12, 5, 2, False, tnn.ReLU),
        (2, 8, 7, 7)),
    "SqueezeExcite": (lambda: jmv3.SqueezeExcite(16),
                      lambda: tmv3.SqueezeExcite(16), (2, 16, 4, 4)),
    "DenseLayer": (lambda: jdensenet._DenseLayer(8, 4, 2, 0.0),
                   lambda: tdensenet._DenseLayer(8, 4, 2, 0.0),
                   (2, 8, 5, 5)),
    "Transition": (lambda: jdensenet._Transition(8, 4),
                   lambda: tdensenet._Transition(8, 4), (2, 8, 6, 6)),
    "Fire": (lambda: jsqueeze.Fire(8, 4, 6, 6),
             lambda: tsqueeze.Fire(8, 4, 6, 6), (2, 8, 5, 5)),
    "Inception": (lambda: jgooglenet.Inception(8, 4, 4, 6, 2, 3, 3),
                  lambda: tgooglenet.Inception(8, 4, 4, 6, 2, 3, 3),
                  (2, 8, 5, 5)),
    "InceptionAux": (lambda: jgooglenet.InceptionAux(8, 5),
                     lambda: tgooglenet.InceptionAux(8, 5), (2, 8, 14, 14)),
    "InceptionA": (lambda: jinception.InceptionA(8, 4),
                   lambda: tinception.InceptionA(8, 4), (2, 8, 5, 5)),
    "InceptionB": (lambda: jinception.InceptionB(8),
                   lambda: tinception.InceptionB(8), (2, 8, 7, 7)),
    "InceptionC": (lambda: jinception.InceptionC(8, 4),
                   lambda: tinception.InceptionC(8, 4), (2, 8, 7, 7)),
    "InceptionD": (lambda: jinception.InceptionD(8),
                   lambda: tinception.InceptionD(8), (2, 8, 7, 7)),
    "InceptionE": (lambda: jinception.InceptionE(8),
                   lambda: tinception.InceptionE(8), (2, 8, 3, 3)),
    "vgg_make_layers": (lambda: jvgg.make_layers([4, "M", 8, 8, "M"]),
                        lambda: tvgg.make_layers([4, "M", 8, 8, "M"]),
                        (2, 3, 8, 8)),
    "vgg_make_layers_bn": (
        lambda: jvgg.make_layers([4, "M", 8, "M"], batch_norm=True),
        lambda: tvgg.make_layers([4, "M", 8, "M"], batch_norm=True),
        (2, 3, 8, 8)),
}
MODELS = {
    "LeNet": (lambda: jmodels.LeNet(), lambda: tmodels.LeNet(**CPU),
              (2, 1, 28, 28)),
    "shufflenet_v2_x0_25": (
        lambda: jmodels.shufflenet_v2_x0_25(num_classes=10),
        lambda: tmodels.shufflenet_v2_x0_25(num_classes=10, **CPU),
        (2, 3, 32, 32)),
    "mobilenet_v1_0.25": (
        lambda: jmodels.mobilenet_v1(scale=0.25, num_classes=10),
        lambda: tmodels.mobilenet_v1(scale=0.25, num_classes=10, **CPU),
        (2, 3, 32, 32)),
    "mobilenet_v3_small_0.25": (
        lambda: jmodels.mobilenet_v3_small(scale=0.25, num_classes=10),
        lambda: tmodels.mobilenet_v3_small(scale=0.25, num_classes=10,
                                           **CPU),
        (2, 3, 32, 32)),
}
TRAIN_BATCH, TRAIN_PX = 8, 64
# XLA's CPU backend at its lowest optimisation: the references compile in
# 2/3 of the time and compute the same functions
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _eval_case(jm, tm, shape, seed):
    """The JAX function of one eval forward (its input gradient comes
    from ``jax.vjp``, so the package's own tape stays off), the input
    and a cotangent of the port's output shape (a wrong shape fails the
    comparison)."""
    r = np.random.RandomState(seed)
    x = r.randn(*shape).astype(np.float32)

    def fn(a):
        with paddle.no_grad():
            return jm(JTensor(a))._data

    with torch.no_grad():
        out_shape = tm(torch.from_numpy(x)).shape
    return fn, x, r.randn(*out_shape).astype(np.float32)


def _train_case(jm, seed):
    """The JAX train-mode loss over the parameters (``use_state``): loss,
    (logits, running buffers after); and its batch."""
    r = np.random.RandomState(seed)
    x = r.randn(TRAIN_BATCH, 3, TRAIN_PX, TRAIN_PX).astype(np.float32)
    y = r.randint(0, 10, (TRAIN_BATCH,)).astype(np.int64)
    sd = jm.state_dict()
    pnames = [n for n, t in sd.items() if not t.stop_gradient]
    bnames = [n for n in sd if n not in pnames]

    def fn(params, a, labels):
        arrays = dict(zip(pnames, params))
        arrays.update({n: sd[n]._data for n in bnames})
        with jm.use_state(arrays) as live, paddle.no_grad():
            logits = jm(JTensor(a))
            loss = JF.cross_entropy(logits, JTensor(labels))
            bufs = [live[n]._data for n in bnames]
        return loss._data, (logits._data, bufs)

    return fn, pnames, bnames, [sd[n]._data for n in pnames], x, y


@pytest.fixture(scope="module")
def zoo():
    """Every pair, and the JAX references from one ``jax.jit``."""
    pairs, cases = {}, {}
    for i, (name, (jb, tb, shape)) in enumerate(
            sorted(BLOCKS.items()) + sorted(MODELS.items())):
        jm, tm, state = _pair(jb, tb, 100 + i)
        pairs[name] = (jm, tm, state)
        cases[name] = _eval_case(jm, tm, shape, 200 + i)
    jt, tt, tstate = _pair(*MODELS["mobilenet_v3_small_0.25"][:2], 300)
    jt.train()
    tt.train()
    for jmod, tmod in ((jt, tt),):
        jmod.classifier[2].p = 0.0        # the head's Dropout
        tmod.classifier[2].p = 0.0
    train_fn, pnames, bnames, pvals, tx, ty = _train_case(jt, 400)

    def run(inputs, cots, pvals, tx, ty):
        res = {}
        for name, (fn, _, _) in cases.items():
            out, pull = jax.vjp(fn, inputs[name])
            res[name] = (out, pull(cots[name])[0])
        (loss, pull, (logits, bufs)) = jax.vjp(
            lambda *p: train_fn(p, tx, ty), *pvals, has_aux=True)
        res["train"] = (loss, logits, bufs, pull(jnp.ones((), loss.dtype)))
        return res

    args = ({k: jnp.asarray(v[1]) for k, v in cases.items()},
            {k: jnp.asarray(v[2]) for k, v in cases.items()}, pvals,
            jnp.asarray(tx), jnp.asarray(ty))
    refs = jax.device_get(jax.jit(run).lower(*args).compile(
        compiler_options=FAST_COMPILE)(*args))
    return dict(pairs=pairs, cases=cases, refs=refs,
                train=(jt, tt, pnames, bnames, tx, ty))


def _close(got, want, what, rel=1e-5, extra=0.0):
    want = np.asarray(want)
    assert np.asarray(got).shape == want.shape, (what, got.shape,
                                                 want.shape)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max() + extra,
                               err_msg=what)


def _check_eval(zoo, name):
    _, tm, _ = zoo["pairs"][name]
    _, x, cot = zoo["cases"][name]
    jout, jgrad = zoo["refs"][name]
    xt = torch.tensor(x, requires_grad=True)
    out = tm(xt)
    _close(out.detach().numpy(), jout, f"{name} output")
    (out * torch.from_numpy(cot)).sum().backward()
    _close(xt.grad.numpy(), jgrad, f"{name} input grad", rel=1e-4)


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(zoo, name):
    _check_eval(zoo, name)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_eval_forward_matches_jax(zoo, name):
    _check_eval(zoo, name)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_state_dict_keys_and_shapes_match_jax(zoo, name):
    """JAX's keys, each with its shape (paddle's ``[in, out]`` Linear
    weights in both)."""
    jm, tm, state = zoo["pairs"][name]
    want = {k: v.shape for k, v in state.items()}
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == want
    assert sum(v.size for v in state.values()) == sum(
        v.numel() for v in tm.state_dict().values())


def test_train_step_matches_jax(zoo):
    """MobileNetV3-Small (0.25) in training mode: logits, loss, every
    gradient and the BatchNorm buffers after the step."""
    jt, tt, pnames, bnames, x, y = zoo["train"]
    jloss, jlogits, jbufs, jgrads = zoo["refs"]["train"]
    logits = tt(torch.from_numpy(x))
    loss = F.cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    _close(logits.detach().numpy(), jlogits, "train logits")
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    params = dict(tt.named_parameters())
    assert set(params) == set(pnames)
    top = max(np.abs(g).max() for g in jgrads)
    for n, g in zip(pnames, jgrads):
        _close(params[n].grad.numpy(), np.asarray(g), f"{n} grad", rel=1e-4,
               extra=1e-6 * top)
    bufs = dict(tt.named_buffers())
    assert set(bufs) == set(bnames)
    for n, b in zip(bnames, jbufs):
        _close(bufs[n].numpy(), b, f"{n} after the step")


def test_converter_raises_on_a_key_mismatch(zoo):
    _, tm, state = zoo["pairs"]["LeNet"]
    with pytest.raises(KeyError):
        state_from_jax({k: v for k, v in state.items()
                        if k != "fc.1.bias"}, tm, device="cpu")
    with pytest.raises(KeyError):
        state_from_jax(dict(state, extra=np.zeros(1)), tm, device="cpu")
    bad = dict(state)
    bad["features.0.weight"] = np.zeros((6, 1, 5, 5), np.float32)
    with pytest.raises(ValueError):
        state_from_jax(bad, tm, device="cpu")
    got = state_from_jax(state, tm, device="cpu")
    np.testing.assert_array_equal(got["fc.1.weight"].numpy(),
                                  state["fc.1.weight"])


CONSTRUCTORS = [n for n in tmodels.__all__ if n[0].islower()
                and not n.startswith(("resnet", "resnext", "wide_"))]


@pytest.mark.parametrize("name", CONSTRUCTORS)
def test_constructor_refuses_pretrained_and_defaults_to_the_card(
        name, monkeypatch):
    """``pretrained=True`` raises; without ``device`` (and with no
    ``set_device``) the model is built on the card, so with none it
    raises before building anything."""
    with pytest.raises(NotImplementedError):
        getattr(tmodels, name)(pretrained=True, device="cpu")
    monkeypatch.setattr(tdevice, "_CURRENT", [None])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            getattr(tmodels, name)()


def test_googlenet_returns_aux_heads_in_training():
    """``(out, aux1, aux2)`` in train mode, the logits alone in eval
    (``googlenet.py:81-97``), at 224 px."""
    m = tmodels.googlenet(num_classes=7, device="cpu", seed=0)
    x = torch.randn(1, 3, 224, 224)
    with torch.no_grad():
        m.train()
        out = m(x)
        m.eval()
        logits = m(x)
    assert isinstance(out, tuple) and len(out) == 3
    assert all(o.shape == (1, 7) for o in out)
    assert logits.shape == (1, 7)


def test_shufflenet_swish_and_seed():
    """``act="swish"`` puts Swish where ReLU was (JAX refuses it;
    ROADMAP.md Queue 3); the same ``seed`` builds the same weights."""
    a = tmodels.shufflenet_v2_x0_25(num_classes=4, act="swish",
                                    device="cpu", seed=3)
    b = tmodels.shufflenet_v2_x0_25(num_classes=4, act="swish",
                                    device="cpu", seed=3)
    assert any(isinstance(m, tnn.Swish) for m in a.modules())
    assert not any(isinstance(m, tnn.ReLU) for m in a.modules())
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    with pytest.raises(NotImplementedError):
        tmodels.shufflenet_v2_x0_25(act="gelu", device="cpu")
