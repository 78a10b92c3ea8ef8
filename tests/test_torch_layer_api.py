"""The port's root namespace, ``nn.Layer``, ``ParamAttr``, the
regularizers, the clips and ``nn.utils`` against the JAX package on the
CPU, on numpy-seeded values.

* The export set: every name of the root, ``nn`` and ``vision`` that
  ROADMAP.md's Queue 1 item 1 lists is present, and the layers that take
  ``weight_attr``/``bias_attr`` have JAX's positional parameters
  (``device``/``dtype`` are keyword-only in the port).  Importing the
  package builds no kernel and imports no serving module.
* ``Layer`` keeps ``torch.nn.Module``'s ``__call__``, ``__getattr__``,
  ``__setattr__`` and ``__delattr__``; every public layer is a ``Layer``.
* ``set_device``/``get_device``, ``to_tensor``'s dtypes, the dtype names,
  ``set_default_dtype``, ``finfo``/``iinfo``, the flags and ``grad``.
* ``create_parameter`` with every ``ParamAttr`` field, ``state_dict``
  keys, shapes and order of one ``Layer`` subclass, ``LayerDict``,
  ``ParameterList``, the forward hooks and ``HookRemoveHelper``,
  ``weight_norm`` and ``spectral_norm``, the clips.
* One Momentum and one AdamW step over a net with per-parameter
  ``ParamAttr`` regularizers, a learning-rate multiplier and a frozen
  bias, against JAX's within the optimizer tests' tolerance (1e-6 of
  each parameter's scale: the same f32 operations, an ulp apart where
  XLA fuses).
* The two faults ROADMAP.md Queue 3 recorded: paddle's ``[in, out]``
  ``Linear`` weight (``F.linear`` on a square weight; JAX-written
  ``state_dict``\\ s of a ``Linear``, a tiny ResNet and a tiny BERT
  loaded as they are), and JAX's keywords ``verbose``, ``lazy_mode``,
  ``group_name`` and ``auto_skip_clip``.

The JAX models' forwards run in one ``jax.jit`` each (their parameters
swapped for traced arrays with ``use_state``); the rest is a few eager
JAX ops on tiny shapes.
"""

import dataclasses
import inspect
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.vision as jvision
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.framework.param_attr import ParamAttr as JParamAttr
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import BertForMaskedLM as JBertForMaskedLM
from paddle_tpu.nn.utils import (
    remove_weight_norm as jremove_weight_norm,
    spectral_norm as jspectral_norm, weight_norm as jweight_norm,
)
from paddle_tpu.regularizer import L1Decay as JL1Decay
from paddle_tpu.regularizer import L2Decay as JL2Decay
from paddle_tpu.vision.models import resnet18 as jresnet18

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.models import BertConfig, BertForMaskedLM
from paddle_tpu_torch.regularizer import L1Decay, L2Decay

from _torch_jax_table import close, numpy_init
from _torch_port_util import one_thread  # noqa: F401

ROOT_NAMES = [
    "to_tensor", "no_grad", "enable_grad", "set_grad_enabled",
    "is_grad_enabled", "grad", "float16", "bfloat16", "float32", "float64",
    "int8", "int16", "int32", "int64", "uint8", "bool_", "complex64",
    "complex128", "set_default_dtype", "get_default_dtype", "set_device",
    "get_device", "device_count", "is_compiled_with_cuda", "synchronize",
    "set_flags", "get_flags", "finfo", "iinfo", "Tensor", "Parameter",
    "Layer", "LazyGuard", "in_dynamic_mode"]
ROOT_SUBPACKAGES = ["optimizer", "jit", "models", "serving", "quantization",
                    "distributed", "regularizer", "device"]
NN_NAMES = ["Layer", "LayerDict", "ParameterList", "Parameter", "ParamAttr",
            "initializer", "utils", "ClipGradByNorm", "ClipGradByValue",
            "ClipGradByGlobalNorm", "clip_grad_norm_", "clip_grad_value_"]
VISION_NAMES = ["set_image_backend", "get_image_backend", "image_load"]
ATTR_LAYERS = [
    "Linear", "Bilinear", "Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
    "Conv2DTranspose", "Conv3DTranspose", "Embedding", "GroupNorm",
    "LayerNorm", "RMSNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
    "BatchNorm3D", "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D",
    "PReLU", "MultiHeadAttention", "Transformer", "TransformerEncoderLayer",
    "TransformerDecoderLayer", "SimpleRNNCell", "LSTMCell", "GRUCell",
    "SimpleRNN", "LSTM", "GRU"]


def _port_globals():
    """The port's process-wide settings that a test may change."""
    return (tdevice._CURRENT[0], pt.get_default_dtype(), dict(tflags._FLAGS),
            list(pt.nn.initializer._GLOBAL_INIT))


DEFAULT_GLOBALS = (None, torch.float32, tflags._DEFAULTS, [None, None])


@pytest.fixture(autouse=True, scope="module")
def port_globals_at_their_defaults():
    """``set_device``, ``set_default_dtype``, ``set_flags`` and
    ``set_global_initializer`` are at their defaults when this file
    starts and when it ends: each port test file that changes one
    restores it, so the files that a worker runs after it see none of
    its settings."""
    assert _port_globals() == DEFAULT_GLOBALS
    yield
    assert _port_globals() == DEFAULT_GLOBALS


@pytest.fixture(autouse=True)
def own_device_and_dtype(monkeypatch):
    """Each test starts with no device chosen and float32 as the default
    dtype, and leaves them so."""
    monkeypatch.setattr(tdevice, "_CURRENT", [None])
    yield
    pt.set_default_dtype("float32")
    paddle.set_default_dtype("float32")


def _np(t):
    return (t._data if isinstance(t, JTensor) else t.detach()).__array__()


# ---------------- the export set ----------------

def test_export_set_matches_jax():
    for name in ROOT_NAMES + ROOT_SUBPACKAGES:
        assert hasattr(paddle, name), name
        assert hasattr(pt, name), name
    for name in NN_NAMES:
        assert hasattr(jnn, name) and hasattr(tnn, name), name
    zoo = [n for n in pt.vision.models.__all__ if hasattr(jvision, n)]
    assert len(zoo) >= 45
    for name in zoo + VISION_NAMES:
        assert hasattr(jvision, name) and hasattr(pt.vision, name), name
    assert pt.vision.resnet50 is pt.vision.models.resnet50
    assert pt.in_dynamic_mode() is True
    assert issubclass(tnn.Parameter, torch.nn.Parameter)
    assert pt.Tensor is torch.Tensor


@pytest.mark.parametrize("name", ATTR_LAYERS)
def test_attr_layers_take_jax_positional_parameters(name):
    def positional(cls):
        sig = inspect.signature(cls.__init__)
        return [p.name for p in sig.parameters.values()
                if p.kind in (p.POSITIONAL_OR_KEYWORD, p.VAR_POSITIONAL,
                              p.VAR_KEYWORD)]

    port = getattr(tnn, name)
    assert positional(port) == positional(getattr(jnn, name))
    kw_only = [p.name for p in inspect.signature(
        port.__init__).parameters.values() if p.kind == p.KEYWORD_ONLY]
    assert set(kw_only) <= {"device", "dtype"}


def test_import_builds_no_kernel_and_no_serving():
    code = ("import sys, paddle_tpu_torch as p; "
            "bad = [m for m in sys.modules if m.startswith(("
            "'paddle_tpu_torch.serving', 'jax', 'paddle_tpu.', 'triton'))"
            " or m == 'paddle_tpu']; "
            "assert not bad, bad; "
            "import paddle_tpu_torch._build as b; "
            "assert not b._LIBS, b._LIBS; "
            "assert p.serving.Engine; print('ok')")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr[-2000:]


# ---------------- Layer ----------------

def test_layer_keeps_torch_dunder_methods_and_every_layer_is_one():
    for name in ("__call__", "__getattr__", "__setattr__", "__delattr__"):
        assert getattr(tnn.Layer, name) is getattr(torch.nn.Module, name)
    import paddle_tpu_torch.incubate.nn as tinc_nn
    import paddle_tpu_torch.models as tmodels

    n = 0
    for mod in (tnn, pt.vision.models, tmodels, tinc_nn):
        for obj in vars(mod).values():
            if isinstance(obj, type) and issubclass(obj, torch.nn.Module):
                assert issubclass(obj, tnn.Layer), obj
                n += 1
    assert n > 150
    net = pt.vision.resnet18(num_classes=4, device="cpu")
    assert all(isinstance(m, tnn.Layer) for m in net.sublayers())


def test_set_device_and_to_tensor():
    if not torch.cuda.is_available():
        for name in ("gpu", "gpu:0", "cuda"):
            with pytest.raises(RuntimeError):      # no fallback, unlike JAX's
                pt.set_device(name)
        with pytest.raises(RuntimeError):
            pt.get_device()
        # a layer, its parameters and the initializers default to the
        # card, as to_tensor and the model constructors do
        for build in (lambda: pt.nn.Linear(2, 3),
                      lambda: pt.nn.BatchNorm1D(3, weight_attr=False,
                                                bias_attr=False),
                      lambda: pt.nn.Layer().create_parameter([2]),
                      lambda: pt.nn.initializer.Normal()([2]),
                      lambda: pt.to_tensor([1.0])):
            with pytest.raises(RuntimeError, match="CUDA"):
                build()
    else:
        assert pt.nn.Linear(2, 3).weight.device.type == "cuda"
    assert pt.nn.Linear(2, 3, device="meta").weight.device.type == "meta"
    with pytest.raises(ValueError):
        pt.set_device("xpu")
    assert pt.set_device("cpu") == torch.device("cpu")
    assert pt.resolve_device(None) == torch.device("cpu")
    assert pt.get_device() == "cpu:0"
    assert pt.nn.Linear(2, 3).weight.device.type == "cpu"
    assert pt.device_count() == torch.cuda.device_count()
    pt.synchronize()
    for data, dtype in [(1.5, None), (3, None), (True, None),
                        ([1.0, 2.0], None), ([1, 2], None),
                        (np.ones(3), None), (np.arange(3), None),
                        (np.ones(2, np.float16), None),
                        ([1.0, 2.0], "bfloat16"), (2, "int64")]:
        j = paddle.to_tensor(data, dtype=dtype)
        t = pt.to_tensor(data, dtype=dtype)
        assert str(t.dtype).split(".")[1] == np.dtype(j._data.dtype).name
        assert t.device.type == "cpu" and not t.requires_grad
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j._data, np.float32))
    # float64 asked for is float64 (JAX's, with x64 off, is float32)
    assert pt.to_tensor(2, dtype="float64").dtype == torch.float64
    t = pt.to_tensor([1.0, 2.0], stop_gradient=False)
    assert t.requires_grad and t.is_leaf
    src = torch.ones(2)
    assert pt.to_tensor(src).data_ptr() != src.data_ptr()


def test_dtypes_default_dtype_finfo_iinfo_and_flags():
    for name in ("float16", "bfloat16", "float32", "float64", "int8",
                 "int16", "int32", "int64", "uint8", "bool_", "complex64",
                 "complex128"):
        assert np.dtype(getattr(paddle, name)).name == \
            str(getattr(pt, name)).split(".")[1].replace("bool", "bool")
    pt.set_default_dtype("float64")
    paddle.set_default_dtype("float64")
    assert pt.get_default_dtype() is torch.float64
    assert pt.nn.Layer().create_parameter([2], device="cpu").dtype == \
        torch.float64
    assert pt.zeros([2], device="cpu").dtype == torch.float64
    assert torch.get_default_dtype() is torch.float32
    for d in ("float16", "bfloat16", "float32", "float64"):
        a, b = paddle.finfo(d), pt.finfo(d)
        assert (a.min, a.max, a.eps, a.tiny, a.resolution, a.bits,
                a.dtype) == (b.min, b.max, b.eps, b.tiny, b.resolution,
                             b.bits, b.dtype), d
    assert pt.finfo(torch.bfloat16).eps == paddle.finfo("bfloat16").eps
    for d in ("int8", "int16", "int32", "int64", "uint8"):
        a, b = paddle.iinfo(d), pt.iinfo(d)
        assert (a.min, a.max, a.bits, a.dtype) == (b.min, b.max, b.bits,
                                                    b.dtype), d
    assert pt.get_flags() == paddle.get_flags()
    saved = dict(tflags._FLAGS)
    try:
        pt.set_flags({"FLAGS_log_level": "DEBUG", "new_flag": 3})
        assert pt.get_flags(["log_level", "FLAGS_new_flag"]) == {
            "FLAGS_log_level": "DEBUG", "FLAGS_new_flag": 3}
        assert pt.get_flags("nothing_set") == {}
        # JAX's turns on jax_debug_nans; the port its tensor checker
        pt.set_flags({"FLAGS_check_nan_inf": True})
        with pytest.raises(FloatingPointError, match="aten.log"):
            torch.log(torch.tensor([-1.0]))
        pt.set_flags({"check_nan_inf": False})
        assert torch.isnan(torch.log(torch.tensor([-1.0]))).all()
    finally:
        pt.amp.debugging.disable_tensor_checker()
        tflags._FLAGS.clear()
        tflags._FLAGS.update(saved)
    assert pt.get_flags() == paddle.get_flags()


def test_grad_and_grad_modes_match_jax():
    r = np.random.RandomState(0)
    xa, wa = r.randn(3, 4).astype(np.float32), r.randn(4).astype(np.float32)
    jx = paddle.to_tensor(xa, stop_gradient=False)
    jw = paddle.to_tensor(wa, stop_gradient=False)
    jy = (jx * jx * jw).sum()
    jgx, jgw = paddle.grad(jy, [jx, jw])
    tx = pt.to_tensor(xa, place="cpu", stop_gradient=False)
    tw = pt.to_tensor(wa, place="cpu", stop_gradient=False)
    ty = (tx * tx * tw).sum()
    tgx, tgw = pt.grad(ty, [tx, tw])
    np.testing.assert_allclose(tgx.numpy(), _np(jgx), rtol=1e-6)
    np.testing.assert_allclose(tgw.numpy(), _np(jgw), rtol=1e-6)
    (again,) = pt.grad(ty, tw)              # the graph is kept, as JAX's
    np.testing.assert_allclose(again.numpy(), _np(jgw), rtol=1e-6)
    with pytest.raises(RuntimeError):
        pt.grad((tx * 2).sum(), [tx, tw])
    assert pt.grad((tx * 2).sum(), [tx, tw], allow_unused=True)[1] is None
    with pt.no_grad():
        assert not (tx * 2).requires_grad and not pt.is_grad_enabled()
        with pt.enable_grad():
            assert (tx * 2).requires_grad
    pt.set_grad_enabled(False)
    assert not pt.is_grad_enabled()
    pt.set_grad_enabled(True)


def test_create_parameter_matches_jax_for_every_attr_field():
    from paddle_tpu.nn.initializer import Assign as JAssign
    from paddle_tpu.nn.initializer import Constant as JConstant
    from paddle_tpu.nn.layer.layers import Layer as JLayer

    value = np.random.RandomState(1).randn(3, 2).astype(np.float32)
    cases = [
        (dict(name="w_custom", initializer=JConstant(0.3), learning_rate=0.5,
              regularizer=JL2Decay(0.01), trainable=False, need_clip=False),
         dict(name="w_custom", initializer=tnn.initializer.Constant(0.3),
              learning_rate=0.5, regularizer=L2Decay(0.01), trainable=False,
              need_clip=False), False),
        (dict(initializer=JAssign(value), regularizer=JL1Decay(0.2)),
         dict(initializer=tnn.initializer.Assign(value),
              regularizer=L1Decay(0.2)), False),
        (dict(learning_rate=2.0), dict(learning_rate=2.0), True),
    ]
    for jkw, tkw, is_bias in cases:
        jp = JLayer().create_parameter([3, 2], JParamAttr(**jkw),
                                       is_bias=is_bias)
        tp = tnn.Layer().create_parameter([3, 2], tnn.ParamAttr(**tkw),
                                          is_bias=is_bias, device="cpu")
        assert isinstance(tp, tnn.Parameter)
        assert (tp.name == jp.name) or (jkw.get("name") is None)
        assert tp.optimize_attr == jp.optimize_attr
        assert tp.trainable == jp.trainable
        assert tp.stop_gradient == jp.stop_gradient
        assert tp.requires_grad == (not jp.stop_gradient)
        assert type(tp.regularizer).__name__ == \
            type(jp.regularizer).__name__
        assert getattr(tp.regularizer, "coeff", None) == \
            getattr(jp.regularizer, "coeff", None)
        assert list(tp.shape) == jp.shape and tp.dtype == torch.float32
        np.testing.assert_array_equal(tp.detach().numpy(), _np(jp))
    # a name, an Initializer, None and the defaults, as JAX's _to_attr
    tp = tnn.Layer().create_parameter([2], "named", device="cpu")
    assert tp.name == "named" and tp.optimize_attr["learning_rate"] == 1.0
    tp = tnn.Layer().create_parameter([2], tnn.initializer.Constant(4.0),
                                      device="cpu")
    assert (tp == 4.0).all()
    assert (tnn.Layer().create_parameter([5], None, is_bias=True,
                                         device="cpu") == 0).all()
    with pytest.raises(TypeError):
        tnn.Layer().create_parameter([2], 3.0, device="cpu")
    assert tnn.Linear(3, 4, bias_attr=False, device="cpu").bias is None


class _JNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = jnn.Linear(4, 3)
        self.bn = jnn.BatchNorm1D(3)
        self.blocks = jnn.LayerList([jnn.Linear(3, 3), jnn.Linear(3, 2)])
        self.heads = jnn.LayerDict({"a": jnn.Linear(2, 2)})
        self.extra = jnn.ParameterList([paddle.Parameter(
            np.ones(2, np.float32))])
        self.scale = self.create_parameter([2])
        self.register_buffer("step", paddle.to_tensor([0.0]))
        self.register_buffer("tmp", paddle.to_tensor([1.0]),
                             persistable=False)


class _TNet(tnn.Layer):
    def __init__(self):
        super().__init__()
        kw = dict(device="cpu")
        self.fc = tnn.Linear(4, 3, **kw)
        self.bn = tnn.BatchNorm1D(3, **kw)
        self.blocks = tnn.LayerList([tnn.Linear(3, 3, **kw),
                                     tnn.Linear(3, 2, **kw)])
        self.heads = tnn.LayerDict({"a": tnn.Linear(2, 2, **kw)})
        self.extra = tnn.ParameterList([tnn.Parameter(np.ones(2,
                                                              np.float32))])
        self.scale = self.create_parameter([2], **kw)
        self.register_buffer("step", torch.zeros(1))
        self.register_buffer("tmp", torch.ones(1), persistable=False)


def test_state_dict_keys_shapes_and_order_match_jax():
    jsd, tsd = _JNet().state_dict(), _TNet().state_dict()
    assert list(tsd) == list(jsd)
    for k in jsd:
        assert list(tsd[k].shape) == jsd[k].shape, k
    assert "tmp" not in tsd
    net = _TNet()
    vals = {k: np.random.RandomState(i).randn(*v.shape).astype(np.float32)
            for i, (k, v) in enumerate(tsd.items())}
    missing, unexpected = net.set_state_dict(dict(vals, nope=np.zeros(1)))
    assert missing == [] and unexpected == ["nope"]
    for k, v in net.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), vals[k])
    with pytest.raises(ValueError):
        net.set_state_dict({"fc.weight": np.zeros((3, 4), np.float32)})
    names = [n for n, _ in net.named_sublayers()]
    assert names == [n for n, _ in _JNet().named_sublayers()]
    assert net.sublayers(include_self=True)[0] is net
    assert len(list(net.parameters())) == len(_JNet().parameters())
    assert net.full_name().startswith("_tnet_")
    net.fc.weight.grad = torch.ones(4, 3)
    net.clear_gradients()
    assert net.fc.weight.grad is None
    assert net.astype("bfloat16").fc.weight.dtype == torch.bfloat16
    lin = tnn.Linear(2, 2, device="cpu")
    net.add_sublayer("added", lin)
    assert net.added is lin
    p = net.add_parameter("bias2", tnn.Parameter(np.zeros(2, np.float32)))
    assert net.bias2 is p


def test_layer_dict_and_parameter_list():
    d = tnn.LayerDict({"a": tnn.ReLU(), "b": tnn.Linear(2, 2, device="cpu")})
    jd = jnn.LayerDict({"a": jnn.ReLU(), "b": jnn.Linear(2, 2)})
    assert list(d.keys()) == list(jd.keys()) and len(d) == len(jd) == 2
    assert "a" in d and isinstance(d["b"], tnn.Linear)
    assert list(d.state_dict()) == list(jd.state_dict())
    d["c"] = tnn.Tanh()
    assert isinstance(d.pop("c"), tnn.Tanh) and len(d) == 2
    d.update({"e": tnn.ReLU()})
    assert [k for k, _ in d.items()] == ["a", "b", "e"]
    d.clear()
    assert len(d) == 0
    pl = tnn.ParameterList([tnn.Parameter(np.ones(2, np.float32))])
    pl.append(tnn.Parameter(np.zeros(3, np.float32)))
    jpl = jnn.ParameterList([paddle.Parameter(np.ones(2, np.float32))])
    jpl.append(paddle.Parameter(np.zeros(3, np.float32)))
    assert len(pl) == len(jpl) == 2
    assert list(pl.state_dict()) == list(jpl.state_dict()) == ["0", "1"]
    assert [list(p.shape) for p in pl] == [p.shape for p in jpl]
    assert isinstance(pl, tnn.Layer)


def _linear_pair(i, o, seed):
    r = np.random.RandomState(seed)
    w, b = r.randn(i, o).astype(np.float32), r.randn(o).astype(np.float32)
    jl = jnn.Linear(i, o)
    jl.set_state_dict({"weight": w, "bias": b})
    tl = tnn.Linear(i, o, device="cpu")
    tl.set_state_dict({"weight": w, "bias": b})
    return jl, tl


def test_forward_hooks_and_their_removal_match_jax():
    jl, tl = _linear_pair(4, 3, 0)
    x = np.random.RandomState(1).randn(2, 4).astype(np.float32)
    handles = []
    for layer in (jl, tl):
        handles.append((
            layer.register_forward_pre_hook(lambda m, inp: (inp[0] * 2,)),
            layer.register_forward_post_hook(lambda m, inp, out: out + 1)))
    assert isinstance(handles[1][0], tnn.layers.HookRemoveHelper)
    want = _np(jl(paddle.to_tensor(x)))
    np.testing.assert_allclose(tl(torch.from_numpy(x)).detach().numpy(),
                               want, rtol=1e-6, atol=1e-6)
    for pre, post in handles:
        pre.remove()
    want = _np(jl(paddle.to_tensor(x)))
    np.testing.assert_allclose(tl(torch.from_numpy(x)).detach().numpy(),
                               want, rtol=1e-6, atol=1e-6)
    for _, post in handles:
        post.remove()
    np.testing.assert_allclose(tl(torch.from_numpy(x)).detach().numpy(),
                               _np(jl(paddle.to_tensor(x))), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dim", [0, 1, None])
def test_weight_norm_matches_jax(dim):
    jl, tl = _linear_pair(4, 3, 2)
    x = np.random.RandomState(3).randn(2, 4).astype(np.float32)
    jweight_norm(jl, dim=dim)
    tnn.utils.weight_norm(tl, dim=dim)
    assert list(dict(tl.named_parameters())) == \
        list(dict(jl.named_parameters()))
    for n in ("weight_g", "weight_v"):
        np.testing.assert_allclose(getattr(tl, n).detach().numpy(),
                                   _np(getattr(jl, n)), rtol=1e-6)
    np.testing.assert_allclose(tl(torch.from_numpy(x)).detach().numpy(),
                               _np(jl(paddle.to_tensor(x))), rtol=1e-5,
                               atol=1e-6)
    jremove_weight_norm(jl)
    tnn.utils.remove_weight_norm(tl)
    np.testing.assert_allclose(tl.weight.detach().numpy(), _np(jl.weight),
                               rtol=1e-6, atol=1e-7)
    assert isinstance(tl.weight, tnn.Parameter)


@pytest.mark.parametrize("dim", [0, 1])
def test_spectral_norm_matches_jax(dim):
    jl, tl = _linear_pair(5, 4, 4)
    x = np.random.RandomState(5).randn(3, 5).astype(np.float32)
    jspectral_norm(jl, n_power_iterations=2, dim=dim)
    tnn.utils.spectral_norm(tl, n_power_iterations=2, dim=dim)
    for grad_on in (True, False, False, True):
        # u carries between forwards only without gradient, as in JAX
        with torch.set_grad_enabled(grad_on), \
                paddle.set_grad_enabled(grad_on):
            np.testing.assert_allclose(
                tl(torch.from_numpy(x)).detach().numpy(),
                _np(jl(paddle.to_tensor(x))), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tl._sn_u.numpy(), np.asarray(jl._sn_u),
                                   rtol=1e-5, atol=1e-6)


def test_parameters_vector_and_clip_utils_match_jax():
    jl, tl = _linear_pair(3, 2, 6)
    vec = tnn.utils.parameters_to_vector(tl.parameters())
    np.testing.assert_array_equal(
        vec.detach().numpy(),
        _np(jnn.utils.parameters_to_vector(jl.parameters())))
    tnn.utils.vector_to_parameters(vec * 2, tl.parameters())
    np.testing.assert_array_equal(tl.weight.detach().numpy(),
                                  2 * _np(jl.weight))
    r = np.random.RandomState(7)
    grads = [r.randn(3, 2).astype(np.float32) * 5,
             r.randn(2).astype(np.float32)]
    for jfn, tfn in [(jnn.clip_grad_norm_, tnn.clip_grad_norm_),
                     (jnn.utils.clip_grad_norm_, tnn.utils.clip_grad_norm_)]:
        for norm_type in (2.0, 1.0, float("inf")):
            jl, tl = _linear_pair(3, 2, 6)
            for jp, tp, g in zip(jl.parameters(), tl.parameters(), grads):
                jp.grad = JTensor(jnp.asarray(g))
                tp.grad = torch.from_numpy(g.copy())
            jt = jfn(jl.parameters(), 1.5, norm_type)
            tt = tfn(tl.parameters(), 1.5, norm_type)
            np.testing.assert_allclose(tt.numpy(), _np(jt), rtol=1e-6)
            for jp, tp in zip(jl.parameters(), tl.parameters()):
                np.testing.assert_allclose(tp.grad.numpy(), _np(jp.grad),
                                           rtol=1e-6, atol=1e-7)
    jl, tl = _linear_pair(3, 2, 6)
    for jp, tp, g in zip(jl.parameters(), tl.parameters(), grads):
        jp.grad = JTensor(jnp.asarray(g))
        tp.grad = torch.from_numpy(g.copy())
    jnn.clip_grad_value_(jl.parameters(), 0.5)
    tnn.clip_grad_value_(tl.parameters(), 0.5)
    for jp, tp in zip(jl.parameters(), tl.parameters()):
        np.testing.assert_array_equal(tp.grad.numpy(), _np(jp.grad))


def test_clip_classes_match_jax():
    r = np.random.RandomState(8)
    gs = [r.randn(3, 4).astype(np.float32) * 3, None,
          r.randn(5).astype(np.float32)]
    jpg = [(None, None if g is None else JTensor(jnp.asarray(g))) for g in gs]
    tpg = [(None, None if g is None else torch.from_numpy(g)) for g in gs]
    for jc, tc in [(jnn.ClipGradByValue(0.7), tnn.ClipGradByValue(0.7)),
                   (jnn.ClipGradByValue(0.5, -0.2),
                    tnn.ClipGradByValue(0.5, -0.2)),
                   (jnn.ClipGradByNorm(1.0), tnn.ClipGradByNorm(1.0)),
                   (jnn.ClipGradByGlobalNorm(1.0, group_name="g"),
                    tnn.ClipGradByGlobalNorm(1.0, group_name="g",
                                             auto_skip_clip=True))]:
        for (_, jg), (_, tg) in zip(jc(jpg), tc(tpg)):
            if jg is None:
                assert tg is None
                continue
            np.testing.assert_allclose(tg.numpy(), _np(jg), rtol=1e-6,
                                       atol=1e-7)


# ---------------- optimizers with ParamAttr ----------------

def _attr_nets():
    """The same three-layer net in both frameworks: layer 0 at half the
    rate with an L1 regularizer, layer 1 with an L2 regularizer and a
    frozen bias, layer 2 plain."""
    jattrs = [(JParamAttr(learning_rate=0.5, regularizer=JL1Decay(0.02)),
               None),
              (JParamAttr(regularizer=JL2Decay(0.03)),
               JParamAttr(trainable=False)), (None, None)]
    tattrs = [(tnn.ParamAttr(learning_rate=0.5, regularizer=L1Decay(0.02)),
               None),
              (tnn.ParamAttr(regularizer=L2Decay(0.03)),
               tnn.ParamAttr(trainable=False)), (None, None)]
    dims = [(4, 6), (6, 5), (5, 3)]
    jnet = jnn.Sequential(*[jnn.Linear(i, o, w, b)
                            for (i, o), (w, b) in zip(dims, jattrs)])
    tnet = tnn.Sequential(*[tnn.Linear(i, o, w, b, device="cpu")
                            for (i, o), (w, b) in zip(dims, tattrs)])
    r = np.random.RandomState(9)
    state = {k: r.randn(*v.shape).astype(np.float32)
             for k, v in jnet.state_dict().items()}
    jnet.set_state_dict(state)
    tnet.set_state_dict(state)
    return jnet, tnet


@pytest.mark.parametrize("which", ["momentum_l2", "momentum_l1", "adamw"])
def test_optimizer_step_with_param_attrs_matches_jax(which):
    jnet, tnet = _attr_nets()
    r = np.random.RandomState(10)
    x, y = r.randn(8, 4).astype(np.float32), r.randn(8, 3).astype(np.float32)
    if which == "adamw":
        jopt = paddle.optimizer.AdamW(1e-2, parameters=jnet.parameters(),
                                      weight_decay=0.01, epsilon=1e-6)
        topt = pt.optimizer.AdamW(1e-2, parameters=tnet.parameters(),
                                  weight_decay=0.01, epsilon=1e-6,
                                  device="cpu")
    else:
        jwd, twd = ((JL2Decay(1e-2), L2Decay(1e-2)) if which == "momentum_l2"
                    else (JL1Decay(1e-2), L1Decay(1e-2)))
        jopt = paddle.optimizer.Momentum(0.1, 0.9, jnet.parameters(),
                                         weight_decay=jwd)
        topt = pt.optimizer.Momentum(0.1, 0.9, tnet.parameters(),
                                     weight_decay=twd, device="cpu")
    frozen = tnet[1].bias.detach().clone()
    for _ in range(2):
        jloss = ((jnet(paddle.to_tensor(x)) - paddle.to_tensor(y)) ** 2).mean()
        jloss.backward()
        jopt.step()
        jopt.clear_grad()
        tloss = ((tnet(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean()
        tloss.backward()
        topt.step()
        topt.clear_grad()
    assert torch.equal(tnet[1].bias.detach(), frozen)
    assert tnet[1].bias.grad is None
    for k, jv in jnet.state_dict().items():
        want = _np(jv)
        got = tnet.state_dict()[k].numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max(), err_msg=k)


def test_half_rate_parameter_moves_half_as_far():
    lin = tnn.Linear(3, 2, tnn.ParamAttr(learning_rate=0.5), device="cpu")
    ref = tnn.Linear(3, 2, device="cpu")
    ref.set_state_dict(lin.state_dict())
    for net in (lin, ref):
        opt = pt.optimizer.SGD(0.1, parameters=net.parameters(), device="cpu")
        net(torch.ones(4, 3)).sum().backward()
        w0 = net.weight.detach().clone()
        opt.step()
        net._delta = net.weight.detach() - w0
    np.testing.assert_allclose(lin._delta.numpy(), 0.5 * ref._delta.numpy(),
                               rtol=1e-6)


# ---------------- the two faults ----------------

def test_linear_takes_paddles_in_out_weight():
    """Queue 3 fault 1: ``F.linear`` on a 4 x 4 ``[in, out]`` weight
    (7.52 apart before the repair)."""
    r = np.random.RandomState(0)
    x, w, b = (r.randn(2, 4).astype(np.float32),
               r.randn(4, 4).astype(np.float32), r.randn(4).astype(np.float32))
    want = _np(JF.linear(paddle.to_tensor(x), paddle.to_tensor(w),
                         paddle.to_tensor(b)))
    got = TF.linear(torch.from_numpy(x), torch.from_numpy(w),
                    torch.from_numpy(b)).numpy()
    assert np.abs(got - want).max() <= 1e-6


def test_layer_to_takes_paddle_dtype_names_and_devices():
    """JAX's ``to(device=None, dtype=None, blocking=None)``: Paddle dtype
    names cast the floating parameters and buffers (an int buffer
    stays), Paddle device names resolve as every entry point's; torch's
    forms keep working."""
    pt.set_device("cpu")
    jl, tl = jnn.Linear(4, 4), tnn.Linear(4, 4)
    for layer in (jl, tl):
        layer.register_buffer("steps", layer.weight * 0 if layer is jl
                              else torch.zeros(2, dtype=torch.int32))
    assert tl.to(dtype="float16") is tl
    jl.to(dtype="float16")
    assert tl.weight.dtype == tl.bias.dtype == torch.float16
    assert _np(jl.weight).dtype == np.float16
    assert tl.steps.dtype == torch.int32
    tl.to(device="cpu", dtype="bfloat16", blocking=True)
    assert (tl.weight.dtype, tl.weight.device.type) == (torch.bfloat16, "cpu")
    tl.to(None, "float64")
    assert tl.weight.dtype == torch.float64
    tl.to(torch.float32)
    tl.to("cpu")
    tl.to(torch.zeros(1, dtype=torch.float16))
    assert tl.weight.dtype == torch.float16
    if not torch.cuda.is_available():
        for name in ("gpu", "gpu:0"):
            with pytest.raises(RuntimeError, match="CUDA"):
                tl.to(device=name)


def test_jax_saved_linear_loads_as_it_is(tmp_path):
    """Queue 3 fault 1: a JAX ``Linear(4, 4)`` saved by ``paddle.save`` and
    loaded into the port's (3.65 apart before the repair)."""
    paddle.seed(4)
    jl = jnn.Linear(4, 4)
    path = str(tmp_path / "lin.pdparams")
    paddle.save(jl.state_dict(), path)
    tl = tnn.Linear(4, 4, device="cpu")
    tl.load_state_dict(pt.load(path, device="cpu"))
    x = np.random.RandomState(0).randn(2, 4).astype(np.float32)
    want = _np(jl(paddle.to_tensor(x)))
    assert np.abs(tl(torch.from_numpy(x)).detach().numpy()
                  - want).max() <= 1e-6


def _jit_forward(jm, state, *inputs):
    """``jm``'s eval forward in one ``jax.jit``, its parameters and
    buffers swapped for ``state``'s arrays."""
    def fwd(arrays, *xs):
        with paddle.no_grad(), jm.use_state(arrays):
            out = jm(*[JTensor(a) for a in xs])
        return out._data
    return np.asarray(jax.jit(fwd)({k: jnp.asarray(v)
                                    for k, v in state.items()}, *inputs))


def test_tiny_resnet_loads_through_model_load(tmp_path):
    with numpy_init(12):
        jm = jresnet18(num_classes=10)
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    rng = np.random.RandomState(13)
    for k in state:                      # running statistics off their init
        if k.endswith("_mean") or k.endswith("_variance"):
            state[k] = (rng.rand(*state[k].shape) + 0.5).astype(np.float32)
    assert state["fc.weight"].shape == (512, 10)
    jm.set_state_dict(state)
    path = str(tmp_path / "resnet")
    paddle.save(jm.state_dict(), path + ".pdparams")
    net = pt.vision.resnet18(num_classes=10, device="cpu")
    pt.Model(net).load(path)
    assert set(net.state_dict()) == set(state)
    net.eval()
    x = rng.randn(2, 3, 32, 32).astype(np.float32)
    want = _jit_forward(jm, state, x)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    close(got, want, "resnet18 logits", rel=1e-4)


def test_tiny_bert_loads_through_model_load(tmp_path):
    cfg = JBertConfig(vocab_size=100, hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=64,
                      max_position_embeddings=64, hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)
    with numpy_init(14):
        jm = JBertForMaskedLM(cfg)
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    path = str(tmp_path / "bert")
    paddle.save(jm.state_dict(), path + ".pdparams")
    net = BertForMaskedLM(BertConfig(**dataclasses.asdict(cfg)),
                          device="cpu")
    pt.Model(net).load(path)
    assert set(net.state_dict()) == set(state)
    net.eval()
    ids = np.random.RandomState(15).randint(0, 100, (2, 10)).astype(np.int32)
    want = _jit_forward(jm, state, ids)
    with torch.no_grad():
        got = net(torch.from_numpy(ids).long())
    close(got, want, "bert logits", rel=1e-5)


def test_jax_keywords_construct(capsys):
    """Queue 3 fault 2: ``verbose``, ``lazy_mode``, ``group_name`` and
    ``auto_skip_clip`` as JAX takes them."""
    for cls in (pt.optimizer.lr.StepDecay, paddle.optimizer.lr.StepDecay):
        s = cls(0.1, 10, verbose=True)
        s.step()
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == out[2:] and len(out) == 4
    assert pt.optimizer.lr.StepDecay(0.1, 10, verbose=False).last_lr == 0.1
    for name in dir(pt.optimizer.lr):
        cls = getattr(pt.optimizer.lr, name)
        if isinstance(cls, type) and issubclass(cls, pt.optimizer.lr.
                                                LRScheduler):
            assert "verbose" in inspect.signature(cls.__init__).parameters
    p = [tnn.Parameter(np.ones(2, np.float32))]
    for cls in (pt.optimizer.Adam, pt.optimizer.AdamW, pt.optimizer.Adamax,
                pt.optimizer.RAdam):
        opt = cls(parameters=p, lazy_mode=False, device="cpu")
        assert opt._lazy_mode is False
    opt = pt.optimizer.Adam(0.001, 0.9, 0.999, 1e-8, p, None, None, True,
                            device="cpu")
    assert opt._lazy_mode is True and opt._multi_precision is False
    clip = tnn.ClipGradByGlobalNorm(1.0, group_name="g", auto_skip_clip=True)
    assert clip.group_name == "g"
