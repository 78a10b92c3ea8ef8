"""The port's initializers (``paddle_tpu_torch.nn.initializer``) against
the JAX package's on the CPU.

For the twelve classes (the base and eleven initializers) at the shapes
``[in, out]``, ``[out, in, 3, 3]`` and a 1-D shape: the shape and dtype
of what each makes (JAX's from one ``jax.eval_shape`` of all of them),
and ``_fans`` term for term.  At ``[256, 256]``: each random
initializer's mean and std within 4 standard errors of the values
JAX's formulas give (its ``_fans``, gains and bounds); ``Constant``,
``Assign`` and ``Dirac`` exactly equal to JAX's; ``Orthogonal``'s
W Wᵀ = I within 1e-5.  ``calculate_gain`` equals JAX's for every
nonlinearity, and ``set_global_initializer`` is stored and read by
nothing, as JAX's.

The draws differ from JAX's threefry bits by design (the port's counter
stream); what is held is what the bits are drawn from.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn.initializer as JI
import paddle_tpu.nn.initializer.initializer as jinit
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.initializer as TI
import paddle_tpu_torch.nn.initializer.initializer as tinit

from _torch_port_util import one_thread  # noqa: F401

SHAPES = {"in_out": (24, 40), "conv": (16, 8, 3, 3), "vector": (12,)}

ASSIGN_VALUE = {k: np.random.RandomState(3).randn(*s).astype(np.float32)
                for k, s in SHAPES.items()}


def _cases(lib, key):
    """``{name: initializer}`` of one library (``JI`` or ``TI``), the
    Assign value for shape ``key``."""
    shape = SHAPES[key]
    return {
        "Constant": lib.Constant(0.5),
        "Normal": lib.Normal(0.25, 2.0),
        "TruncatedNormal": lib.TruncatedNormal(0.0, 0.5),
        "Uniform": lib.Uniform(-0.5, 1.5),
        "XavierNormal": lib.XavierNormal(),
        "XavierUniform": lib.XavierUniform(gain=2.0),
        "KaimingNormal": lib.KaimingNormal(),
        "KaimingUniform": lib.KaimingUniform(negative_slope=0.2,
                                             nonlinearity="leaky_relu"),
        "Assign": lib.Assign(ASSIGN_VALUE[key]),
        "Dirac": lib.Dirac() if len(shape) >= 2 else None,
        "Orthogonal": lib.Orthogonal(gain=1.5) if len(shape) >= 2 else None,
    }


@pytest.fixture(scope="module")
def jax_shapes():
    """JAX's output (shape, dtype) of every case, from one
    ``jax.eval_shape``."""
    def all_cases():
        return {(key, name): init(shape, jnp.float32)
                for key, shape in SHAPES.items()
                for name, init in _cases(JI, key).items()
                if init is not None}
    return {k: (tuple(v.shape), np.dtype(v.dtype).name)
            for k, v in jax.eval_shape(all_cases).items()}


def test_the_twelve_classes_are_exported():
    names = ["Assign", "Constant", "Dirac", "Initializer", "KaimingNormal",
             "KaimingUniform", "Normal", "Orthogonal", "TruncatedNormal",
             "Uniform", "XavierNormal", "XavierUniform"]
    for n in names:
        assert issubclass(getattr(TI, n), TI.Initializer)
        assert hasattr(JI, n)
    with pytest.raises(NotImplementedError):
        TI.Initializer()((2, 2), device="cpu")


@pytest.mark.parametrize("key", list(SHAPES))
def test_shape_dtype_and_fans_match_jax(jax_shapes, key):
    shape = SHAPES[key]
    assert tinit._fans(shape) == jinit._fans(shape)
    for name, init in _cases(TI, key).items():
        if init is None:
            continue
        t = init(shape, torch.float32, device="cpu")
        assert (tuple(t.shape), str(t.dtype).split(".")[1]) == \
            jax_shapes[(key, name)], name
        assert t.device.type == "cpu"
    for dt in ("bfloat16", "float16", "float64"):
        t = TI.XavierNormal()(shape, dt, device="cpu")
        assert str(t.dtype).split(".")[1] == dt


def test_fans_of_every_rank_match_jax():
    for shape in [(), (7,), (5, 9), (4, 3, 5), (6, 2, 3, 3), (2, 3, 1, 2, 2)]:
        assert tinit._fans(shape) == jinit._fans(shape), shape


def _analytic(name, shape):
    """(mean, std) of JAX's initializer ``name`` at ``shape``, from its
    own formulas and ``_fans``."""
    fin, fout = jinit._fans(shape)
    j = _cases(JI, "in_out")[name]
    if name == "Normal":
        return j.mean, j.std
    if name == "TruncatedNormal":
        a, b = j.a, j.b
        pdf = lambda x: math.exp(-x * x / 2) / math.sqrt(2 * math.pi)
        cdf = lambda x: 0.5 * (1 + math.erf(x / math.sqrt(2)))
        z = cdf(b) - cdf(a)
        var = 1 + (a * pdf(a) - b * pdf(b)) / z - ((pdf(a) - pdf(b)) / z) ** 2
        return j.mean + j.std * (pdf(a) - pdf(b)) / z, j.std * math.sqrt(var)
    if name == "Uniform":
        return (j.low + j.high) / 2, (j.high - j.low) / math.sqrt(12)
    if name == "XavierNormal":
        return 0.0, j.gain * math.sqrt(2.0 / (fin + fout))
    if name == "XavierUniform":
        return 0.0, j.gain * math.sqrt(6.0 / (fin + fout)) / math.sqrt(3)
    gain = math.sqrt(2.0 / (1 + j.negative_slope ** 2))
    if name == "KaimingNormal":
        return 0.0, gain / math.sqrt(fin)
    return 0.0, gain * math.sqrt(3.0 / fin) / math.sqrt(3)


@pytest.mark.parametrize("name", ["Normal", "TruncatedNormal", "Uniform",
                                  "XavierNormal", "XavierUniform",
                                  "KaimingNormal", "KaimingUniform"])
def test_moments_match_jax_formulas(name):
    shape = (256, 256)
    pt.seed(11)
    t = _cases(TI, "in_out")[name](shape, device="cpu").double()
    mean, std = _analytic(name, shape)
    n = t.numel()
    # standard errors of the mean and (for kurtosis <= 3) of the std
    assert abs(t.mean().item() - mean) < 4 * std / math.sqrt(n), name
    assert abs(t.std().item() - std) < 4 * std / math.sqrt(2 * n), name
    if name == "TruncatedNormal":
        j = _cases(JI, "in_out")[name]
        assert t.min() >= j.mean + j.a * j.std - 1e-6
        assert t.max() <= j.mean + j.b * j.std + 1e-6


def test_exact_initializers_equal_jax():
    shape = (16, 8, 3, 3)
    for name in ("Constant", "Assign", "Dirac"):
        want = np.asarray(_cases(JI, "conv")[name](shape, jnp.float32))
        got = _cases(TI, "conv")[name](shape, device="cpu").numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)
    want = np.asarray(JI.Dirac(groups=2)((6, 2, 3), jnp.float32))
    np.testing.assert_array_equal(
        TI.Dirac(groups=2)((6, 2, 3), device="cpu").numpy(), want)


def test_orthogonal_rows_are_orthonormal():
    pt.seed(5)
    w = TI.Orthogonal()((256, 256), device="cpu").double()
    np.testing.assert_allclose((w @ w.T).numpy(), np.eye(256), rtol=0,
                               atol=1e-5)
    wide = TI.Orthogonal(gain=2.0)((8, 32), device="cpu").double()
    np.testing.assert_allclose((wide @ wide.T).numpy(), 4 * np.eye(8),
                               rtol=0, atol=1e-5)
    with pytest.raises(ValueError):                 # as JAX's
        JI.Orthogonal()((5,), jnp.float32)
    with pytest.raises(ValueError):
        TI.Orthogonal()((5,), device="cpu")


def test_each_random_initializer_takes_one_key():
    for name in ("Normal", "TruncatedNormal", "Uniform", "XavierNormal",
                 "XavierUniform", "KaimingNormal", "KaimingUniform",
                 "Orthogonal"):
        pt.seed(0)
        a = _cases(TI, "in_out")[name]((4, 6), device="cpu")
        assert pt.get_rng_state() == (0, 1), name
        pt.seed(0)
        np.testing.assert_array_equal(
            _cases(TI, "in_out")[name]((4, 6), device="cpu").numpy(),
            a.numpy())
    pt.seed(0)
    TI.Constant(1.0)((3,), device="cpu")
    assert pt.get_rng_state() == (0, 0)


@pytest.mark.parametrize("nonlinearity", [
    "sigmoid", "linear", "conv1d", "conv2d", "conv3d", "tanh", "relu",
    "leaky_relu", "selu"])
def test_calculate_gain_matches_jax(nonlinearity):
    assert TI.calculate_gain(nonlinearity) == JI.calculate_gain(nonlinearity)
    assert TI.calculate_gain("leaky_relu", 0.3) == \
        JI.calculate_gain("leaky_relu", 0.3)
    with pytest.raises(ValueError):
        TI.calculate_gain("swishy")


def test_global_initializer_is_stored_and_unread_as_in_jax():
    """Reference caveat: JAX's ``create_parameter`` never reads
    ``_GLOBAL_INIT``; the port's neither."""
    from paddle_tpu.nn.layer.layers import Layer as JLayer

    try:
        JI.set_global_initializer(JI.Constant(7.0), JI.Constant(3.0))
        TI.set_global_initializer(TI.Constant(7.0), TI.Constant(3.0))
        assert isinstance(TI._GLOBAL_INIT[0], TI.Constant)
        jw = JLayer().create_parameter([4], default_initializer=JI.Constant(1))
        tw = pt.nn.Layer().create_parameter(
            [4], default_initializer=TI.Constant(1), device="cpu")
        np.testing.assert_array_equal(tw.detach().numpy(), jw.numpy())
        assert (tw == 1).all()
    finally:
        JI.set_global_initializer(None, None)
        TI.set_global_initializer(None, None)


def test_lazy_guard_changes_nothing():
    with pt.LazyGuard():
        lin = pt.nn.Linear(3, 4, device="cpu")
    assert lin.weight.shape == (3, 4) and not lin.weight.is_meta
