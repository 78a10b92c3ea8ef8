"""The port's loss functionals (``nn.functional``) and loss layers
(``nn.loss``) against the JAX package's on numpy-seeded float32 inputs:
each value, and the gradient of its sum with respect to every float
input JAX differentiates (``jax.grad`` of the JAX functional, traced
under one ``jax.jit``, against torch autograd).

Tolerance: rtol 1e-5 and atol
1e-6 (the same f32 formula; log-softmax,
norms and sums may round in another order); CTC's forward algorithm
adds 7 time steps of log-sum-exp in another order: rtol 1e-4, atol
1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.core.tensor import Tensor
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as F

from _torch_port_util import one_thread  # noqa: F401


def _softmax(x, axis=-1):
    e = np.exp(x - x.max(axis, keepdims=True))
    return e / e.sum(axis, keepdims=True)


def _f(r, *shape):
    return r.randn(*shape).astype(np.float32)


def _pm1(r, n):
    return np.where(r.rand(n) < 0.5, -1.0, 1.0).astype(np.float32)


def _ints(r, hi, *shape):
    return r.randint(0, hi, shape).astype(np.int64)


def r_w(n):
    return np.linspace(0.5, 1.5, n).astype(np.float32)


def _labels_with_ignore(r):
    y = _ints(r, 5, 6)
    y[2] = -100
    return y


# name -> (functional, inputs(r) -> [(array, differentiable)], kwargs)
CASES = {
    "cross_entropy": ("cross_entropy", lambda r: [
        (_f(r, 6, 5), True), (_labels_with_ignore(r), False)],
        dict(weight=np.linspace(0.5, 1.5, 5).astype(np.float32),
             label_smoothing=0.1)),
    "cross_entropy_soft": ("cross_entropy", lambda r: [
        (_f(r, 6, 5), True), (_softmax(_f(r, 6, 5)), True)],
        dict(soft_label=True, reduction="sum")),
    "softmax_with_cross_entropy": ("softmax_with_cross_entropy", lambda r: [
        (_f(r, 6, 5), True), (_ints(r, 5, 6, 1), False)],
        dict(return_softmax=True)),
    "nll_loss": ("nll_loss", lambda r: [
        (np.log(_softmax(_f(r, 6, 5))), True),
        (_labels_with_ignore(r), False)],
        dict(weight=np.linspace(0.5, 1.5, 5).astype(np.float32))),
    "nll_loss_sum": ("nll_loss", lambda r: [
        (np.log(_softmax(_f(r, 6, 5))), True),
        (_labels_with_ignore(r), False)], dict(reduction="sum")),
    "mse_loss": ("mse_loss", lambda r: [(_f(r, 6, 5), True),
                                        (_f(r, 6, 5), True)],
                 dict(reduction="sum")),
    "l1_loss": ("l1_loss", lambda r: [(_f(r, 6, 5), True),
                                      (_f(r, 6, 5), True)],
                dict(reduction="none")),
    "smooth_l1_loss": ("smooth_l1_loss", lambda r: [
        (_f(r, 6, 5), True), (_f(r, 6, 5), True)], dict(delta=0.5)),
    "binary_cross_entropy": ("binary_cross_entropy", lambda r: [
        (r.uniform(0.05, 0.95, (6, 5)).astype(np.float32), True),
        ((r.rand(6, 5) < 0.5).astype(np.float32), True)],
        dict(weight=r_w(5))),
    "binary_cross_entropy_with_logits": (
        "binary_cross_entropy_with_logits", lambda r: [
            (_f(r, 6, 5) * 3, True),
            ((r.rand(6, 5) < 0.5).astype(np.float32), True)],
        dict(pos_weight=r_w(5) * 2)),
    "kl_div": ("kl_div", lambda r: [
        (np.log(_softmax(_f(r, 6, 5))), True),
        (_softmax(_f(r, 6, 5)), True)], dict(reduction="batchmean")),
    "kl_div_log_target": ("kl_div", lambda r: [
        (np.log(_softmax(_f(r, 6, 5))), True),
        (np.log(_softmax(_f(r, 6, 5))), True)],
        dict(log_target=True, reduction="sum")),
    "margin_ranking_loss": ("margin_ranking_loss", lambda r: [
        (_f(r, 6), True), (_f(r, 6), True), (_pm1(r, 6), False)],
        dict(margin=0.3)),
    "cosine_embedding_loss": ("cosine_embedding_loss", lambda r: [
        (_f(r, 6, 5), True), (_f(r, 6, 5), True), (_pm1(r, 6), False)],
        dict(margin=0.2)),
    "hinge_embedding_loss": ("hinge_embedding_loss", lambda r: [
        (_f(r, 6), True), (_pm1(r, 6), False)], dict(margin=0.7)),
    "triplet_margin_loss": ("triplet_margin_loss", lambda r: [
        (_f(r, 6, 5), True), (_f(r, 6, 5), True), (_f(r, 6, 5), True)],
        dict(swap=True, p=3.0)),
    "triplet_margin_with_distance_loss": (
        "triplet_margin_with_distance_loss", lambda r: [
            (_f(r, 6, 5), True), (_f(r, 6, 5), True), (_f(r, 6, 5), True)],
        dict(margin=0.5)),
    "square_error_cost": ("square_error_cost", lambda r: [
        (_f(r, 6, 5), True), (_f(r, 6, 5), True)], {}),
    "sigmoid_focal_loss": ("sigmoid_focal_loss", lambda r: [
        (_f(r, 6, 5), True), ((r.rand(6, 5) < 0.3).astype(np.float32), True),
        (np.asarray([4.0], np.float32), False)], {}),
    "log_loss": ("log_loss", lambda r: [
        (r.uniform(0.05, 0.95, (6, 5)).astype(np.float32), True),
        ((r.rand(6, 5) < 0.5).astype(np.float32), True)], {}),
    "ctc_loss": ("ctc_loss", lambda r: [
        (_f(r, 8, 3, 5), True), (r.randint(1, 5, (3, 3)), False),
        (np.asarray([8, 7, 6]), False), (np.asarray([3, 2, 1]), False)],
        dict(blank=0)),
    "ctc_loss_sum": ("ctc_loss", lambda r: [
        (_f(r, 8, 3, 5), True), (r.randint(1, 5, (3, 3)), False),
        (np.asarray([8, 8, 5]), False), (np.asarray([3, 3, 2]), False)],
        dict(reduction="sum")),
    "margin_cross_entropy": ("margin_cross_entropy", lambda r: [
        (np.tanh(_f(r, 6, 5)), True), (_ints(r, 5, 6), False)],
        dict(return_softmax=True, scale=8.0)),
    "gaussian_nll_loss": ("gaussian_nll_loss", lambda r: [
        (_f(r, 6, 5), True), (_f(r, 6, 5), True),
        (r.uniform(0.1, 2.0, (6, 5)).astype(np.float32), True)],
        dict(full=True)),
    "poisson_nll_loss": ("poisson_nll_loss", lambda r: [
        (_f(r, 6, 5), True),
        (r.randint(0, 5, (6, 5)).astype(np.float32), False)],
        dict(full=True)),
    "poisson_nll_loss_linear": ("poisson_nll_loss", lambda r: [
        (r.uniform(0.2, 3.0, (6, 5)).astype(np.float32), True),
        (r.randint(0, 5, (6, 5)).astype(np.float32), False)],
        dict(log_input=False)),
    "soft_margin_loss": ("soft_margin_loss", lambda r: [
        (_f(r, 6, 5) * 4, True), (_pm1(r, 30).reshape(6, 5), False)], {}),
    "multi_label_soft_margin_loss": ("multi_label_soft_margin_loss",
                                     lambda r: [
        (_f(r, 6, 5), True), ((r.rand(6, 5) < 0.4).astype(np.float32), True)],
        dict(weight=np.linspace(0.5, 1.5, 5).astype(np.float32))),
    "multi_margin_loss": ("multi_margin_loss", lambda r: [
        (_f(r, 6, 5), True), (_ints(r, 5, 6), False)],
        dict(p=2, margin=0.8, weight=r_w(5))),
    "dice_loss": ("dice_loss", lambda r: [
        (_softmax(_f(r, 6, 5)), True), (_ints(r, 5, 6, 1), False)], {}),
    "npair_loss": ("npair_loss", lambda r: [
        (_f(r, 6, 5), True), (_f(r, 6, 5), True), (_ints(r, 3, 6), False)],
        dict(l2_reg=0.01)),
    "hsigmoid_loss": ("hsigmoid_loss", lambda r: [
        (_f(r, 6, 5), True), (_ints(r, 6, 6), False), (_f(r, 5, 5), True),
        (_f(r, 5), True)], dict(num_classes=6)),
}


def _tol(name):
    return (1e-4, 1e-5) if name.startswith("ctc") else (1e-5, 1e-6)


def _kw(kw, to):
    return {k: to(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}


def _jax_side(fn, inputs, kw):
    """JAX's values and ``jax.grad`` of the first output's sum, under one
    ``jax.jit`` (the functional traced once, not op by op)."""
    diff = [i for i, (_, d) in enumerate(inputs) if d]
    func = getattr(JF, fn)

    def f(*arrays):
        ts = [Tensor(a) for a in arrays]
        kws = _kw(kw, Tensor)
        if fn == "hsigmoid_loss":       # (input, label, num_classes, w, b)
            out = func(ts[0], ts[1], kws.pop("num_classes"), *ts[2:], **kws)
        else:
            out = func(*ts, **kws)
        outs = [o._data for o in (out if isinstance(out, tuple) else [out])]
        return outs[0].sum(), outs

    arrays = [jnp.asarray(a) for a, _ in inputs]
    (_, outs), grads = jax.jit(jax.value_and_grad(
        f, argnums=diff, has_aux=True))(*arrays)
    g = dict(zip(diff, grads))
    return ([np.asarray(o) for o in outs],
            [np.asarray(g[i]) if i in g else None
             for i in range(len(inputs))])


def _torch_side(fn, inputs, kw):
    ts = [torch.tensor(a, requires_grad=d) for a, d in inputs]
    kws = _kw(kw, torch.from_numpy)
    func = getattr(F, fn)
    if fn == "hsigmoid_loss":
        out = func(ts[0], ts[1], kws.pop("num_classes"), *ts[2:], **kws)
    else:
        out = func(*ts, **kws)
    outs = list(out) if isinstance(out, tuple) else [out]
    outs[0].sum().backward()
    return ([o.detach().numpy() for o in outs],
            [t.grad.numpy() if d else None for t, (_, d) in zip(ts, inputs)])


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_function_and_grads_match_jax(name):
    fn, make, kw = CASES[name]
    inputs = make(np.random.RandomState(sorted(CASES).index(name)))
    jv, jg = _jax_side(fn, inputs, kw)
    tv, tg = _torch_side(fn, inputs, kw)
    rtol, atol = _tol(name)
    assert len(jv) == len(tv)
    for a, b in zip(tv, jv):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
    for a, b in zip(tg, jg):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def test_custom_distance_function():
    r = np.random.RandomState(3)
    a, p, n = (_f(r, 5, 4) for _ in range(3))
    want = JF.triplet_margin_with_distance_loss(
        *(paddle.to_tensor(x) for x in (a, p, n)),
        distance_function=lambda u, v: (u - v).abs().sum(-1), swap=True)
    got = F.triplet_margin_with_distance_loss(
        *(torch.from_numpy(x) for x in (a, p, n)),
        distance_function=lambda u, v: (u - v).abs().sum(-1), swap=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


def _jax_layer(layer, arrays):
    """A JAX loss layer's output, traced under one ``jax.jit``."""
    return np.asarray(jax.jit(lambda *a: layer(*map(Tensor, a))._data)(
        *map(jnp.asarray, arrays)))


# layer -> (case of its functional's inputs, constructor kwargs)
LAYERS = {
    "CrossEntropyLoss": ("cross_entropy", dict(label_smoothing=0.1)),
    "MSELoss": ("mse_loss", dict(reduction="sum")),
    "L1Loss": ("l1_loss", {}),
    "NLLLoss": ("nll_loss", dict(reduction="sum")),
    "BCELoss": ("binary_cross_entropy", {}),
    "BCEWithLogitsLoss": ("binary_cross_entropy_with_logits",
                          dict(reduction="none")),
    "SmoothL1Loss": ("smooth_l1_loss", dict(delta=0.4)),
    "KLDivLoss": ("kl_div", dict(reduction="batchmean")),
    "MarginRankingLoss": ("margin_ranking_loss", dict(margin=0.1)),
    "CosineEmbeddingLoss": ("cosine_embedding_loss", dict(margin=0.1)),
    "HingeEmbeddingLoss": ("hinge_embedding_loss", {}),
    "TripletMarginLoss": ("triplet_margin_loss", dict(p=1.0)),
    "CTCLoss": ("ctc_loss", {}),
    "GaussianNLLLoss": ("gaussian_nll_loss", {}),
    "PoissonNLLLoss": ("poisson_nll_loss", {}),
    "SoftMarginLoss": ("soft_margin_loss", dict(reduction="sum")),
    "MultiLabelSoftMarginLoss": ("multi_label_soft_margin_loss", {}),
    "MultiMarginLoss": ("multi_margin_loss", dict(p=1, margin=0.5)),
    "TripletMarginWithDistanceLoss": ("triplet_margin_with_distance_loss",
                                      dict(swap=True)),
}


@pytest.mark.parametrize("layer", sorted(LAYERS) + ["HSigmoidLoss"])
def test_loss_layers_match_jax(layer):
    if layer == "HSigmoidLoss":
        r = np.random.RandomState(9)
        x, y = _f(r, 6, 5), _ints(r, 6, 6)
        jl = jnn.HSigmoidLoss(5, 6)
        tl = tnn.HSigmoidLoss(5, 6, device="cpu")
        assert tuple(tl.weight.shape) == tuple(jl.weight.shape) == (5, 5)
        with torch.no_grad():
            tl.weight.copy_(torch.tensor(np.asarray(jl.weight.numpy())))
            tl.bias.copy_(torch.tensor(np.asarray(jl.bias.numpy()) + 0.1))
        jl.bias.set_value(np.asarray(jl.bias.numpy()) + 0.1)
        want = _jax_layer(jl, [x, y])
        got = tl(torch.from_numpy(x), torch.from_numpy(y)).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        return
    case, kw = LAYERS[layer]
    inputs = CASES[case][1](np.random.RandomState(21))
    want = _jax_layer(getattr(jnn, layer)(**kw), [a for a, _ in inputs])
    got = getattr(tnn, layer)(**kw)(*(torch.from_numpy(np.asarray(a))
                                      for a, _ in inputs))
    rtol, atol = _tol(case)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)
