"""The port's optimizer pieces against the JAX package on the same
numpy-seeded arrays: AdamW (decoupled decay, ``apply_decay_param_fun``,
the ``multi_precision`` master weight), Adam (coupled L2),
``ClipGradByGlobalNorm``, and the ``LinearWarmup`` /
``CosineAnnealingDecay`` schedules, over 20 steps; every other
optimizer (SGD, Momentum, Adagrad, Adadelta, RMSProp, Adamax, Lamb,
Rprop, ASGD, NAdam, RAdam) over 3 steps, parameters and every
accumulator, with coupled L2 and the options that take other branches;
and ``convert.optimizer_state_from_jax``, which resumes a JAX AdamW run
in the port.

Tolerances.  The schedules are the same Python float arithmetic: equal.
The updates are the same f32 operations in the same order; XLA may fuse
a multiply-add where torch rounds twice, so each step may differ by an
f32 ulp, and over 20 steps parameters and moments agree to 1e-6 of
their scale.  A bf16 parameter is the cast of its f32 master weight on
both sides, so it may sit one bf16 step (2**-7 relative) away where the
masters straddle a rounding boundary.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Parameter, Tensor
from paddle_tpu_torch.convert import (
    optimizer_state_from_jax, state_dict_from_jax,
)
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import GPTForCausalLM as TGPTForCausalLM
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch import optimizer as topt_mod
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.optimizer import lr as tlr

from _torch_port_util import (  # noqa: F401
    TINY, jax_model, jax_state, one_thread, torch_config,
)

SHAPES = {"w_in": (6, 5), "norm.weight": (5,), "w_out": (5, 3)}
STEPS = 20


def _schedules():
    """(jax, port) LinearWarmup(4 steps) into a 16-step cosine."""
    j = paddle.optimizer.lr.LinearWarmup(
        paddle.optimizer.lr.CosineAnnealingDecay(3e-2, T_max=16), 4, 0.0,
        3e-2)
    t = tlr.LinearWarmup(tlr.CosineAnnealingDecay(3e-2, T_max=16), 4, 0.0,
                         3e-2)
    return j, t


def _params(dtype_name, seed=0):
    r = np.random.RandomState(seed)
    arrays = {n: r.randn(*s).astype(np.float32) for n, s in SHAPES.items()}
    jp = {n: Parameter(jnp.asarray(a).astype(getattr(jnp, dtype_name)),
                       name=n) for n, a in arrays.items()}
    tp = {n: torch.nn.Parameter(torch.from_numpy(a).to(
        getattr(torch, dtype_name))) for n, a in arrays.items()}
    return jp, tp


def _grads(step, scale):
    r = np.random.RandomState(1000 + step)
    return {n: (r.randn(*s) * scale).astype(np.float32)
            for n, s in SHAPES.items()}


def _run(make_jax, make_port, dtype_name, clip, grad_scale=1.0,
         steps=STEPS):
    jp, tp = _params(dtype_name)
    jsched, tsched = _schedules()
    jopt = make_jax(jsched, list(jp.values()),
                    paddle.nn.ClipGradByGlobalNorm(1.0) if clip else None)
    topt = make_port(tsched, list(tp.items()),
                     ClipGradByGlobalNorm(1.0) if clip else None)
    jdt, tdt = getattr(jnp, dtype_name), getattr(torch, dtype_name)
    for step in range(steps):
        for n, g in _grads(step, grad_scale).items():
            jp[n].grad = Tensor(jnp.asarray(g).astype(jdt))
            tp[n].grad = torch.from_numpy(g).to(tdt)
        jopt.step()
        topt.step()
        jopt.clear_grad()
        topt.clear_grad()
        jsched.step()
        tsched.step()
    return jp, tp, jopt, topt


def _close(got, want, rel=1e-6):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _check_state(jp, tp, jopt, topt, names):
    for n in names:
        jst = jopt._accumulators[id(jp[n])]
        tst = topt._accumulators[id(tp[n])]
        assert set(jst) == set(tst)
        for k in jst:
            _close(tst[k].numpy(), jst[k])


def _adamw(decay_fun):
    return (
        lambda s, ps, c: paddle.optimizer.AdamW(
            learning_rate=s, beta1=0.9, beta2=0.95, epsilon=1e-5,
            parameters=ps, weight_decay=0.1, grad_clip=c,
            apply_decay_param_fun=decay_fun, multi_precision=True),
        lambda s, ps, c: AdamW(
            learning_rate=s, beta1=0.9, beta2=0.95, epsilon=1e-5,
            parameters=ps, weight_decay=0.1, grad_clip=c,
            apply_decay_param_fun=decay_fun, multi_precision=True,
            device="cpu"))


def _half_lr_for_vectors(p):
    """An ``lr_ratio``: half the step for 1-D parameters (the norm)."""
    return 0.5 if p.ndim == 1 else 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_lr_ratio_matches_jax_over_20_steps(dtype):
    """AdamW's ``lr_ratio`` scales each parameter's learning rate, as in
    the JAX version (``optimizers.py`` ``AdamW._update_raw``)."""
    make_j, make_t = (
        lambda s, ps, c: paddle.optimizer.AdamW(
            learning_rate=s, parameters=ps, weight_decay=0.1, grad_clip=c,
            lr_ratio=_half_lr_for_vectors, multi_precision=True),
        lambda s, ps, c: AdamW(
            learning_rate=s, parameters=ps, weight_decay=0.1, grad_clip=c,
            lr_ratio=_half_lr_for_vectors, multi_precision=True,
            device="cpu"))
    jp, tp, jopt, topt = _run(make_j, make_t, dtype, True)
    for n in SHAPES:
        if dtype == "float32":
            _close(tp[n].detach().numpy(), jp[n].numpy())
        else:
            np.testing.assert_allclose(
                tp[n].detach().float().numpy(),
                np.asarray(jp[n].numpy(), np.float32), rtol=2 ** -7, atol=0)
    _check_state(jp, tp, jopt, topt, SHAPES)
    # the ratio moved the norm weight and left the matrices' steps alone
    _, base, _, _ = _run(*_adamw(None), dtype, True)
    assert not torch.equal(base["norm.weight"], tp["norm.weight"])


@pytest.mark.parametrize("clip", [True, False], ids=["clip", "noclip"])
def test_adamw_f32_matches_jax_over_20_steps(clip):
    no_norm = lambda name: "norm" not in name
    jp, tp, jopt, topt = _run(*_adamw(no_norm), "float32", clip)
    for n in SHAPES:
        _close(tp[n].detach().numpy(), jp[n].numpy())
    _check_state(jp, tp, jopt, topt, SHAPES)
    # apply_decay_param_fun exempts the norm weight: without decay it
    # lands elsewhere than with it
    _, tp_all, _, _ = _run(*_adamw(None), "float32", clip)
    assert not np.allclose(tp_all["norm.weight"].detach().numpy(),
                           tp["norm.weight"].detach().numpy(), atol=1e-6)
    _close(tp_all["w_in"].detach().numpy(), jp["w_in"].numpy())


def test_adamw_bf16_multi_precision_master_weight_matches_jax():
    jp, tp, jopt, topt = _run(*_adamw(None), "bfloat16", clip=True)
    for n in SHAPES:
        jst = jopt._accumulators[id(jp[n])]
        tst = topt._accumulators[id(tp[n])]
        assert tst["master_weight"].dtype == torch.float32
        _close(tst["master_weight"].numpy(), jst["master_weight"])
        got = tp[n].detach().float().numpy()
        np.testing.assert_allclose(
            got, np.asarray(jp[n].numpy(), np.float32), rtol=2.0 ** -7,
            atol=0)
        assert tp[n].dtype == torch.bfloat16
    _check_state(jp, tp, jopt, topt, SHAPES)


def _ndim1(p):
    """An ``exclude_from_weight_decay_fn``: exempt vectors (norms,
    biases)."""
    return len(p.shape) == 1


# name -> (class name, kwargs, dtype, gradient scale): each optimizer
# with coupled L2 where it takes one, and the options with other branches
OTHERS = {
    "sgd": ("SGD", dict(weight_decay=0.01), "float32", 1.0),
    "sgd_bf16": ("SGD", dict(), "bfloat16", 1.0),
    "momentum": ("Momentum", dict(momentum=0.9, weight_decay=0.01),
                 "float32", 1.0),
    "momentum_nesterov": ("Momentum", dict(momentum=0.8,
                                           use_nesterov=True),
                          "float32", 1.0),
    "adagrad": ("Adagrad", dict(epsilon=1e-6, weight_decay=0.01,
                                initial_accumulator_value=0.1),
                "float32", 1.0),
    "adadelta": ("Adadelta", dict(rho=0.9, weight_decay=0.01), "float32",
                 1.0),
    "adadelta_bf16_master": ("Adadelta", dict(multi_precision=True,
                                              weight_decay=0.01),
                             "bfloat16", 1.0),
    "rmsprop": ("RMSProp", dict(rho=0.9, momentum=0.5, weight_decay=0.01),
                "float32", 1.0),
    "rmsprop_centered": ("RMSProp", dict(centered=True), "float32", 1.0),
    "adamax": ("Adamax", dict(weight_decay=0.01), "float32", 1.0),
    "lamb": ("Lamb", dict(lamb_weight_decay=0.01), "float32", 1.0),
    "lamb_exclude": ("Lamb", dict(lamb_weight_decay=0.1,
                                  exclude_from_weight_decay_fn=_ndim1),
                     "float32", 1.0),
    "rprop": ("Rprop", dict(learning_rate_range=(1e-4, 0.5)), "float32",
              1.0),
    "asgd": ("ASGD", dict(batch_num=2, weight_decay=0.01), "float32", 1.0),
    "nadam": ("NAdam", dict(weight_decay=0.01), "float32", 1.0),
    "nadam_bf16_master": ("NAdam", dict(multi_precision=True), "bfloat16",
                          1.0),
    "radam": ("RAdam", dict(weight_decay=0.01), "float32", 1.0),
    "radam_bf16_master": ("RAdam", dict(multi_precision=True), "bfloat16",
                          1.0),
}


@pytest.mark.parametrize("case", list(OTHERS))
def test_other_optimizers_match_jax_over_3_steps(case):
    """Each update copies JAX's term for term: f32 parameters and
    accumulators agree to 1e-6 of their scale after 3 steps (an f32 ulp
    a step, as above); bf16 parameters to one bf16 step, their f32
    master weights (where JAX keeps one) to 1e-6.  The schedule is the
    warm-up into cosine of the other tests; Rprop's first step sizes are
    the learning rate at its first step (0 here, clipped up to the
    range's floor) on both sides."""
    name, kw, dtype, scale = OTHERS[case]
    jp, tp, jopt, topt = _run(
        lambda s, ps, c: getattr(paddle.optimizer, name)(
            learning_rate=s, parameters=ps, grad_clip=c, **kw),
        lambda s, ps, c: getattr(topt_mod, name)(
            learning_rate=s, parameters=ps, grad_clip=c, device="cpu",
            **kw),
        dtype, clip=True, grad_scale=scale, steps=3)
    for n in SHAPES:
        want = np.asarray(jp[n].numpy(), np.float32)
        got = tp[n].detach().float().numpy()
        assert tp[n].dtype == getattr(torch, dtype)
        if dtype == "float32":
            _close(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)
        jst = jopt._accumulators[id(jp[n])]
        tst = topt._accumulators[id(tp[n])]
        assert set(jst) == set(tst)
        for k in jst:
            assert tst[k].dtype == getattr(torch, str(jst[k].dtype))
            if tst[k].dtype == torch.float32:
                _close(tst[k].numpy(), jst[k])
    # every parameter moved (its master weight, where a bf16 step is too
    # small to show)
    start = _params(dtype)[1]
    for n in SHAPES:
        now = topt._accumulators[id(tp[n])].get("master_weight", tp[n])
        assert not torch.equal(now.detach().float(), start[n].float()), n


def test_adam_coupled_l2_matches_jax():
    jp, tp, jopt, topt = _run(
        lambda s, ps, c: paddle.optimizer.Adam(
            learning_rate=s, parameters=ps, weight_decay=0.01, grad_clip=c),
        lambda s, ps, c: Adam(learning_rate=s, parameters=ps,
                              weight_decay=0.01, grad_clip=c, device="cpu"),
        "float32", clip=False, grad_scale=0.1)
    for n in SHAPES:
        _close(tp[n].detach().numpy(), jp[n].numpy())
    _check_state(jp, tp, jopt, topt, SHAPES)


@pytest.mark.parametrize("scale", [0.01, 10.0], ids=["under", "over"])
def test_clip_by_global_norm_matches_jax(scale):
    grads = _grads(0, scale)
    jout = paddle.nn.ClipGradByGlobalNorm(1.0)(
        [(None, Tensor(jnp.asarray(g))) for g in grads.values()])
    clip = ClipGradByGlobalNorm(1.0)
    tout = clip([(None, torch.from_numpy(g)) for g in grads.values()])
    for (_, jg), (_, tg) in zip(jout, tout):
        _close(tg.numpy(), jg.numpy())
    norm = clip.global_norm([torch.from_numpy(g) for g in grads.values()])
    total = np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                        for g in grads.values()))
    np.testing.assert_allclose(norm.item(), total, rtol=1e-6)
    if scale < 1:
        for (_, tg), g in zip(tout, grads.values()):
            np.testing.assert_array_equal(tg.numpy(), g)


def test_schedules_match_jax_values():
    jsched, tsched = _schedules()
    for _ in range(STEPS + 5):
        assert tsched.get_lr() == jsched.get_lr()
        assert tsched() == jsched()
        jsched.step()
        tsched.step()
    jc = paddle.optimizer.lr.CosineAnnealingDecay(1e-3, T_max=7, eta_min=1e-5)
    tc = tlr.CosineAnnealingDecay(1e-3, T_max=7, eta_min=1e-5)
    jw = paddle.optimizer.lr.LinearWarmup(5e-4, 3, 1e-5, 5e-4)
    tw = tlr.LinearWarmup(5e-4, 3, 1e-5, 5e-4)
    for _ in range(10):
        assert (tc(), tw()) == (jc(), jw())
        for s in (jc, tc, jw, tw):
            s.step()
    assert tw.state_dict()["last_epoch"] == 10


def _named_grads(cfg, seed, dtype_jax, dtype_torch, js):
    """Random grads in paddle layout (jax) and torch layout (port)."""
    r = np.random.RandomState(seed)
    jg, tg = {}, {}
    for key, a in js.items():
        g = (r.randn(*a.shape) * 0.05).astype(np.float32)
        jg[key] = Tensor(jnp.asarray(g).astype(dtype_jax))
        is_linear = key == "lm_head.weight" or key.rsplit(".", 2)[-2] in (
            "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
            "down_proj")
        tg[key] = torch.from_numpy(g.T.copy() if is_linear else g).to(
            dtype_torch)
    return jg, tg


def test_optimizer_state_from_jax_resumes_a_jax_run():
    """Two JAX AdamW steps on the TINY model's bf16 weights, then the
    weights and the accumulators (moments, beta pows, master weights)
    carried into the port; three more steps on each side agree."""
    jm = jax_model(TINY, seed=5)
    jm.to(dtype="bfloat16")
    sd = jm.state_dict()
    kw = dict(beta1=0.9, beta2=0.95, epsilon=1e-5, weight_decay=0.1,
              multi_precision=True)
    jopt = paddle.optimizer.AdamW(learning_rate=1e-2,
                                  parameters=list(sd.values()), **kw)
    js = jax_state(jm)
    for step in range(5):
        if step == 2:       # hand over: weights and optimizer state
            f32 = {k: np.asarray(v, np.float32) for k, v in
                   jax_state(jm).items()}
            tm = TGPTForCausalLM(torch_config(TINY), device="cpu",
                                 dtype=torch.bfloat16)
            tm.load_state_dict(state_dict_from_jax(
                f32, torch_config(TINY), device="cpu", dtype=torch.bfloat16))
            acc = {f"{k}.{name}": np.asarray(v)
                   for k, p in sd.items()
                   for name, v in jopt._accumulators[id(p)].items()}
            acc["global_step"] = jopt._step_count
            state = optimizer_state_from_jax(acc, torch_config(TINY),
                                             device="cpu")
            topt = AdamW(learning_rate=1e-2,
                         parameters=list(tm.named_parameters()),
                         device="cpu", **kw)
            topt.set_state_dict(state)
            assert topt._step_count == 2
            tparams = dict(tm.named_parameters())
        jg, tg = _named_grads(TINY, 50 + step, jnp.bfloat16, torch.bfloat16,
                              js)
        for k, p in sd.items():
            p.grad = jg[k]
        jopt.step()
        jopt.clear_grad()
        if step >= 2:
            for k, p in tparams.items():
                p.grad = tg[k]
            topt.step()
            topt.clear_grad()
    for k, p in sd.items():
        jm_master = np.asarray(jopt._accumulators[id(p)]["master_weight"])
        t_master = topt._accumulators[id(tparams[k])]["master_weight"]
        t_m1 = topt._accumulators[id(tparams[k])]["moment1"].numpy()
        j_m1 = np.asarray(jopt._accumulators[id(p)]["moment1"])
        if t_master.dim() == 2 and k != "model.embed_tokens.weight":
            t_master, t_m1 = t_master.t(), t_m1.T
        _close(t_master.numpy(), jm_master)
        _close(t_m1, j_m1)


def test_optimizer_state_from_jax_refuses_bad_keys_and_shapes():
    cfg = torch_config(TINY)
    with pytest.raises(KeyError, match="names no parameter"):
        optimizer_state_from_jax({"model.nope.weight.moment1": np.zeros(3)},
                                 cfg, device="cpu")
    with pytest.raises(KeyError, match="names no parameter"):
        optimizer_state_from_jax({"model.norm.weight.velocity": np.zeros(64)},
                                 cfg, device="cpu")
    with pytest.raises(ValueError, match="lm_head.weight.moment2"):
        optimizer_state_from_jax({"lm_head.weight.moment2": np.zeros((3, 4))},
                                 cfg, device="cpu")
    p = torch.nn.Parameter(torch.zeros(3))
    opt = AdamW(parameters=[("w", p)], device="cpu")
    with pytest.raises(KeyError, match="no accumulator"):
        opt.set_state_dict({"v.moment1": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        opt.set_state_dict({"w.moment1": torch.zeros(4)})
    opt.set_state_dict(opt.state_dict())


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = torch.nn.Parameter(torch.zeros(3))
    with pytest.raises(RuntimeError, match="CUDA"):
        AdamW(parameters=[p])
    opt = AdamW(parameters=[p], device="cpu")
    model = torch.nn.Linear(2, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainStep(model, lambda m, x: m(x).sum(), opt)
    with pytest.raises(ValueError, match="lives on"):
        AdamW(parameters=[torch.nn.Parameter(torch.zeros(3, device="meta"))],
              device="cpu")
