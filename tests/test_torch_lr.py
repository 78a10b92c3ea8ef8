"""Every learning-rate scheduler of the port against the JAX package's
(``paddle_tpu/optimizer/lr.py``): the same Python float arithmetic, so
``last_lr`` and ``get_lr()`` are exactly equal at every step, over
settings that take each branch (PolynomialDecay with and without
``cycle``, the three CyclicLR modes and ``scale_fn``, OneCycleLR's
annealings, ReduceOnPlateau on a metric with patience and cooldown,
BERT's LinearWarmup into PolynomialDecay), and ``state_dict`` carries a
run over."""

import math

import pytest

import paddle_tpu as paddle
from paddle_tpu_torch.optimizer import lr as tlr

jlr = paddle.optimizer.lr
STEPS = 40

# name -> (class name, args, kwargs)
CASES = {
    "noam": ("NoamDecay", (512, 8), dict(learning_rate=2.0)),
    "piecewise": ("PiecewiseDecay", ([5, 12, 30], [1.0, 0.5, 0.1, 0.01]),
                  {}),
    "natural_exp": ("NaturalExpDecay", (0.5, 0.1), {}),
    "inverse_time": ("InverseTimeDecay", (0.5, 0.3), {}),
    "polynomial": ("PolynomialDecay", (0.1, 17), dict(end_lr=1e-4,
                                                      power=2.0)),
    "polynomial_cycle": ("PolynomialDecay", (0.1, 7), dict(
        end_lr=0.0, power=1.0, cycle=True)),
    "exponential": ("ExponentialDecay", (0.5, 0.93), {}),
    "multistep": ("MultiStepDecay", (0.5, [4, 9, 25]), dict(gamma=0.3)),
    "step": ("StepDecay", (0.5, 6), dict(gamma=0.5)),
    "lambda": ("LambdaDecay", (0.5, lambda e: 0.95 ** e), {}),
    "multiplicative": ("MultiplicativeDecay", (0.5, lambda e: 0.9), {}),
    "cosine_restarts": ("CosineAnnealingWarmRestarts", (0.1, 5),
                        dict(T_mult=2, eta_min=1e-3)),
    "cyclic": ("CyclicLR", (1e-3, 1e-2), dict(step_size_up=4,
                                              step_size_down=6)),
    "cyclic2": ("CyclicLR", (1e-3, 1e-2), dict(step_size_up=5,
                                               mode="triangular2")),
    "cyclic_exp": ("CyclicLR", (1e-3, 1e-2), dict(
        step_size_up=3, mode="exp_range", exp_gamma=0.9)),
    "cyclic_scale_fn": ("CyclicLR", (1e-3, 1e-2), dict(
        step_size_up=3, scale_fn=lambda c: 0.9 ** c, scale_mode="iterations")),
    "onecycle": ("OneCycleLR", (0.1, 30), {}),
    "onecycle_linear": ("OneCycleLR", (0.1, 25), dict(
        anneal_strategy="linear", phase_pct=0.2, divide_factor=10.0)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_scheduler_sequence_equals_jax(case):
    name, args, kw = CASES[case]
    j = getattr(jlr, name)(*args, **kw)
    t = getattr(tlr, name)(*args, **kw)
    seq = []
    for _ in range(STEPS):
        assert t.last_lr == j.last_lr and t.get_lr() == j.get_lr()
        assert t() == j()
        seq.append(t.last_lr)
        j.step()
        t.step()
    assert len(set(seq)) > 1 and all(math.isfinite(x) for x in seq)


@pytest.mark.parametrize("mode", ["min", "max"])
@pytest.mark.parametrize("threshold_mode", ["rel", "abs"])
def test_reduce_on_plateau_equals_jax(mode, threshold_mode):
    kw = dict(mode=mode, factor=0.5, patience=2, threshold=0.01,
              threshold_mode=threshold_mode, cooldown=1, min_lr=1e-3)
    j = jlr.ReduceOnPlateau(0.1, **kw)
    t = tlr.ReduceOnPlateau(0.1, **kw)
    metrics = [1.0, 0.9, 0.95, 0.95, 0.96, 0.97, 0.5] + [0.6] * 38
    seen = set()
    for i, m in enumerate(metrics):
        if i == 5:
            j.step()                      # a step without a metric
            t.step()
        m = m if mode == "min" else -m
        j.step(m)
        t.step(m)
        assert (t.last_lr, t.last_epoch, t.num_bad_epochs,
                t.cooldown_counter, t.best) == \
            (j.last_lr, j.last_epoch, j.num_bad_epochs,
             j.cooldown_counter, j.best)
        seen.add(t.last_lr)
    assert min(seen) == 1e-3 and len(seen) > 2


def test_bert_recipe_and_state_dict():
    """LinearWarmup(PolynomialDecay(power=1)) to 0, and a run resumed
    from ``state_dict`` continues the same sequence."""
    def make(mod):
        return mod.LinearWarmup(mod.PolynomialDecay(1e-4, 10, end_lr=0.0,
                                                    power=1.0), 3, 0.0, 1e-4)

    j, t = make(jlr), make(tlr)
    for _ in range(16):
        assert t.last_lr == j.last_lr
        j.step()
        t.step()
    assert t.last_lr == 0.0
    a = tlr.PolynomialDecay(0.1, 17, end_lr=1e-4, power=2.0)
    for _ in range(5):
        a.step()
    b = tlr.PolynomialDecay(0.1, 17, end_lr=1e-4, power=2.0)
    b.set_state_dict(a.state_dict())
    for _ in range(5):
        a.step()
        b.step()
        assert a.last_lr == b.last_lr
