"""The port's fault-injection layer (``paddle_tpu_torch.serving.faults``)
against the JAX package's on the CPU: the same seeds give the same chaos
schedules, the same fired-fault records and the same retry delays, and
an injected dry pool defers admission in both engines with the streams
unchanged (exact: every compared quantity is a host decision or a token
id)."""

import pytest

from paddle_tpu.serving import Engine as JEngine
from paddle_tpu.serving import EngineConfig as JEngineConfig
from paddle_tpu.serving import SamplingParams as JSamplingParams
from paddle_tpu.serving import faults as jfaults
from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams
from paddle_tpu_torch.serving import engine as port_engine
from paddle_tpu_torch.serving import faults
from paddle_tpu_torch.serving.faults import (
    FAULT_CRASH, FAULT_EXCEPTION, FAULT_POOL_EXHAUSTED, FAULT_STALL,
    FAULT_SUBMIT_FAIL, SITE_ENGINE_ADMIT, SITE_WORKER_DISPATCH,
    SITE_WORKER_SUBMIT, DispatchFault, FaultInjector, FaultPlan, FaultSpec,
    RetryPolicy, TransientSubmitError, WorkerCrash,
)

from _torch_port_util import (  # noqa: F401
    TINY, jax_model, one_thread, port_model,
)

SITES = (SITE_WORKER_DISPATCH, SITE_WORKER_SUBMIT, SITE_ENGINE_ADMIT)


def test_constants_are_the_jax_modules():
    for name in ("FAULT_CRASH", "FAULT_EXCEPTION", "FAULT_STALL",
                 "FAULT_SUBMIT_FAIL", "FAULT_POOL_EXHAUSTED",
                 "SITE_WORKER_DISPATCH", "SITE_WORKER_SUBMIT",
                 "SITE_ENGINE_ADMIT", "SITE_KINDS", "DEGRADE_LEVELS"):
        assert getattr(faults, name) == getattr(jfaults, name), name
    # the engine keeps re-exporting the ladder's level names
    assert port_engine.DEGRADE_LEVELS is faults.DEGRADE_LEVELS


def _specs(plan):
    return [(s.site, s.kind, s.at, s.scope, s.times) for s in plan.specs]


@pytest.mark.parametrize("seed", [0, 7, 42, 1234])
def test_chaos_schedule_is_the_jax_schedule(seed):
    scopes = ("r0", "r1", "r2")
    plan = FaultPlan.chaos(seed, scopes, n_faults=8, max_ordinal=16)
    jplan = jfaults.FaultPlan.chaos(seed, scopes, n_faults=8,
                                    max_ordinal=16)
    assert _specs(plan) == _specs(jplan)
    assert plan.to_json() == jplan.to_json()
    fatal = [s.scope for s in plan.specs
             if s.kind in (FAULT_CRASH, FAULT_STALL)]
    assert len(fatal) == len(set(fatal))     # one fatal fault a scope


def _fire_all(mod, plan):
    """Visit every (scope, site) 20 times; returns the injector's fired
    record and what each visit did (the exception's class name, the
    returned spec's kind, or None)."""
    inj = mod.FaultInjector(plan)
    seen = []
    for _ in range(20):
        for scope in ("r0", "r1", "r2"):
            for site in SITES:
                try:
                    spec = inj.fire(site, scope=scope)
                    seen.append(None if spec is None else spec.kind)
                except Exception as e:       # the raise-style kinds
                    seen.append(type(e).__name__)
    return list(inj.fired), seen, inj.counts()


@pytest.mark.parametrize("seed", [3, 11, 99])
def test_injector_fires_as_the_jax_injector(seed):
    scopes = ("r0", "r1", "r2")
    plan = FaultPlan.chaos(seed, scopes, n_faults=10, max_ordinal=20)
    jplan = jfaults.FaultPlan.chaos(seed, scopes, n_faults=10,
                                    max_ordinal=20)
    assert _fire_all(faults, plan) == _fire_all(jfaults, jplan)


def test_injector_kinds_scopes_and_windows():
    inj = FaultInjector(FaultPlan([
        FaultSpec(SITE_WORKER_DISPATCH, FAULT_EXCEPTION, at=1, scope="a",
                  times=2),
        FaultSpec(SITE_WORKER_DISPATCH, FAULT_STALL, at=3, scope="a"),
        FaultSpec(SITE_WORKER_DISPATCH, FAULT_CRASH, at=0, scope="b"),
        FaultSpec(SITE_WORKER_SUBMIT, FAULT_SUBMIT_FAIL, at=0),
        FaultSpec(SITE_ENGINE_ADMIT, FAULT_POOL_EXHAUSTED, at=0)]))
    assert inj.fire(SITE_WORKER_DISPATCH, scope="a") is None
    for _ in range(2):
        with pytest.raises(DispatchFault):
            inj.fire(SITE_WORKER_DISPATCH, scope="a")
    assert inj.fire(SITE_WORKER_DISPATCH, scope="a").kind == FAULT_STALL
    with pytest.raises(WorkerCrash):
        inj.fire(SITE_WORKER_DISPATCH, scope="b")
    with pytest.raises(TransientSubmitError):
        inj.fire(SITE_WORKER_SUBMIT, scope="anyone")
    assert inj.fire(SITE_ENGINE_ADMIT).kind == FAULT_POOL_EXHAUSTED
    assert inj.counts() == {FAULT_EXCEPTION: 2, FAULT_STALL: 1,
                            FAULT_CRASH: 1, FAULT_SUBMIT_FAIL: 1,
                            FAULT_POOL_EXHAUSTED: 1}
    for bad in (dict(site="no.such", kind=FAULT_CRASH, at=0),
                dict(site=SITE_WORKER_SUBMIT, kind=FAULT_CRASH, at=0),
                dict(site=SITE_WORKER_DISPATCH, kind=FAULT_CRASH, at=-1),
                dict(site=SITE_WORKER_DISPATCH, kind=FAULT_CRASH, at=0,
                     times=0)):
        with pytest.raises(ValueError):
            FaultSpec(**bad)


@pytest.mark.parametrize("kw", [
    {}, dict(seed=5), dict(backoff_base_s=0.01, backoff_cap_s=0.2, seed=9),
    dict(max_retries=5, backoff_base_s=0.3, backoff_cap_s=2.0, seed=77)])
def test_retry_jitter_is_the_jax_jitter(kw):
    p, jp = RetryPolicy(**kw), jfaults.RetryPolicy(**kw)
    for ordinal in range(12):
        for attempt in range(6):
            d = p.delay(ordinal, attempt)
            assert d == jp.delay(ordinal, attempt)
            cap = min(p.backoff_cap_s, p.backoff_base_s * 2 ** attempt)
            assert 0.5 * cap <= d < cap


# -------------------------------------------------- the engine.admit site
PROMPTS = [[5, 17, 3, 99, 41, 8, 23, 60], [7, 7, 1], [88, 2, 45, 9, 10]]


def _run_with_fault(eng, sp_cls, plan_mod, at):
    eng.install_faults(plan_mod.FaultInjector(plan_mod.FaultPlan([
        plan_mod.FaultSpec(plan_mod.SITE_ENGINE_ADMIT,
                           plan_mod.FAULT_POOL_EXHAUSTED, at=at)])),
        scope="e0")
    reqs = [eng.submit(p, sp_cls(max_new_tokens=10 + i)) if i != 2 else
            eng.submit(p, sp_cls(max_new_tokens=8, temperature=0.9,
                                 top_k=20, seed=3))
            for i, p in enumerate(PROMPTS)]
    deferred = []
    while eng.scheduler.has_work:
        eng.step()
        deferred.append(eng._admit_deferred)
    return [[int(t) for t in r.output_ids] for r in reqs], deferred


@pytest.mark.parametrize("at", [0, 1])
def test_pool_exhausted_defers_admission_bitwise(at):
    """A ``pool_exhausted`` fault at admission pass ``at`` defers that
    whole pass in both engines, the step after admits, and the streams
    equal the unfaulted run's (the greedy ones the JAX engine's too)."""
    kw = dict(num_slots=2, max_seq_len=64, max_horizon=4)
    jm = jax_model(TINY, seed=4)
    ref = Engine(port_model(TINY, jm), EngineConfig(**kw), device="cpu")
    want = [[int(t) for t in ref.generate(
        p, SamplingParams(max_new_tokens=10 + i) if i != 2 else
        SamplingParams(max_new_tokens=8, temperature=0.9, top_k=20,
                       seed=3))] for i, p in enumerate(PROMPTS)]
    eng = Engine(port_model(TINY, jm), EngineConfig(**kw), device="cpu",
                 register_profiler=False)
    jeng = JEngine(jm, JEngineConfig(**kw), register_profiler=False)
    got, deferred = _run_with_fault(eng, SamplingParams, faults, at)
    jgot, jdeferred = _run_with_fault(jeng, JSamplingParams, jfaults, at)
    assert got == want
    assert got[:2] == jgot[:2]               # greedy: the JAX streams
    assert deferred == jdeferred
    assert deferred.count(True) == 1
    assert eng.pool.blocks_in_use == jeng.pool.blocks_in_use == 0
    c, jc = eng.counters(), jeng.counters()
    for k in ("prefill_calls", "decode_steps", "tokens_generated"):
        assert c[k] == jc[k], k
    eng.close()
    jeng.close()
