"""The port's device-memory ledger (``paddle_tpu_torch.observability.
memory``) through the JAX package's ``TestMemoryLedger`` cases, and the
engine's ledger: its components against the JAX engine's bytes for the
same configuration, the host arena reported beside the reconciliation,
and the leak detector over a steady state."""

import gc
import json
import weakref

import numpy as np
import pytest

from paddle_tpu.serving import Engine as JEngine
from paddle_tpu.serving import EngineConfig as JEngineConfig
from paddle_tpu.serving import SamplingParams as JSamplingParams
from paddle_tpu_torch.observability import memory as mem
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

from _torch_port_util import (  # noqa: F401
    CONFIGS, TINY, jax_model, one_thread, port_model,
)


def test_account_and_raising_component():
    led = mem.MemoryLedger("t")
    led.register("a", lambda: 100).register("b", lambda: 28)

    def boom():
        raise RuntimeError("accounting down")

    led.register("bad", boom)
    assert led.account() == {"a": 100, "b": 28, "bad": 0}
    led.unregister("bad")
    assert sorted(led.components()) == ["a", "b"]
    with pytest.raises(TypeError):
        led.register("notfn", 42)
    with pytest.raises(TypeError):
        led.register_host("notfn", 42)


def test_snapshot_reconciles_and_publishes():
    led = mem.MemoryLedger("snap-test")
    led.register("kv", lambda: 64)
    led.register_host("arena", lambda: 4096)
    snap = led.snapshot()
    assert snap["accounted_total_bytes"] == 64
    assert snap["live_bytes"] == 0          # the CPU: no live count
    assert snap["unaccounted_bytes"] == snap["live_bytes"] - 64
    assert snap["leak_delta_bytes"] == 0    # the first snapshot anchors
    assert snap["host_components"] == {"arena": 4096}
    assert snap["host_total_bytes"] == 4096
    assert metrics.value("memory.accounted_bytes", ledger="snap-test",
                         component="kv") == 64
    assert metrics.value("memory.accounted_total_bytes",
                         ledger="snap-test") == 64
    assert metrics.value("memory.host_arena_bytes", ledger="snap-test",
                         component="arena") == 4096
    text = metrics.render_prometheus()
    assert metrics.validate_exposition(text) > 0
    for name in ("memory_accounted_bytes", "memory_live_bytes",
                 "memory_unaccounted_bytes", "memory_leak_delta_bytes",
                 "memory_host_arena_bytes"):
        assert name in text
    json.dumps(metrics.snapshot())


def test_leak_delta_tracks_unaccounted_growth(monkeypatch):
    led = mem.MemoryLedger("leak-test")
    led.register("pool", lambda: 1000)
    live = {"v": 1500}
    monkeypatch.setattr(mem, "live_device_bytes",
                        lambda device=None: live["v"])
    assert led.snapshot()["leak_delta_bytes"] == 0
    # pool growth alone is not a leak: accounted grows with live
    led.unregister("pool")
    led.register("pool", lambda: 1400)
    live["v"] = 1900
    assert led.snapshot()["leak_delta_bytes"] == 0
    # unaccounted residue growth is
    live["v"] = 2100
    assert led.snapshot()["leak_delta_bytes"] == 200
    led.mark_baseline()
    assert led.snapshot()["leak_delta_bytes"] == 0


def test_bandwidth_probe_memoized():
    a = mem.host_device_bandwidth_gbs("cpu")
    b = mem.host_device_bandwidth_gbs("cpu")
    assert a == b and a > 0
    assert mem.live_device_bytes("cpu") == 0 == mem.live_device_bytes()


def _kw(**kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_seq_len", 32)
    kw.setdefault("prefix_block_size", 4)
    return kw


@CONFIGS
def test_memory_ledger_reconciles_in_stats(cfg, monkeypatch):
    """The engine registers kv_pool, weights and engine_state (the
    first two equal to the JAX engine's bytes), the host arena as a host
    component, and over a steady state the unaccounted residue does not
    grow."""
    jm = jax_model(cfg, seed=0)
    jeng = JEngine(jm, JEngineConfig(program_cards=False, **_kw()),
                   register_profiler=False)
    jeng.submit([1, 2, 3], JSamplingParams(max_new_tokens=4))
    jeng.run()
    jmem = jeng.stats()["memory"]
    eng = Engine(port_model(cfg, jm), EngineConfig(**_kw()), device="cpu",
                 register_profiler=False)
    # the CPU keeps no live-tensor count: stand one in that covers the
    # accounted bytes plus a fixed residue
    monkeypatch.setattr(mem, "live_device_bytes", lambda device=None: (
        sum(eng.ledger.account().values()) + 4096))
    eng.submit([1, 2, 3], SamplingParams(max_new_tokens=4))
    eng.run()
    got = eng.stats()["memory"]
    assert set(got["components"]) == {"kv_pool", "weights", "engine_state"}
    assert all(v > 0 for v in got["components"].values())
    assert got["accounted_total_bytes"] == sum(got["components"].values())
    for comp in ("kv_pool", "weights"):
        assert got["components"][comp] == jmem["components"][comp], comp
    assert got["unaccounted_bytes"] == 4096
    assert "host_components" not in got
    eng.submit([4, 5, 6], SamplingParams(max_new_tokens=4))
    eng.run()
    assert eng.stats()["memory"]["leak_delta_bytes"] == 0
    eng.close()
    jeng.close()
    tier = Engine(port_model(cfg, jm), EngineConfig(
        kv_host_bytes=1 << 16, **_kw()), device="cpu",
        register_profiler=False)
    snap = tier.stats()["memory"]
    assert snap["host_components"] == {
        "kv_host_arena": tier.host_tier.nbytes}
    assert tier.host_tier.nbytes == (
        tier.host_tier.capacity * tier.pool.bytes_per_block)
    assert snap["accounted_total_bytes"] == sum(
        snap["components"].values())
    tier.close()


def test_engine_state_counts_grammar_tables():
    """With structured generation on, the slab's device tables are part
    of engine_state once uploaded."""
    m = port_model(TINY, jax_model(TINY))
    vocab = [chr(32 + i) for i in range(95)] + ["<eos>"]
    eng = Engine(m, EngineConfig(grammar_max_states=16, grammar_vocab=vocab,
                                 **_kw()), device="cpu",
                 register_profiler=False)
    eng.submit([1, 2], SamplingParams(max_new_tokens=4, eos_token_id=95),
               grammar="[0-9]+")
    eng.run()
    slab = eng._grammar_slab
    state = eng.stats()["memory"]["components"]["engine_state"]
    assert state >= slab.device_bytes
    assert np.array_equal(eng._d_dfa[1].numpy().view(np.uint32), slab.mask)
    eng.close()


def test_engine_is_freed_without_the_cycle_collector():
    """The ledger's components and the prefix store's spill hooks reach
    the engine through weak references: dropping the last reference
    frees the engine (and its pool) at once, with the cycle collector
    off, as an engine with neither."""
    m = port_model(TINY, jax_model(TINY))
    vocab = [chr(32 + i) for i in range(95)] + ["<eos>"]
    for kw in ({}, dict(kv_host_bytes=1 << 16, grammar_max_states=16,
                        grammar_vocab=vocab)):
        eng = Engine(m, EngineConfig(**_kw(**kw)), device="cpu",
                     register_profiler=False)
        eng.submit([1, 2], SamplingParams(max_new_tokens=2))
        eng.run()
        eng.stats()
        ref = weakref.ref(eng)
        gc.disable()
        try:
            del eng
            assert ref() is None, kw
        finally:
            gc.enable()
