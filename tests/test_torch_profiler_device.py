"""The port's ``profiler``, ``device`` and ``amp.debugging`` against the
JAX package's on the CPU.

* ``make_scheduler`` state for state against JAX's over 24 steps, for
  several (closed, ready, record, repeat, skip_first) and the
  ``(start, end)`` tuple form (``tests/test_observability.py:316-345``
  is the oracle); a ``Profiler`` over four CPU steps with
  ``RecordEvent`` spans and ``scheduler=(1, 3)``: its chrome trace holds
  the spans of steps 1 and 2 alone, ``on_trace_ready`` runs once,
  ``summary`` and ``step_info`` read as JAX's; ``timer_only``,
  ``export_chrome_tracing``, ``profiler_guard`` and the counter facade.
* ``device``: the availability queries, ``cuda`` (counts and bytes 0
  without a card, as JAX's stub), ``tpu``, and ``Stream``/``Event`` with
  JAX's method set, waits that do nothing on the CPU, and the default
  device's rule (the card, which raises without one).
* ``amp.debugging``: ``check_numerics`` counts as JAX's (``[1]`` int32
  tensors) and raises alike; the tensor checker raises naming the
  operator that made a NaN inside a layer's forward, warns under
  ``CHECK_NAN_INF``, and ``set_flags`` turns it on and off.
"""

import json
import re

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp.debugging as jdebug
import paddle_tpu.device as jdevice
import paddle_tpu.profiler as jprof

import paddle_tpu_torch as pt
import paddle_tpu_torch.amp.debugging as tdebug
import paddle_tpu_torch.profiler as tprof
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.observability import metrics as tmetrics

from _torch_port_util import one_thread  # noqa: F401


@pytest.fixture(autouse=True)
def own_device_flags_and_checker(monkeypatch):
    """Each test starts with no device chosen and no checker on, and
    leaves them so."""
    monkeypatch.setattr(tdevice, "_CURRENT", [None])
    saved = dict(tflags._FLAGS)
    yield
    tdebug.disable_tensor_checker()
    tflags._FLAGS.clear()
    tflags._FLAGS.update(saved)


# ---------------- profiler ----------------

@pytest.mark.parametrize("kw", [
    dict(), dict(closed=1, ready=1, record=2), dict(record=3, repeat=2),
    dict(closed=2, record=1, repeat=1, skip_first=3),
    dict(ready=2, record=2, skip_first=1)])
def test_make_scheduler_matches_jax_state_for_state(kw):
    js, ts = jprof.make_scheduler(**kw), tprof.make_scheduler(**kw)
    assert [ts(i).name for i in range(24)] == [js(i).name for i in range(24)]


def test_tuple_scheduler_records_once_as_jax():
    jp = jprof.Profiler(scheduler=(2, 5), timer_only=True)
    tp = tprof.Profiler(scheduler=(2, 5), timer_only=True)
    assert [tp._scheduler(i).name for i in range(12)] == \
        [jp._scheduler(i).name for i in range(12)]
    # torch's actions: the step before the window warms the tracer up
    assert [tp._action(i).name for i in range(7)] == [
        "NONE", "WARMUP", "RECORD", "RECORD", "RECORD_AND_SAVE", "NONE",
        "NONE"]
    assert [s.name for s in tprof.ProfilerState] == \
        [s.name for s in jprof.ProfilerState]
    assert [s.name for s in tprof.ProfilerTarget] == \
        [s.name for s in jprof.ProfilerTarget]


def test_profiler_traces_the_scheduled_steps(tmp_path):
    ready = []
    prof = tprof.Profiler(
        targets=[tprof.ProfilerTarget.CPU], scheduler=(1, 3),
        on_trace_ready=lambda p: ready.append(
            p.export(str(tmp_path / "trace.json"))))
    a = torch.randn(32, 32)
    with prof:
        for i in range(4):
            with tprof.RecordEvent(f"train_step_{i}"):
                (a @ a).sum()
            prof.step(num_samples=8)
    assert ready == [str(tmp_path / "trace.json")]
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = sorted({e["name"] for e in events
                    if str(e.get("name", "")).startswith("train_step_")})
    assert spans == ["train_step_1", "train_step_2"]
    assert re.fullmatch(r"batch_cost: \d+\.\d{5} s, ips: \d+\.\d{3} "
                        r"samples/s", prof.step_info("samples"))
    assert prof.summary().startswith("steps: 4  avg: ")


def test_summary_and_step_info_read_as_jax():
    tmetrics.histogram("test.torch_profiler_summary").observe(0.25)
    for mod in (jprof, tprof):
        p = mod.Profiler(timer_only=True)
        assert p.summary() == "no steps recorded" and p.step_info() == ""
        p.start()
        p.step()
        text = p.summary()
        assert re.match(r"steps: 1  avg: [\d.]+ ms  p50: [\d.]+ ms  "
                        r"p99: [\d.]+ ms", text)
        assert re.fullmatch(r"batch_cost: \d+\.\d{5} s, ips: \d+\.\d{3} "
                            r"steps/s", p.step_info())
        p.stop()
    assert "test.torch_profiler_summary: n=1 mean=0.250000" in text


def test_timer_only_export_handler_guard_and_load(tmp_path):
    p = tprof.Profiler(timer_only=True)
    p.start()
    p.stop()
    with pytest.raises(RuntimeError, match="timer_only"):
        p.export()
    handler = tprof.export_chrome_tracing(str(tmp_path / "traces"), "w0")
    p = tprof.Profiler(targets=[tprof.ProfilerTarget.CPU],
                       on_trace_ready=handler)
    with p:
        torch.ones(4).sum()
    (written,) = list((tmp_path / "traces").iterdir())
    assert written.name.startswith("w0.") and p._export_dir == \
        str(tmp_path / "traces")
    assert json.loads(written.read_text())["traceEvents"]
    with tprof.profiler_guard() as g:
        assert isinstance(g, tprof.Profiler)
    for mod in (jprof, tprof):
        with pytest.raises(NotImplementedError):
            mod.load_profiler_result("x")
    with pytest.raises(ValueError, match="not on this build"):
        tprof.Profiler(targets=[tprof.ProfilerTarget.TPU])


def test_counter_facade_over_the_metrics_registry():
    tprof.register_counter_provider("test_torch_facade", lambda: {"n": 3})
    try:
        assert tprof.counters()["test_torch_facade"] == {"n": 3}
        assert tmetrics.provider_counters()["test_torch_facade"] == {"n": 3}
    finally:
        tprof.unregister_counter_provider("test_torch_facade")
    assert "test_torch_facade" not in tprof.counters()


# ---------------- device ----------------

def test_device_queries_without_a_card_match_jax_stubs():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for name in ("device_count", "is_available", "max_memory_allocated",
                 "memory_allocated"):
        assert getattr(tdevice.cuda, name)() == \
            getattr(jdevice.cuda, name)(), name
    tdevice.cuda.empty_cache()
    tdevice.cuda.synchronize()
    assert (tdevice.tpu.device_count(), tdevice.tpu.is_available(),
            tdevice.tpu.memory_stats()) == (0, False, {})
    assert tdevice.get_available_device() == ["cpu:0"]
    assert tdevice.get_all_device_type() == jdevice.get_all_device_type()
    assert tdevice.get_available_custom_device() == []
    for name in ("is_compiled_with_rocm", "is_compiled_with_xpu",
                 "is_compiled_with_ipu"):
        assert getattr(tdevice, name)() is getattr(jdevice, name)() is False
    assert tdevice.is_compiled_with_distribute() is True
    assert pt.get_cudnn_version() is None and \
        pt.is_compiled_with_rocm() is pt.is_compiled_with_xpu() is False


def test_streams_and_events_have_jax_methods_and_default_to_the_card():
    def public(cls):
        return {n for n in vars(cls) if not n.startswith("_")}

    assert public(tdevice.Stream) == public(jdevice.Stream)
    assert public(tdevice.Event) == public(jdevice.Event)
    assert {n for n in vars(type(tdevice.stream)) if not n.startswith("_")} \
        == {n for n in vars(type(jdevice.stream)) if not n.startswith("_")}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tdevice.Stream()
        with pytest.raises(RuntimeError, match="CUDA"):
            tdevice.Event()
    pt.set_device("cpu")
    s = tdevice.Stream()
    e = s.record_event()
    assert isinstance(e, tdevice.Event) and e.query()
    s.wait_event(e)
    s.wait_stream(tdevice.current_stream())
    s.synchronize()
    e.synchronize()
    with tdevice.stream_guard(s):
        x = torch.ones(3) * 2
    assert tdevice.set_stream(s) is s and x.sum().item() == 6.0
    assert tdevice.stream.Stream is tdevice.Stream
    assert tdevice.get_default_device() == torch.device("cpu")


# ---------------- amp.debugging ----------------

def _planted(dtype):
    a = np.arange(12, dtype=np.float32)
    a[[1, 5]] = np.nan
    a[[2, 7, 9]] = np.inf
    a[3] = -np.inf
    return a, torch.tensor(a, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_check_numerics_counts_and_raises_as_jax(dtype):
    a, t = _planted(dtype)
    mode = tdebug.DebugMode.CHECK_NAN_INF
    n_nan, n_inf = tdebug.check_numerics(t, "op", "x", debug_mode=mode)
    jn, ji = jdebug.check_numerics(paddle.to_tensor(a), "op", "x",
                                   debug_mode=jdebug.DebugMode.CHECK_NAN_INF)
    assert n_nan.dtype == n_inf.dtype == torch.int32
    assert n_nan.tolist() == np.asarray(jn.numpy()).tolist() == [2]
    assert n_inf.tolist() == np.asarray(ji.numpy()).tolist() == [4]
    for check, x in ((tdebug.check_numerics, t),
                     (jdebug.check_numerics, paddle.to_tensor(a))):
        with pytest.raises(FloatingPointError, match="2 nan, 4 inf"):
            check(x, "op", "x")
    ok = tdebug.check_numerics(torch.ones(3, dtype=dtype))
    assert [v.tolist() for v in ok] == [[0], [0]]
    assert [m.name for m in tdebug.DebugMode] == \
        [m.name for m in jdebug.DebugMode]


def test_tensor_checker_names_the_op_inside_a_forward():
    pt.set_device("cpu")

    class Net(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = pt.nn.Linear(4, 4)

        def forward(self, x):
            return torch.sqrt(self.fc(x) - 100.0)

    net = Net()
    x = torch.ones(2, 4)
    net(x)                                  # off: NaNs pass silently
    tdebug.enable_tensor_checker(tdebug.TensorCheckerConfig(True))
    with pytest.raises(FloatingPointError, match=r"aten\.sqrt"):
        net(x)
    # an allocation is not written yet: its garbage is not checked
    torch.empty(4096).new_empty((64, 64))
    tdebug.disable_tensor_checker()
    tdebug.enable_tensor_checker(tdebug.TensorCheckerConfig(
        True, debug_mode=tdebug.DebugMode.CHECK_NAN_INF))
    with pytest.warns(RuntimeWarning, match=r"aten\.sqrt.* 8 nan"):
        net(x)
    tdebug.disable_tensor_checker()
    tdebug.enable_tensor_checker(tdebug.TensorCheckerConfig(False))
    assert torch.isnan(net(x)).all()
    pt.set_flags({"FLAGS_check_nan_inf": True})
    with pytest.raises(FloatingPointError, match=r"aten\.sqrt"):
        net(x)
    pt.set_flags({"FLAGS_check_nan_inf": False})
    assert torch.isnan(net(x)).all()
    with tdebug.collect_operator_stats():
        tdebug.enable_operator_stats_collection()
        tdebug.disable_operator_stats_collection()
    for mod in (jdebug, tdebug):
        with pytest.raises(NotImplementedError):
            mod.compare_accuracy("a", "b", "c")
