"""Grammar-constrained decoding inside the port, where the JAX engine
is no oracle: seeded constrained streams (torch generators, not
threefry) are valid, K = 4 equals K = 0 bit for bit and a batch equals
its requests run one by one; the slab is released on retire and abort,
exhaustion is refused before anything queues, the compile cache is an
LRU, ``submit`` validates eagerly, and an engine with the knobs off
carries no grammar state.  Then the gateway's ``response_format`` /
``grammar`` parsing against the JAX gateway's cases, and a constrained
stream over HTTP equal to its in-process run."""

import http.client
import json
import types

import pytest

from paddle_tpu_torch.serving import (
    Engine, EngineConfig, GrammarError, SamplingParams, compile_regex,
    schema_to_regex,
)
from paddle_tpu_torch.serving.gateway import Gateway, GatewayConfig
from paddle_tpu_torch.serving.gateway.protocol import _Reject

from _torch_port_util import (  # noqa: F401
    TINY, jax_model, one_thread, port_model,
)

EOS = 95
SCHEMA = {"type": "object",
          "properties": {"a": {"enum": ["x", "y"]},
                         "b": {"type": "boolean"}},
          "required": ["a", "b"]}


def make_vocab(size=128):
    vocab = [chr(32 + i) for i in range(95)] + ["<eos>"]
    vocab.extend(['{"', '":', '",', '"}', 'true', 'false', 'null',
                  '": "', '", "', 'ab', 'abc', '0', '12'])
    while len(vocab) < size:
        vocab.append(f"<unused{len(vocab)}>")
    return vocab


VOCAB = make_vocab()
GREEDY = SamplingParams(max_new_tokens=40, eos_token_id=EOS)
SEEDED = SamplingParams(temperature=0.9, top_k=20, seed=7,
                        max_new_tokens=40, eos_token_id=EOS)
FREE = SamplingParams(max_new_tokens=8, temperature=0.8, seed=3)


@pytest.fixture(scope="module")
def model():
    return port_model(TINY, jax_model(TINY))


def _cfg(**kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_seq_len", 64)
    kw.setdefault("max_horizon", 4)
    kw.setdefault("prefix_block_size", 4)
    kw.setdefault("prefix_cache_bytes", 0)
    kw.setdefault("grammar_max_states", 128)
    kw.setdefault("grammar_vocab", VOCAB)
    return EngineConfig(**kw)


def _engine(model, **kw):
    return Engine(model, _cfg(**kw), device="cpu", register_profiler=False)


def _drive(eng):
    while eng.scheduler.has_work:
        eng.step()


def _text(req):
    return "".join(VOCAB[t] for t in req.output_ids if t != EOS)


def _valid(req, pattern):
    """At EOS the text is a sentence of the grammar; cut by the budget it
    is a prefix the grammar's DFA walked legally."""
    if req.finish_reason == "eos":
        assert compile_regex(pattern).matches(_text(req))
    else:
        assert req.finish_reason == "length"


@pytest.mark.parametrize("sp", [GREEDY, SEEDED], ids=["greedy", "seeded"])
def test_k4_equals_k0_bitwise(model, sp):
    outs = {}
    for k in (0, 4):
        eng = _engine(model, spec_k=k)
        r = eng.submit([3, 1, 4], sp, grammar=SCHEMA)
        _drive(eng)
        outs[k] = r.output_ids
        if k:
            st = eng.stats()["structured"]
            assert eng.counters()["spec_forced_tokens"] > 0
            # every forced draft a window could emit was accepted
            assert st["forced_tokens"] == st["forced_drafted"]
        eng.close()
    assert outs[4] == outs[0]
    if outs[0][-1] == EOS:
        obj = json.loads("".join(VOCAB[t] for t in outs[0][:-1]))
        assert obj["a"] in ("x", "y") and isinstance(obj["b"], bool)


@pytest.mark.parametrize("spec_k", [0, 4])
def test_batched_equals_sequential_bitwise(model, spec_k):
    """Seeded schema, greedy regex and seeded free text in one batch
    equal their solo runs token for token."""
    reqs = [([3, 1, 4], SEEDED, SCHEMA), ([9, 2, 6], GREEDY, "(ab|abc)*c"),
            ([5, 5, 7], FREE, None)]
    eng = _engine(model, num_slots=4, spec_k=spec_k)
    batch = [eng.submit(p, sp, grammar=g) for p, sp, g in reqs]
    _drive(eng)
    eng.close()
    solo = []
    for p, sp, g in reqs:
        e = _engine(model, spec_k=spec_k)
        r = e.submit(p, sp, grammar=g)
        _drive(e)
        e.close()
        solo.append(r.output_ids)
    assert [r.output_ids for r in batch] == solo
    _valid(batch[0], schema_to_regex(SCHEMA))
    _valid(batch[1], "(ab|abc)*c")


def test_seeded_constrained_deterministic(model):
    outs = []
    for _ in range(2):
        eng = _engine(model)
        r = eng.submit([3, 1, 4], SEEDED, grammar=SCHEMA)
        _drive(eng)
        eng.close()
        outs.append(r.output_ids)
    assert outs[0] == outs[1]


def test_slab_released_on_retire_and_abort(model):
    eng = _engine(model, num_slots=1)
    done = eng.submit([3, 1, 4], GREEDY, grammar=SCHEMA)
    queued = eng.submit([9, 2, 6], GREEDY, grammar=SCHEMA)
    assert eng.stats()["structured"]["grammars_installed"] == 1
    eng.abort(queued)                        # released from WAITING
    _drive(eng)
    assert done.finish_reason in ("eos", "length")
    st = eng.stats()["structured"]
    assert st["grammars_installed"] == 0 and st["states_used"] == 1
    assert st["compile_cache_hits"] == 1
    running = eng.submit([3, 1, 4], GREEDY, grammar=SCHEMA)
    eng.step()
    eng.abort(running)                       # released from RUNNING
    assert eng.stats()["structured"]["grammars_installed"] == 0
    assert eng.pool.blocks_in_use == eng.prefix.stats()["used_blocks"]
    eng.close()


def test_slab_exhaustion_refused_before_queueing(model):
    eng = _engine(model, grammar_max_states=8)
    with pytest.raises(RuntimeError, match="slab exhausted"):
        eng.submit([3, 1, 4], GREEDY, grammar=SCHEMA)
    assert eng.scheduler.queue_depth == 0
    assert eng.stats()["structured"]["grammars_installed"] == 0
    r = eng.submit([3, 1, 4], GREEDY, grammar="a{2}")
    free = eng.submit([9, 2, 6], SamplingParams(max_new_tokens=4))
    _drive(eng)
    assert _text(r) == "aa" and r.finish_reason == "eos"
    assert len(free.output_ids) == 4
    assert eng.stats()["structured"]["grammars_installed"] == 0
    eng.close()


def test_compile_cache_bounded_lru(model):
    eng = _engine(model, grammar_cache_keep=2)
    pats = ["a{%d}" % n for n in (1, 2, 3, 4)]
    for p in pats:
        eng.submit([3], GREEDY, grammar=p)
        _drive(eng)
    st = eng.stats()["structured"]
    assert st["compile_cache_entries"] == 2
    assert st["compile_cache_misses"] == 4
    eng.submit([3], GREEDY, grammar=pats[-1])      # kept: a hit
    _drive(eng)
    assert eng.stats()["structured"]["compile_cache_hits"] == 1
    eng.submit([3], GREEDY, grammar=pats[0])       # evicted: recompiles
    _drive(eng)
    st = eng.stats()["structured"]
    assert st["compile_cache_misses"] == 5
    assert st["compile_cache_entries"] == 2
    eng.close()
    # live grammars stay cached even at keep=0, and go once retired
    eng = _engine(model, grammar_cache_keep=0, num_slots=1)
    eng.submit([3, 1, 4], GREEDY, grammar=SCHEMA)
    eng.submit([9, 2, 6], GREEDY, grammar="a{2}")
    assert eng.stats()["structured"]["compile_cache_entries"] == 2
    _drive(eng)
    assert eng.stats()["structured"]["compile_cache_entries"] == 0
    eng.close()


def test_submit_validation(model):
    eng = _engine(model)
    with pytest.raises(ValueError, match="eos"):
        eng.submit([1, 2], SamplingParams(max_new_tokens=4), grammar=SCHEMA)
    with pytest.raises(GrammarError):
        eng.submit([1, 2], GREEDY, grammar=17)
    with pytest.raises(GrammarError, match="anyOf"):
        eng.submit([1, 2], GREEDY, grammar={"anyOf": []})
    assert eng.scheduler.queue_depth == 0
    eng.close()
    off = Engine(model, EngineConfig(num_slots=2, max_seq_len=64),
                 device="cpu", register_profiler=False)
    with pytest.raises(ValueError, match="grammar_max_states"):
        off.submit([1, 2], GREEDY, grammar=SCHEMA)
    off.close()
    novocab = _engine(model, grammar_vocab=None)
    with pytest.raises(ValueError, match="grammar_vocab"):
        novocab.submit([1, 2], GREEDY, grammar=SCHEMA)
    novocab.close()
    with pytest.raises(ValueError, match="grammar_max_states"):
        Engine(model, EngineConfig(num_slots=2, max_seq_len=64,
                                   grammar_max_states=-1), device="cpu",
               register_profiler=False)


def test_knobs_off_engine_carries_no_grammar_state(model):
    """grammar_max_states=0: no slab, no device tables, no DFA column in
    the device state; and free-text streams on a structured engine
    equal the knobs-off engine's, greedy and seeded, at K 0 and 4."""
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6]]
    params = [SamplingParams(max_new_tokens=10), FREE]
    for k in (0, 4):
        off = Engine(model, EngineConfig(num_slots=2, max_seq_len=64,
                                         max_horizon=4, spec_k=k),
                     device="cpu", register_profiler=False)
        want = off.generate(prompts, params)
        assert off._grammar_slab is None and off._d_dfa is None
        assert off._d_state[8] is None
        assert off.stats()["structured"]["enabled"] is False
        assert off.counters()["grammar_masked_fraction"] == 0.0
        off.close()
        on = _engine(model, spec_k=k, max_horizon=4)
        assert on.generate(prompts, params) == want
        assert on.stats()["structured"]["enabled"] is True
        on.close()


# ------------------------------------------------------------- gateway
def _parse(payload):
    gw = types.SimpleNamespace(config=GatewayConfig())
    base = {"prompt": [1, 2, 3], "eos_token_id": EOS}
    return Gateway.parse_completion(gw, dict(base, **payload))


def _reject(payload):
    with pytest.raises(_Reject) as e:
        _parse(payload)
    return e.value


def test_response_format_json_schema():
    parsed = _parse({"response_format": {
        "type": "json_schema", "json_schema": {"schema": SCHEMA}}})
    assert parsed["grammar"].kind == "json_schema"
    parsed = _parse({"response_format": {"type": "json_schema",
                                         "json_schema": SCHEMA}})
    assert parsed["grammar"].kind == "json_schema"
    assert _parse({"response_format": {"type": "text"}})["grammar"] is None
    assert _parse({})["grammar"] is None


def test_grammar_regex_forms():
    assert _parse({"grammar": "a+b"})["grammar"].kind == "regex"
    parsed = _parse({"grammar": {"type": "regex", "pattern": "a+b"}})
    assert parsed["grammar"].pattern == "a+b"


@pytest.mark.parametrize("payload,needle", [
    ({"response_format": {"type": "json_schema",
                          "json_schema": {"schema": {"anyOf": []}}}},
     "anyOf"),
    ({"response_format": {"type": "json_object"}}, "json_object"),
    ({"grammar": "(a"}, "regex"),
    ({"grammar": {"type": "bnf", "rules": []}}, "regex"),
    ({"grammar": "a+", "response_format": {
        "type": "json_schema", "json_schema": SCHEMA}}, "exclusive"),
], ids=["anyOf", "json_object", "bad_regex", "bnf", "exclusive"])
def test_invalid_grammar_400s_name_the_feature(payload, needle):
    e = _reject(payload)
    assert e.status == 400 and e.code == "invalid_grammar"
    assert needle in str(e)


def test_constrained_requires_eos():
    gw = types.SimpleNamespace(config=GatewayConfig())
    with pytest.raises(_Reject) as e:
        Gateway.parse_completion(gw, {"prompt": [1, 2], "grammar": "a+"})
    assert e.value.code == "invalid_grammar"
    assert "eos_token_id" in str(e.value)


def test_http_end_to_end_constrained(model):
    """A json_schema response_format through a live gateway streams the
    engine's constrained stream; a malformed grammar 400s before
    anything queues."""
    ref = _engine(model)
    want = ref.submit([3, 1, 4], GREEDY, grammar=SCHEMA)
    _drive(ref)
    ref.close()
    eng = _engine(model)
    gw = Gateway([eng], GatewayConfig(model_id="tiny")).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=60)
        body = json.dumps({
            "prompt": [3, 1, 4], "max_tokens": 40, "eos_token_id": EOS,
            "response_format": {"type": "json_schema",
                                "json_schema": {"schema": SCHEMA}}})
        conn.request("POST", "/v1/completions", body,
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        doc = json.loads(r.read())
        assert r.status == 200, doc
        choice = doc["choices"][0]
        assert choice["token_ids"] == want.output_ids
        assert choice["finish_reason"] == (
            "stop" if want.finish_reason == "eos" else "length")
        conn.request("POST", "/v1/completions",
                     json.dumps({"prompt": [1], "eos_token_id": EOS,
                                 "grammar": "(a"}),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        doc = json.loads(r.read())
        assert r.status == 400
        assert doc["error"]["code"] == "invalid_grammar"
        conn.close()
    finally:
        gw.shutdown()
    assert eng.stats()["structured"]["grammars_installed"] == 0
