"""Grammar-constrained decoding in the port's engine against the JAX
engine on the same TINY / TINY_GQA weights (``port_model(cfg,
jax_model(cfg))``): greedy constrained requests (a JSON schema, a
regex) beside a free-text one, at K 0 and 4 with forced drafting on and
off, with chunked prefill, with the prefix store off, under int8 KV and
weights, across a preemption and across ``resume_ids``.  The streams
and the host counters (``spec_forced_tokens``, the masked-fraction
histogram, decode steps, blocks, every shared ``counters()`` key) are
equal exactly.  Sampled streams differ from JAX's by design (torch
generators), so they are held inside the port in
test_torch_structured_port.py."""

import json

import numpy as np
import pytest

from paddle_tpu.serving import Engine as JEngine
from paddle_tpu.serving import EngineConfig as JEngineConfig
from paddle_tpu.serving import SamplingParams as JSamplingParams
from paddle_tpu.serving import engine as jengine_mod
from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams
from paddle_tpu_torch.serving import engine as engine_mod
from paddle_tpu_torch.serving.structured import compile_grammar, compile_regex

from _torch_port_util import (  # noqa: F401
    CONFIGS, TINY, TINY_GQA, jax_compile_cache, jax_model, one_thread,
    port_model,
)

pytestmark = pytest.mark.usefixtures("jax_compile_cache")

EOS = 95
SCHEMA = {"type": "object",
          "properties": {"a": {"enum": ["x", "y"]},
                         "b": {"type": "boolean"}},
          "required": ["a", "b"]}
REGEX = "(ab|abc)*c"
# the port's counters() key the JAX engine keeps only as a histogram,
# and the wall-clock ones
PORT_ONLY = {"grammar_masked_fraction"}
TIMED = {"ttft_avg_s", "tokens_per_s"}


def make_vocab(size):
    """Printable ASCII (ids 0..94), <eos> at 95, multi-char JSON and
    word pieces, then fillers, cut at ``size``."""
    vocab = [chr(32 + i) for i in range(95)] + ["<eos>"]
    vocab.extend(['{"', '":', '",', '"}', 'true', 'false', 'null',
                  '": "', '", "', 'ab', 'abc', '0', '12'])
    while len(vocab) < size:
        vocab.append(f"<unused{len(vocab)}>")
    return vocab[:size]


def _kw(cfg, **kw):
    kw.setdefault("num_slots", 4)
    kw.setdefault("max_seq_len", 64)
    kw.setdefault("max_horizon", 4)
    kw.setdefault("prefix_block_size", 4)
    kw.setdefault("grammar_max_states", 128)
    kw.setdefault("grammar_vocab", make_vocab(cfg.vocab_size))
    return kw


def _pair(cfg, **kw):
    jm = jax_model(cfg, seed=0)
    kw = _kw(cfg, **kw)
    return (JEngine(jm, JEngineConfig(program_cards=False, **kw),
                    register_profiler=False),
            Engine(port_model(cfg, jm), EngineConfig(**kw), device="cpu",
                   register_profiler=False))


def _sp(eng, **kw):
    return (JSamplingParams if isinstance(eng, JEngine)
            else SamplingParams)(**kw)


def _requests(cfg):
    """Two constrained greedy requests and a free-text one."""
    r = np.random.RandomState(3)
    prompts = [r.randint(1, cfg.vocab_size, n).tolist() for n in (5, 9, 7)]
    return [(prompts[0], SCHEMA, 40), (prompts[1], REGEX, 30),
            (prompts[2], None, 12)]


def _submit(eng, reqs, **extra):
    out = []
    for prompt, grammar, new in reqs:
        sp = _sp(eng, max_new_tokens=new, eos_token_id=EOS)
        out.append(eng.submit(prompt, sp, grammar=grammar, **extra))
    return out


def _drive(eng):
    while eng.scheduler.has_work:
        eng.step()


def _masked(eng):
    """(count, sum) of the masked-fraction histogram of ``eng``."""
    fam = (jengine_mod if isinstance(eng, JEngine)
           else engine_mod)._SRV_GRAMMAR_MASKED
    st = fam.stats(engine=eng._profiler_name) or {"count": 0, "sum": 0.0}
    return st["count"], st["sum"]


def _assert_same(jeng, eng, jreqs, reqs, vocab):
    assert [[int(t) for t in r.output_ids] for r in reqs] == \
        [[int(t) for t in r.output_ids] for r in jreqs]
    jc, c = jeng.counters(), eng.counters()
    for k in sorted(set(c) - TIMED - PORT_ONLY):
        assert c[k] == jc[k], (k, c[k], jc[k])
    count, total = _masked(jeng)
    assert _masked(eng) == (count, total)
    assert c["grammar_masked_fraction"] == (total / count if count else 0.0)
    js, s = jeng.stats()["structured"], eng.stats()["structured"]
    assert {k: s[k] for k in js} == js
    for r in reqs:
        if r.grammar is None:
            continue
        # a stream that ends at EOS is a sentence of the grammar; one cut
        # by its budget is a legal prefix of one
        dfa = compile_grammar(r.grammar, vocab, EOS)
        st = 0
        for t in r.output_ids:
            assert dfa.allows(st, t), (r.output_ids, t)
            st = dfa.step(st, t)
        if r.finish_reason == "eos":
            text = "".join(vocab[t] for t in r.output_ids[:-1])
            assert compile_regex(r.grammar.pattern).matches(text)
            if r.grammar.kind == "json_schema":
                assert set(json.loads(text)) == {"a", "b"}
    return c


VARIANTS = {
    "k0": {},
    "k4_forced": dict(spec_k=4),
    "k4_not_forced": dict(spec_k=4, grammar_forced_drafting=False),
    "chunked": dict(prefill_chunk_tokens=8, min_prefill_bucket=4),
    "prefix_off": dict(prefix_cache_bytes=0),
    "int8": dict(kv_cache_dtype="int8", weight_dtype="int8"),
}


@CONFIGS
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_constrained_greedy_equals_jax(cfg, variant):
    jeng, eng = _pair(cfg, **VARIANTS[variant])
    reqs = _requests(cfg)
    if variant == "chunked":
        r = np.random.RandomState(4)
        reqs[0] = (r.randint(1, cfg.vocab_size, 19).tolist(), SCHEMA, 40)
    jreqs, preqs = _submit(jeng, reqs), _submit(eng, reqs)
    _drive(jeng)
    _drive(eng)
    c = _assert_same(jeng, eng, jreqs, preqs, make_vocab(cfg.vocab_size))
    if variant == "k4_forced":
        assert c["spec_forced_tokens"] > 0
    if variant == "chunked":
        assert c["prefill_chunked_requests"] >= 1
    assert eng.stats()["structured"]["grammars_installed"] == 0
    jeng.close()
    eng.close()


@CONFIGS
@pytest.mark.parametrize("spec_k", [0, 4])
def test_preemption_resume_walks_the_grammar_as_jax(cfg, spec_k):
    """A constrained lane preempted mid-decode re-admits through the
    DFA admission walk; both engines take the same steps."""
    jeng, eng = _pair(cfg, spec_k=spec_k)
    reqs = _requests(cfg)[:2]
    jreqs, preqs = _submit(jeng, reqs), _submit(eng, reqs)
    for e, rs in ((jeng, jreqs), (eng, preqs)):
        e.step(horizon=2)
        e.step(horizon=2)
        e.preempt(rs[0])
        # the preempted request keeps its slab reference
        assert rs[0].request_id in e._grammar_keys
        _drive(e)
    c = _assert_same(jeng, eng, jreqs, preqs, make_vocab(cfg.vocab_size))
    assert c["preemptions"] == 1
    jeng.close()
    eng.close()


@CONFIGS
def test_resume_ids_walk_the_grammar_as_jax(cfg):
    """Failover under a grammar: a fresh engine takes over a constrained
    stream after ``cut`` tokens; illegal resume tokens are refused."""
    jref, ref = _pair(cfg)
    want = _submit(ref, _requests(cfg)[:1])[0]
    _drive(ref)
    ref.close()
    jref.close()
    cut = 4
    assert len(want.output_ids) > cut + 1
    jeng, eng = _pair(cfg)
    reqs = _requests(cfg)[:1]
    jreqs = _submit(jeng, reqs, resume_ids=want.output_ids[:cut])
    preqs = _submit(eng, reqs, resume_ids=want.output_ids[:cut])
    _drive(jeng)
    _drive(eng)
    _assert_same(jeng, eng, jreqs, preqs, make_vocab(cfg.vocab_size))
    assert preqs[0].output_ids == want.output_ids
    for e in (jeng, eng):
        with pytest.raises(ValueError, match="illegal") as err:
            _submit(e, reqs, resume_ids=[90, 1])
        assert e.scheduler.queue_depth == 0
        assert e.stats()["structured"]["grammars_installed"] == 0
    jeng.close()
    eng.close()
