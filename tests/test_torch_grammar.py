"""The port's grammar compiler (``paddle_tpu_torch.serving.structured``,
a copy of the JAX package's) against the JAX one on every grammar of
``tests/test_grammar_dfa.py`` and ``tests/test_structured.py``: the
char DFA, the token DFA's ``next_state``, ``mask``, ``accepting``,
``forced`` and ``popcount`` array for array, the ``GrammarError``
messages word for word, and the slab after the same installs and
releases.  Then the port's mask unpacking, masked sampling and
``forced_chain`` against the JAX functions.  Exact throughout."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.serving import drafter as jdrafter
from paddle_tpu.serving import engine as jengine
from paddle_tpu.serving import sampling as jsampling
from paddle_tpu.serving.structured import grammar as jg
from paddle_tpu_torch.serving import drafter, sampling
from paddle_tpu_torch.serving.structured import grammar as tg

from _torch_port_util import one_thread  # noqa: F401


def make_vocab(size=128):
    """tests/test_grammar_dfa.py's vocabulary: printable ASCII (ids
    0..94), <eos> at 95, multi-char JSON and word pieces, fillers."""
    vocab = [chr(32 + i) for i in range(95)]
    vocab.append("<eos>")
    vocab.extend(['{"', '":', '",', '"}', 'true', 'false', 'null',
                  '": "', '", "', 'ab', 'abc', '0', '12'])
    while len(vocab) < size:
        vocab.append(f"<unused{len(vocab)}>")
    return vocab


VOCAB, EOS = make_vocab(), 95
SMALL, SMALL_EOS = ["a", "b", "c", "ab", "x", "", "<eos>"], 6
SCHEMA = {"type": "object",
          "properties": {"a": {"enum": ["x", "y"]},
                         "b": {"type": "boolean"}},
          "required": ["a", "b"]}
SCHEMAS = [
    SCHEMA,
    {"type": "object", "properties": {"a": {"type": "boolean"},
                                      "b": {"type": "null"}},
     "required": ["a"]},
    {"enum": [1, "x", True]},
    {"type": "array", "items": {"type": "array",
                                "items": {"type": "integer"}}},
    {"type": "integer"}, {"type": "number"}, {"type": "string"},
    {"type": "boolean"}, {"type": "null"},
]
REGEXES = ["ab|cd", "a{2,4}", "a{3}", "a{2,}", r"[a-c]+[0-9]?", r"[^x]",
           r"\d+", r"\w+\s\w+", "(ab)*", "a+", "a?b", "a.c", "a|a",
           "(a*)*", "(a?)+", "(a|)*", "a**", "()", r"\x41B",
           r"[\x41-\x43]", "(ab|abc)*c", "a{1}", "a{2}", "a{4}", "[0-9]+"]
# (grammar, vocab, eos, vocab_size) through compile_grammar
COMPILED = ([(g, VOCAB, EOS, None) for g in REGEXES + SCHEMAS]
            + [("ab*c", SMALL, SMALL_EOS, None),
               ("a+", SMALL, SMALL_EOS, 16),
               ("(a|b)c{2}", SMALL, SMALL_EOS, None),
               ("a{2,9}b", SMALL, SMALL_EOS, None)])
BAD_REGEXES = ["(?=a)", "(a", "[a", "a{4,2}", "*a", "a{,3}", r"a\x4",
               r"\u12", r"\x", r"\x4g", r"\u004g", r"\x+4", r"[\x4]",
               r"[\u123]", r"[a-\x4]"]
BAD_SCHEMAS = [{k: []} for k in ("anyOf", "$ref", "patternProperties",
                                 "minimum")]


def _id(case):
    return str(case[0])[:48] + f"-v{case[3] or len(case[1])}"


def _fields(d):
    return {f: getattr(d, f) for f in ("next_state", "mask", "accepting",
                                       "forced", "popcount")}


@pytest.mark.parametrize("case", COMPILED, ids=[_id(c) for c in COMPILED])
def test_token_dfa_tables_equal_jax(case):
    grammar, vocab, eos, size = case
    want = _fields(jg.compile_grammar(grammar, vocab, eos, vocab_size=size))
    got = _fields(tg.compile_grammar(grammar, vocab, eos, vocab_size=size))
    for f in want:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


@pytest.mark.parametrize("grammar", REGEXES + SCHEMAS,
                         ids=[str(g)[:48] for g in REGEXES + SCHEMAS])
def test_char_dfa_and_spec_equal_jax(grammar):
    js, ts = jg.as_grammar_spec(grammar), tg.as_grammar_spec(grammar)
    assert (ts.kind, ts.pattern, ts.key) == (js.kind, js.pattern, js.key)
    jd, td = jg.compile_regex(js.pattern), tg.compile_regex(ts.pattern)
    assert (td.trans, td.accepting) == (jd.trans, jd.accepting)


def _error(fn, *args):
    with pytest.raises(Exception) as e:
        fn(*args)
    return type(e.value).__name__, str(e.value)


@pytest.mark.parametrize("pattern", BAD_REGEXES)
def test_regex_errors_equal_jax(pattern):
    got = _error(tg.compile_regex, pattern)
    assert got == _error(jg.compile_regex, pattern)
    assert got[0] == "GrammarError"


@pytest.mark.parametrize("schema", BAD_SCHEMAS,
                         ids=[next(iter(s)) for s in BAD_SCHEMAS])
def test_schema_errors_name_the_feature_as_jax(schema):
    got = _error(tg.schema_to_regex, schema)
    assert got == _error(jg.schema_to_regex, schema)
    assert next(iter(schema)) in got[1]
    assert _error(tg.GrammarSpec.json_schema, schema) == \
        _error(jg.GrammarSpec.json_schema, schema)


@pytest.mark.parametrize("args", [("z+", SMALL, SMALL_EOS),
                                  ("a", SMALL, 99), (17, VOCAB, EOS)],
                         ids=["inexpressible", "eos_range", "not_grammar"])
def test_compile_errors_equal_jax(args):
    got = _error(tg.compile_grammar, *args)
    assert got == _error(jg.compile_grammar, *args)
    assert got[0] == "GrammarError"


def test_slab_equal_jax_over_installs_and_releases():
    dfas = {name: (jg.compile_grammar(g, VOCAB, EOS),
                   tg.compile_grammar(g, VOCAB, EOS))
            for name, g in (("schema", SCHEMA), ("ab", "(ab|abc)*c"),
                            ("digits", "[0-9]+"))}
    js, ts = jg.GrammarSlab(64, len(VOCAB)), tg.GrammarSlab(64, len(VOCAB))
    ops = [("install", "schema"), ("install", "ab"), ("install", "schema"),
           ("release", "schema"), ("release", "schema"),
           ("install", "digits"), ("release", "ab"), ("install", "ab")]
    for op, name in ops:
        if op == "install":
            assert ts.install(name, dfas[name][1]) == \
                js.install(name, dfas[name][0])
        else:
            ts.release(name)
            js.release(name)
        for f in ("next", "mask", "forced", "popcount", "accepting"):
            np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))
        assert (ts.states_used, ts.grammars_installed, ts.device_bytes) \
            == (js.states_used, js.grammars_installed, js.device_bytes)
    with pytest.raises(RuntimeError) as te:
        tg.GrammarSlab(8, len(VOCAB)).install("s", dfas["schema"][1])
    with pytest.raises(RuntimeError) as je:
        jg.GrammarSlab(8, len(VOCAB)).install("s", dfas["schema"][0])
    assert str(te.value) == str(je.value)


def test_unpack_mask_equals_jax():
    """The slab's uint32 words viewed as int32 unpack to the JAX
    engine's boolean mask, bit 31 included."""
    rng = np.random.RandomState(0)
    words = rng.randint(0, 2 ** 32, size=(6, 5), dtype=np.uint64)
    words = words.astype(np.uint32)
    words[0] = 0xFFFFFFFF
    words[1] = 0x80000000
    for vocab in (160, 157, 129):
        want = np.asarray(jengine._unpack_mask(jnp.asarray(words), vocab))
        got = sampling._unpack_mask(torch.from_numpy(words.view(np.int32)),
                                    vocab)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)


def test_masked_sampling_greedy_equals_jax():
    """Greedy masked sampling picks what JAX's sample_window picks, at
    MASK_FLOOR; an all-True row is the identity; f16 logits are masked
    in f32, so no row turns NaN."""
    assert sampling.MASK_FLOOR == jsampling.MASK_FLOOR
    rng = np.random.RandomState(1)
    logits = rng.randn(3, 2, 40).astype(np.float32)
    allowed = rng.rand(3, 2, 40) < 0.3
    allowed[..., 7] = True
    allowed[0, 0] = True
    zeros = np.zeros(3, np.int32)
    want = np.asarray(jsampling.sample_window(
        jnp.asarray(logits), zeros.astype(np.uint32), zeros,
        np.zeros(3, np.float32), zeros, np.ones(3, np.float32),
        allowed=jnp.asarray(allowed)))
    t = torch.from_numpy(logits)
    got = sampling.sample_window(t, [0] * 3, [0] * 3, [0.0] * 3, [0] * 3,
                                 [1.0] * 3, allowed=torch.from_numpy(allowed))
    np.testing.assert_array_equal(got.numpy(), want)
    masked = sampling.apply_mask(t.half(), torch.from_numpy(allowed))
    assert masked.dtype == torch.float32
    assert torch.equal(masked[0, 0], t.half()[0, 0].float())
    assert torch.isfinite(torch.softmax(masked, -1)).all()


def test_masked_draws_stay_legal_and_keyed():
    """A sampled masked window draws only legal tokens, and position j
    draws as token counts + j of its request (the unmasked key rule)."""
    rng = np.random.RandomState(2)
    logits = torch.from_numpy(rng.randn(2, 3, 50).astype(np.float32))
    allowed = torch.from_numpy(rng.rand(2, 3, 50) < 0.2)
    allowed[..., 3] = True
    args = ([5, 6], [10, 20], [0.9, 1.1], [0, 8], [1.0, 0.9])
    got = sampling.sample_window(logits, *args, allowed=allowed)
    assert allowed.gather(2, got[..., None]).all()
    again = sampling.sample_window(logits, *args, allowed=allowed)
    assert torch.equal(got, again)
    # window position 1 of lane 0 is token 11 of its request
    one = sampling.sample_window(logits[:, 1:2], args[0], [11, 21],
                                 *args[2:], allowed=allowed[:, 1:2])
    assert torch.equal(one[:, 0], got[:, 1])


@pytest.mark.parametrize("k", [1, 3, 5])
def test_forced_chain_equals_jax(k):
    dfa = jg.compile_grammar(SCHEMA, VOCAB, EOS)
    slab = jg.GrammarSlab(64, len(VOCAB))
    off = slab.install("s", dfa)
    states = np.array([0, off] + list(range(off, off + dfa.n_states)),
                      np.int32)
    want = np.asarray(jdrafter.forced_chain(
        jnp.asarray(states), jnp.asarray(slab.next),
        jnp.asarray(slab.forced), k))
    got = drafter.forced_chain(torch.from_numpy(states),
                               torch.from_numpy(slab.next),
                               torch.from_numpy(slab.forced), k)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).any() and (want < 0).any()
