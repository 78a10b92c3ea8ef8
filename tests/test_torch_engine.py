"""The port's serving engine (``paddle_tpu_torch.serving.Engine``) on the
CPU against the JAX engine on the same weights, and its own invariants.

Greedy streams depend on the logits alone, so the port must emit the
JAX engine's token ids exactly (both run in f32; the tiny models' top-2
logit margins are far above the 1e-6 reordering noise).  Sampled
streams differ from the JAX engine's by design (torch generators, not
threefry bits), so they are held to the port's own invariants: a
request's tokens depend only on (seed, k, logits), never on its batch.
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu.serving import Engine as JEngine
from paddle_tpu.serving import EngineConfig as JEngineConfig
from paddle_tpu.serving import SamplingParams as JSamplingParams
from paddle_tpu_torch.models import GPTForCausalLM
from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

from _torch_port_util import (  # noqa: F401
    CONFIGS, TINY, jax_model, one_thread, port_model, torch_config,
)

PORT = pathlib.Path(__file__).resolve().parent.parent / "paddle_tpu_torch"


def _prompts(cfg, lengths, seed=0):
    r = np.random.RandomState(seed)
    return [r.randint(0, cfg.vocab_size, n).tolist() for n in lengths]


def _port_engine(cfg, jm=None, **kw):
    tm = port_model(cfg, jm if jm is not None else jax_model(cfg))
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_seq_len", 64)
    kw.setdefault("max_horizon", 4)
    return Engine(tm, EngineConfig(**kw), device="cpu")


def _staggered(engine, sp_cls, prompts, new_tokens):
    """Submit the first three prompts, step once, submit the rest, drain:
    with 2 slots the later requests queue behind running ones."""
    reqs = [engine.submit(p, sp_cls(max_new_tokens=n))
            for p, n in zip(prompts[:3], new_tokens[:3])]
    engine.step()
    reqs += [engine.submit(p, sp_cls(max_new_tokens=n))
             for p, n in zip(prompts[3:], new_tokens[3:])]
    engine.run()
    return [[int(t) for t in r.output_ids] for r in reqs]


def _assert_only_the_prefix_store_holds_blocks(eng):
    """After a drain the prefix store (on by default, as in the JAX
    engine) holds the only live blocks: nothing is leased, and evicting
    the store's blocks leaves the pool empty."""
    held = eng.prefix.stats()["used_blocks"]
    assert eng.cache.leased_blocks == 0
    assert eng.stats()["kv_blocks_in_use"] == held
    assert eng.prefix.reclaim(held) == held
    assert eng.stats()["kv_blocks_in_use"] == 0


@CONFIGS
def test_greedy_streams_match_the_jax_engine(cfg):
    jm = jax_model(cfg, seed=7)
    prompts = _prompts(cfg, [5, 11, 3, 17, 8])
    budgets = [6, 9, 4, 7, 5]
    ref = _staggered(
        JEngine(jm, JEngineConfig(num_slots=2, max_seq_len=64,
                                  max_horizon=4), register_profiler=False),
        JSamplingParams, prompts, budgets)
    eng = _port_engine(cfg, jm)
    out = _staggered(eng, SamplingParams, prompts, budgets)
    assert out == ref
    st = eng.stats()
    assert st["requests_finished"] == 5
    _assert_only_the_prefix_store_holds_blocks(eng)
    assert st["prefill_calls"] >= 3          # the queue forced re-admission


def test_sampled_tokens_do_not_depend_on_batch_composition():
    eng = _port_engine(TINY, num_slots=4)
    target = _prompts(TINY, [9], seed=1)[0]
    sp = SamplingParams(max_new_tokens=10, temperature=0.9, top_k=20,
                        top_p=0.9, seed=1234)
    alone = eng.generate(target, sp)
    others = _prompts(TINY, [4, 13, 6], seed=2)
    greedy = SamplingParams(max_new_tokens=12)
    reqs = [eng.submit(others[0], greedy), eng.submit(others[1], greedy)]
    eng.step()                           # the target joins a running batch
    req = eng.submit(target, sp)
    reqs.append(eng.submit(others[2], SamplingParams(
        max_new_tokens=5, temperature=1.3, seed=9)))
    eng.run()
    assert req.output_ids == alone
    # a different seed gives a different stream
    assert eng.generate(target, SamplingParams(
        max_new_tokens=10, temperature=0.9, top_k=20, top_p=0.9,
        seed=4321)) != alone


def test_top_k_1_equals_greedy():
    eng = _port_engine(TINY)
    prompts = _prompts(TINY, [7, 12], seed=3)
    greedy = eng.generate(prompts, SamplingParams(max_new_tokens=8))
    top1 = eng.generate(prompts, SamplingParams(
        max_new_tokens=8, temperature=0.7, top_k=1, seed=5))
    assert top1 == greedy


def test_blocks_released_and_launch_counts_untouched_on_cpu():
    eng = _port_engine(TINY, num_slots=3)
    before = eng.stats()["kernel_launches"]
    eng.generate(_prompts(TINY, [20, 3, 33, 9], seed=4),
                 SamplingParams(max_new_tokens=6))
    st = eng.stats()
    _assert_only_the_prefix_store_holds_blocks(eng)
    assert eng.cache.leased_blocks == 0
    assert eng.cache.free_slots == 3
    assert st["tokens_generated"] == 4 * 6
    # CPU tensors take the plain versions: no kernel was launched
    assert st["kernel_launches"] == before


def test_eos_freezes_the_lane():
    eng = _port_engine(TINY)
    prompt = _prompts(TINY, [6], seed=5)[0]
    free = eng.generate(prompt, SamplingParams(max_new_tokens=8))
    eos = free[3]
    cut = eng.generate(prompt, SamplingParams(max_new_tokens=8,
                                              eos_token_id=eos))
    assert cut == free[:free.index(eos) + 1]
    assert eng.stats()["kv_blocks_in_use"] == 0


def test_engine_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tm = GPTForCausalLM(torch_config(TINY), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(tm)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(tm, EngineConfig(num_slots=2, max_seq_len=32))
    Engine(tm, EngineConfig(num_slots=2, max_seq_len=32), device="cpu")


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_paddle_tpu():
    files = sorted(PORT.rglob("*.py")) + [PORT.parent / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        bad = _imported_roots(f) & {"jax", "jaxlib", "paddle_tpu"}
        assert not bad, f"{f.relative_to(PORT.parent)} imports {bad}"
    # and at run time: importing every module pulls in neither
    mods = [".".join(f.relative_to(PORT.parent).with_suffix("").parts)
            for f in sorted(PORT.rglob("*.py"))]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'paddle_tpu')]\n"
              "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=PORT.parent, timeout=120)


def test_stats_ttft_avg_follows_the_jax_engine():
    """``stats()["ttft_avg_s"]`` has the JAX engine's name and rule:
    absent until a request finishes, then the sum of the finished
    requests' TTFT over their count."""
    jm = jax_model(TINY, seed=3)
    prompts = _prompts(TINY, [5, 9, 4])
    jeng = JEngine(jm, JEngineConfig(num_slots=2, max_seq_len=64,
                                     max_horizon=4), register_profiler=False)
    eng = _port_engine(TINY, jm)
    for e, sp in ((jeng, JSamplingParams), (eng, SamplingParams)):
        assert "ttft_avg_s" not in e.stats()
        reqs = [e.submit(p, sp(max_new_tokens=3)) for p in prompts]
        e.run()
        st = e.stats()
        assert st["ttft_avg_s"] == pytest.approx(
            sum(r.ttft for r in reqs) / len(reqs), rel=1e-12)
    assert "ttft_mean_s" not in eng.stats()
