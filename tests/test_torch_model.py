"""The port's decoder against the JAX model on the same weights
(``convert.state_dict_from_jax``), in f32 on the CPU: the uncached
full-sequence logits, and the paged serving path (prefill windows, then
decode steps) against the JAX model driven through its own ``PagedKV``
views.  Tolerance 1e-4 absolute: the same f32 arithmetic in another
order through two layers (logits are O(0.1))."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core import tape as _tape
from paddle_tpu.ops.rope import rope_arrays
from paddle_tpu.serving.kv_cache import PagedKV as JPagedKV
from paddle_tpu_torch import resolve_device
from paddle_tpu_torch.convert import state_dict_from_jax
from paddle_tpu_torch.models import GPTForCausalLM, LLAMA2_7B
from paddle_tpu_torch.models.llama import LLAMA3_8B
from paddle_tpu_torch.ops.rope import apply_rotary_emb
from paddle_tpu_torch.serving.kv_cache import (
    PagedKV, PagedKVCache, PagedKVPool,
)

from _torch_port_util import (  # noqa: F401
    CONFIGS, TINY, jax_model, jax_state, one_thread, port_model,
    torch_config,
)

ATOL = 1e-4


def _ids(cfg, shape, seed=0):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, shape).astype(np.int64)


@CONFIGS
def test_convert_loads_every_key_with_torch_layout(cfg):
    jm = jax_model(cfg)
    tm = port_model(cfg, jm)
    js = jax_state(jm)
    assert set(tm.state_dict()) == set(js)
    # a non-square projection: paddle [in, out] -> torch [out, in]
    w = tm.model.layers[0].mlp.gate_proj.weight.detach().numpy()
    np.testing.assert_array_equal(w, js["model.layers.0.mlp.gate_proj.weight"].T)
    np.testing.assert_array_equal(
        tm.model.embed_tokens.weight.detach().numpy(),
        js["model.embed_tokens.weight"])


@CONFIGS
def test_full_sequence_logits_match_jax(cfg):
    jm = jax_model(cfg, seed=1)
    tm = port_model(cfg, jm)
    ids = _ids(cfg, (2, 11))
    ref = jm(paddle.to_tensor(ids)).numpy()
    with torch.no_grad():
        out = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def test_tied_embeddings_convert_and_match_jax():
    cfg = dataclasses.replace(TINY, tie_word_embeddings=True)
    jm = jax_model(cfg, seed=2)
    assert "lm_head.weight" not in jax_state(jm)
    tm = port_model(cfg, jm)
    assert tm.lm_head is None
    ids = _ids(cfg, (1, 7), seed=1)
    with torch.no_grad():
        out = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(out, jm(paddle.to_tensor(ids)).numpy(),
                               rtol=0, atol=ATOL)


@CONFIGS
def test_paged_prefill_and_decode_match_jax_paged_path(cfg):
    """Prefill two lanes in two windows (4 then 3 tokens, so the second
    window straddles a block boundary), then decode 5 greedy steps; every
    step's logits match the JAX model driven through its PagedKV views
    over the same tables."""
    jm = jax_model(cfg, seed=3)
    tm = port_model(cfg, jm)
    bs, nb, b = 4, 4, 2
    shape = (1 + b * nb, bs, cfg.kv_heads, cfg.head_dim)
    tables = np.array([[3, 8, 1, 6], [2, 5, 7, 4]], np.int32)
    n_layers = cfg.num_hidden_layers
    jviews = [JPagedKV(jnp.zeros(shape), jnp.zeros(shape),
                       jnp.asarray(tables), jnp.zeros(b, jnp.int32))
              for _ in range(n_layers)]
    tviews = [PagedKV(torch.zeros(shape), torch.zeros(shape),
                      torch.from_numpy(tables), torch.zeros(b, dtype=torch.int32))
              for _ in range(n_layers)]
    windows = [_ids(cfg, (b, 4), seed=4), _ids(cfg, (b, 3), seed=5)]
    for step in range(7):
        ids = windows[step] if step < 2 else nxt
        with _tape.no_grad():
            h, jviews = jm.model(paddle.to_tensor(ids), caches=jviews)
            ref = jm._logits(h).numpy()
        with torch.no_grad():
            h, tviews = tm.model(torch.from_numpy(ids), caches=tviews)
            out = tm._logits(h).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)
        assert tviews[0].pos.tolist() == np.asarray(jviews[0].pos).tolist()
        nxt = ref[:, -1:].argmax(-1).astype(np.int64)
    # the caches hold the same keys in every table-mapped block
    np.testing.assert_allclose(tviews[1].k.numpy()[1:],
                               np.asarray(jviews[1].k)[1:], rtol=0, atol=ATOL)


@pytest.mark.parametrize("base", [10000.0, 500000.0])
def test_rope_matches_jax(base):
    r = np.random.RandomState(0)
    x = r.randn(2, 5, 3, 16).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    ref = np.asarray(rope_arrays(jnp.asarray(x), position_ids=jnp.asarray(pos),
                                 base=base))
    out = apply_rotary_emb(torch.from_numpy(x), torch.from_numpy(pos), base)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_convert_refuses_a_mismatched_state():
    jm = jax_model(TINY)
    js = jax_state(jm)
    cfg = torch_config(TINY)
    bad = dict(js)
    del bad["model.norm.weight"]
    with pytest.raises(KeyError, match="missing"):
        state_dict_from_jax(bad, cfg, device="cpu")
    bad = dict(js)
    bad["lm_head.weight"] = bad["lm_head.weight"][:, :10]
    with pytest.raises(ValueError, match="lm_head.weight"):
        state_dict_from_jax(bad, cfg, device="cpu")


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        GPTForCausalLM(torch_config(TINY))
    with pytest.raises(RuntimeError, match="CUDA"):
        state_dict_from_jax(jax_state(jax_model(TINY)), torch_config(TINY))
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_kv_pool_and_cache_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedKVPool(1, 4, 4, 2, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedKVCache(1, 2, 16, 4, 2, 8)
    # the block count is checked before the device
    with pytest.raises(ValueError, match=">= 2 blocks"):
        PagedKVPool(1, 1, 4, 2, 8)
    pool = PagedKVPool(1, 4, 4, 2, 8, device="cpu")
    assert pool.k[0].device.type == "cpu"


def test_presets_keep_the_published_widths():
    assert (LLAMA2_7B.hidden_size, LLAMA2_7B.num_hidden_layers,
            LLAMA2_7B.num_attention_heads, LLAMA2_7B.head_dim,
            LLAMA2_7B.vocab_size) == (4096, 32, 32, 128, 32000)
    assert (LLAMA3_8B.kv_heads, LLAMA3_8B.head_dim,
            LLAMA3_8B.rope_theta) == (8, 128, 500000.0)
