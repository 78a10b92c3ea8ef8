"""Shared helpers of the tests that hold the PyTorch port
(paddle_tpu_torch) against the JAX package on the CPU."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig, GPTForCausalLM

from paddle_tpu_torch.convert import state_dict_from_jax
from paddle_tpu_torch.models import GPTConfig as TGPTConfig
from paddle_tpu_torch.models import GPTForCausalLM as TGPTForCausalLM

# the tiny configs of tests/test_serving.py
TINY = GPTConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                 num_hidden_layers=2, num_attention_heads=4,
                 max_position_embeddings=64)
TINY_GQA = GPTConfig(vocab_size=96, hidden_size=64, intermediate_size=128,
                     num_hidden_layers=2, num_attention_heads=8,
                     num_key_value_heads=2, max_position_embeddings=64)
CONFIGS = pytest.mark.parametrize("cfg", [TINY, TINY_GQA],
                                  ids=["mha", "gqa"])


@pytest.fixture(autouse=True)
def one_thread():
    """Run each port test on one torch thread (the suite runs in several
    worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_compile_cache(tmp_path_factory):
    """JAX's persistent compilation cache in a temporary directory for
    the module: every JAX engine builds its own ``jax.jit`` programs, so
    engines of one configuration compile the same XLA programs again;
    with the cache each distinct program compiles once per module.  The
    cache is turned off again afterwards."""
    import jax
    from jax._src import compilation_cache as cc

    opts = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs",
            "jax_persistent_cache_min_entry_size_bytes")
    saved = {k: getattr(jax.config, k) for k in opts}
    jax.config.update(opts[0], str(tmp_path_factory.mktemp("jax_cache")))
    jax.config.update(opts[1], 0)
    jax.config.update(opts[2], 0)
    cc.reset_cache()
    yield
    for k, v in saved.items():
        jax.config.update(k, v)
    cc.reset_cache()


def torch_config(cfg):
    """The port's config with the same fields as a JAX GPTConfig."""
    return TGPTConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads,
        num_key_value_heads=cfg.num_key_value_heads,
        max_position_embeddings=cfg.max_position_embeddings,
        rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta,
        initializer_range=cfg.initializer_range,
        tie_word_embeddings=cfg.tie_word_embeddings,
        fused_lm_loss=cfg.fused_lm_loss)


def jax_model(cfg, seed=0):
    paddle.seed(seed)
    m = GPTForCausalLM(cfg)
    m.eval()
    return m


def jax_state(m):
    return {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}


def port_model(cfg, jm):
    """The port's model on the CPU, loaded with the JAX model's weights."""
    tcfg = torch_config(cfg)
    tm = TGPTForCausalLM(tcfg, device="cpu")
    tm.load_state_dict(state_dict_from_jax(jax_state(jm), tcfg,
                                           device="cpu"))
    return tm.eval()
