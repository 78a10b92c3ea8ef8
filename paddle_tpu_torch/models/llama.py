"""LLaMA naming and presets over the shared decoder in ``gpt.py`` (as
``paddle_tpu/models/llama.py``)."""

from .gpt import (
    LLAMA2_13B,
    GPTConfig as LlamaConfig,
    GPTAttention as LlamaAttention,
    GPTMLP as LlamaMLP,
    GPTDecoderLayer as LlamaDecoderLayer,
    GPTModel as LlamaModel,
    GPTForCausalLM as LlamaForCausalLM,
)

LLAMA2_7B = LlamaConfig(
    vocab_size=32000, hidden_size=4096, intermediate_size=11008,
    num_hidden_layers=32, num_attention_heads=32,
    max_position_embeddings=4096,
)
# LLaMA-3-style GQA preset (8 kv heads)
LLAMA3_8B = LlamaConfig(
    vocab_size=128256, hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    max_position_embeddings=8192, rope_theta=500000.0,
)

__all__ = [
    "LlamaConfig", "LlamaAttention", "LlamaMLP", "LlamaDecoderLayer",
    "LlamaModel", "LlamaForCausalLM",
    "LLAMA2_7B", "LLAMA2_13B", "LLAMA3_8B",
]
