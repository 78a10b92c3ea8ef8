from .gpt import (
    ERNIE_7B, LLAMA2_13B, GPTAttention, GPTConfig, GPTDecoderLayer,
    GPTForCausalLM, GPTMLP, GPTModel, RMSNorm,
)
from .llama import LLAMA2_7B, LLAMA3_8B, LlamaConfig, LlamaForCausalLM

__all__ = [
    "GPTConfig", "GPTAttention", "GPTMLP", "GPTDecoderLayer", "GPTModel",
    "GPTForCausalLM", "RMSNorm", "ERNIE_7B", "LLAMA2_7B", "LLAMA2_13B",
    "LLAMA3_8B", "LlamaConfig", "LlamaForCausalLM",
]
