from .gpt import (
    ERNIE_7B, LLAMA2_13B, GPTAttention, GPTConfig, GPTDecoderLayer,
    GPTForCausalLM, GPTMLP, GPTModel, RMSNorm,
)
from .llama import LLAMA2_7B, LLAMA3_8B, LlamaConfig, LlamaForCausalLM
from .unet import UNet2DConditionModel, UNetConfig, unet_loss

__all__ = [
    "GPTConfig", "GPTAttention", "GPTMLP", "GPTDecoderLayer", "GPTModel",
    "GPTForCausalLM", "RMSNorm", "ERNIE_7B", "LLAMA2_7B", "LLAMA2_13B",
    "LLAMA3_8B", "LlamaConfig", "LlamaForCausalLM", "UNetConfig",
    "UNet2DConditionModel", "unet_loss",
]
