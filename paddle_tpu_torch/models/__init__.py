from .bert import (
    BERT_BASE, BERT_LARGE, BertConfig, BertEmbeddings, BertForMaskedLM,
    BertForSequenceClassification, BertLMPredictionHead, BertModel,
    BertPooler,
)
from .gpt import (
    ERNIE_7B, LLAMA2_13B, GPTAttention, GPTConfig, GPTDecoderLayer,
    GPTForCausalLM, GPTMLP, GPTModel, RMSNorm,
)
from .llama import LLAMA2_7B, LLAMA3_8B, LlamaConfig, LlamaForCausalLM
from .unet import UNet2DConditionModel, UNetConfig, unet_loss

__all__ = [
    "BertConfig", "BERT_BASE", "BERT_LARGE", "BertEmbeddings", "BertPooler",
    "BertModel", "BertLMPredictionHead", "BertForMaskedLM",
    "BertForSequenceClassification",
    "GPTConfig", "GPTAttention", "GPTMLP", "GPTDecoderLayer", "GPTModel",
    "GPTForCausalLM", "RMSNorm", "ERNIE_7B", "LLAMA2_7B", "LLAMA2_13B",
    "LLAMA3_8B", "LlamaConfig", "LlamaForCausalLM", "UNetConfig",
    "UNet2DConditionModel", "unet_loss",
]
