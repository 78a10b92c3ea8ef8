"""Continuous-batching LLM serving on the paged KV pool."""

from ..ops import kernel_launches, reset_kernel_launches
from .engine import Engine, EngineConfig
from .kv_cache import PagedKV, PagedKVCache, PagedKVPool, paged_write
from .paged_attention import paged_attention, paged_attention_plain
from .sampling import SamplingParams, request_seed, sample_batch
from .scheduler import Request, Scheduler

__all__ = [
    "Engine", "EngineConfig", "kernel_launches", "reset_kernel_launches",
    "PagedKV", "PagedKVCache", "PagedKVPool", "paged_write",
    "paged_attention", "paged_attention_plain", "SamplingParams",
    "request_seed", "sample_batch", "Request", "Scheduler",
]
