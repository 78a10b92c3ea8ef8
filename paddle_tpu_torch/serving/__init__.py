"""Continuous-batching LLM serving on the paged KV pool, and the HTTP/SSE
gateway over engine replicas (``serving.gateway``)."""

from ..ops import kernel_launches, reset_kernel_launches
from .drafter import draft_tokens
from .engine import Engine, EngineConfig
from .faults import (FaultInjector, FaultPlan, FaultSpec, RetryPolicy,
                     TransientSubmitError, WorkerCrash, WorkerDeadError)
from .gateway import (EngineWorker, FleetSupervisor, Gateway,
                      GatewayConfig, PrefixAffinityRouter, TenantQuotas)
from .kv_cache import PagedKV, PagedKVCache, PagedKVPool, paged_write
from .paged_attention import paged_attention, paged_attention_plain
from .prefix_cache import PrefixCache, PrefixLease
from .sampling import SamplingParams, request_seed, sample_batch
from .scheduler import Request, Scheduler

__all__ = [
    "Engine", "EngineConfig", "kernel_launches", "reset_kernel_launches",
    "PagedKV", "PagedKVCache", "PagedKVPool", "paged_write",
    "paged_attention", "paged_attention_plain", "PrefixCache",
    "PrefixLease", "SamplingParams", "request_seed", "sample_batch",
    "Request", "Scheduler", "draft_tokens",
    "Gateway", "GatewayConfig", "EngineWorker", "PrefixAffinityRouter",
    "TenantQuotas", "FleetSupervisor",
    "FaultPlan", "FaultSpec", "FaultInjector", "RetryPolicy",
    "WorkerCrash", "TransientSubmitError", "WorkerDeadError",
]
