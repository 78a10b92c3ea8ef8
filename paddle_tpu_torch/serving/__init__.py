"""Continuous-batching LLM serving on the paged KV pool, grammar-
constrained decoding (``serving.structured``), the host KV tier, and
the HTTP/SSE gateway over engine replicas (``serving.gateway``)."""

from ..ops import kernel_launches, reset_kernel_launches
from .drafter import draft_tokens, forced_chain
from .engine import Engine, EngineConfig
from .faults import (FaultInjector, FaultPlan, FaultSpec, RetryPolicy,
                     TransientSubmitError, WorkerCrash, WorkerDeadError)
from .gateway import (EngineWorker, FleetSupervisor, Gateway,
                      GatewayConfig, PrefixAffinityRouter, TenantQuotas)
from .kv_cache import PagedKV, PagedKVCache, PagedKVPool, paged_write
from .kv_host_tier import HostKVTier
from .paged_attention import paged_attention, paged_attention_plain
from .prefix_cache import PrefixCache, PrefixLease
from .sampling import SamplingParams, request_seed, sample_batch
from .scheduler import Request, Scheduler
from .structured import (GrammarError, GrammarSlab, GrammarSpec, TokenDFA,
                         compile_grammar, compile_regex, schema_to_regex)

__all__ = [
    "Engine", "EngineConfig", "kernel_launches", "reset_kernel_launches",
    "PagedKV", "PagedKVCache", "PagedKVPool", "paged_write",
    "paged_attention", "paged_attention_plain", "PrefixCache",
    "PrefixLease", "SamplingParams", "request_seed", "sample_batch",
    "Request", "Scheduler", "draft_tokens", "forced_chain", "HostKVTier",
    "GrammarError", "GrammarSlab", "GrammarSpec", "TokenDFA",
    "compile_grammar", "compile_regex", "schema_to_regex",
    "Gateway", "GatewayConfig", "EngineWorker", "PrefixAffinityRouter",
    "TenantQuotas", "FleetSupervisor",
    "FaultPlan", "FaultSpec", "FaultInjector", "RetryPolicy",
    "WorkerCrash", "TransientSubmitError", "WorkerDeadError",
]
