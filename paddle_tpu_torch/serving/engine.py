"""Continuous-batching serving engine over the paged KV pool (the core of
``paddle_tpu/serving/engine.py``).

Main path: :meth:`Engine.submit` queues a request; :meth:`Engine.step`
runs :meth:`Engine.admit` (co-bucketed batched prefill over the paged
pool, which samples each request's first token) and then one horizon of
decode steps over every slot; :meth:`_harvest` replays the harvested
tokens into the requests and :meth:`_retire` releases the finished
ones.  Every prefill and every decode forward runs the model's paged
attention path, so each layer launches the ragged paged-attention kernel
once and the RMSNorm kernel twice (plus the final norm) on a CUDA
device.

Kept from the JAX engine: power-of-two prefill length buckets and lane
buckets, padding lanes with all-zero table rows (their writes land in
scratch block 0), the first token taken from position ``lengths - 1``,
the horizon's in-loop freezing of lanes that reach EOS or their budget
(their later tokens harvest as -1), the adaptive horizon, and the
auto-sized pool in which no request can starve (a full row per slot
plus the prefix store's headroom).  The JAX horizon ``lax.scan`` is a
Python loop of ``h`` steps here; device state stays on the device
between horizons and the host syncs once per horizon.

Also kept, as the JAX engine has them on by default:

* **Prefix reuse** (``prefix_block_size``, ``prefix_cache_bytes``): a
  radix store (:mod:`.prefix_cache`) over full blocks of admitted
  prompts holds refcounted blocks of the same pool.  Admission leases
  the matched blocks straight into the slot's table, copies a partial
  tail match into the slot's first private block (copy-on-write, before
  the forward), and prefills only the suffix, at ``pos`` = the hit
  length.  After the forward the store adopts the prompt's new full
  blocks.
* **Chunked prefill** (``prefill_chunk_tokens``): a suffix longer than
  the chunk prefills one chunk per step boundary, a decode horizon
  between consecutive chunks; the lane holds its slot, decode-inactive,
  until its final chunk samples the first token.  Every chunk boundary
  adopts the completed blocks, so it doubles as a resume point.
* **Preemption**: a decode step or a chunk that finds the pool dry
  reclaims unpinned prefix blocks, then preempts the lowest-priority,
  youngest other request (:meth:`Engine.preempt`, also public).  It
  requeues at the front with its tokens; re-admission re-prefills
  prompt + all but the last generated token and must re-sample that
  last token exactly, or raises.  That check holds on the card because
  the serving forward's rows do not depend on the window (the row-tiled
  products of ``models.gpt.tiled_linear`` and the row-invariant paged
  kernel).
* **Speculative decoding** (``spec_k``, ``spec_adaptive``,
  ``spec_ngram``, ``spec_accept_floor``): with K > 0 each decode step is
  a window of W = K + 1 positions per lane: the n-gram drafter
  (:mod:`.drafter`) proposes K tokens from the lane's device history
  buffer, ONE paged forward scores all W positions, position j is
  sampled as token ``count + j`` of its request (:func:`.sampling.
  sample_window`'s rule), and the lane emits the longest accepted draft
  prefix plus one, cut at EOS or its budget.  The streams equal K = 0
  bitwise.  A lane's acceptance EMA gates its drafting; with every
  running lane gated off the dispatch itself runs K = 0.  Rejected
  positions write KV at ``pos + n_emit .. pos + K``, in the lane's own
  decode blocks (or scratch), which the next step overwrites before
  anything reads them.
* **int8 serving knobs**: ``kv_cache_dtype="int8"`` stores the pool in
  int8 with one f32 scale per token (quantized at append,
  ``kv_cache.paged_write_quant``; the paged kernel's int8-pool variant
  reads it); ``weight_dtype="int8"`` quantizes every ``nn.Linear`` per
  output channel (:mod:`..quantization.serving`) and the serving forward
  rebuilds each weight before its product.  Within one such config every
  bitwise guarantee above still holds.

* **Degradation ladder** (``degrade_enabled``, ``degrade_pool_ratio``,
  ``degrade_patience``, ``degrade_recover_patience``): an unhealthy SLO
  tracker (``slo_burn``) or pool occupancy at or above the ratio for
  ``degrade_patience`` consecutive steps climbs one level
  (:data:`DEGRADE_LEVELS`): 1 turns speculative decoding off, 2 pins the
  decode horizon to 1, 3 sheds queued requests
  (lowest priority, newest first, never a resumed one) down to
  ``num_slots`` through :meth:`Engine.abort`;
  ``degrade_recover_patience`` calm steps step back down one level.
  :meth:`Engine.abort` is public, as the JAX engine's: a queued request
  leaves the queue, a running one gets the preemption teardown without
  the requeue.

* **Request lifecycle** (the gateway's engine surface):
  :meth:`Engine.submit` takes ``deadline_s`` (a request still queued
  when it passes is aborted at the top of the next admission pass,
  :meth:`_expire_deadlines`), ``tenant`` (billed in
  :meth:`Engine.tenant_ledger` and ``stats()["tenants"]``) and
  ``resume_ids`` (failover: the tokens another replica already streamed;
  admission takes the preemption-resume path and checks the re-sampled
  boundary token bit for bit).  :meth:`Engine.drain` refuses new work,
  aborts the queue, finishes the running lanes and asserts that no pool
  block stays referenced; :meth:`Engine.close` stops the telemetry
  server and unregisters the counter provider.
* **Observability**: the ``serving.*`` metric families (labelled
  ``engine=<name>``, the name JAX's ``_profiler_name``), a
  :class:`~..observability.tracing.RequestTrace` on every request
  (``request_tracing``), the spans ``serving.prefill_pass`` and
  ``serving.decode_step`` (``torch.profiler`` ranges), an
  :class:`~..observability.slo.SLOTracker` from the ``slo_*`` knobs
  (``engine.slo``; its burn is the ladder's first signal) and a
  :class:`~..observability.server.TelemetryServer` on
  ``telemetry_port``.  Every family and counter is a host number: an
  HTTP thread reading them touches no device tensor.
* **Fault injection** (:meth:`Engine.install_faults`): the
  ``engine.admit`` site; a ``pool_exhausted`` fault defers the whole
  admission pass, as a dry pool does.
* **Structured generation** (``grammar_max_states``, ``grammar_vocab``,
  ``grammar_forced_drafting``, ``grammar_cache_keep``): ``submit(
  grammar=...)`` compiles a regex or JSON schema to a token DFA
  (:mod:`.structured`, cached per (grammar, EOS), LRU-bounded once
  retired) and installs it, refcounted, into a fixed-capacity slab
  whose row 0 is the accept-all state free lanes ride.  Each lane's DFA
  state lives in the device state; every sampled position is masked to
  its state's legal tokens (the first token at prefill; verify-window
  position j by the state reached by walking ``drafts[:j]``), the state
  advances by emitted tokens only, and with K > 0 the grammar's forced
  chains overlay the n-gram drafts.  Admission after preemption and
  ``resume_ids`` walk the grammar over the tokens already emitted.
  With ``grammar_max_states=0`` none of this runs.
* **Host KV tier** (``kv_host_bytes``, ``kv_swap_policy``): a pinned
  host arena (:mod:`.kv_host_tier`) under the pool.  Evicted prefix
  blocks demote into it (the store's spill hooks), a preempted lane's
  block chain is saved into it, and admission swaps matching host
  blocks back into the radix store with one batched upload a pass, so
  the resume is an ordinary prefix hit.  ``auto`` swaps when the
  upload (bytes over the measured host->device rate) beats re-prefill
  at this engine's measured prefill rate.
* **Device-memory ledger** (``engine.ledger``, ``stats()["memory"]``):
  the pool, the weights and the device decode state reconciled against
  the allocator's live bytes, the host arena beside them.

Left out of the JAX engine's ``serving.*`` families: the shared
``jit.*`` compile families and ``kv_swaps_averted_flops`` (both read
program cards).

Not ported yet: program cards (and with them ``stats()["cost"]``).
"""

from __future__ import annotations

import time
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..observability import events as _obs_events
from ..observability import memory as _obs_memory
from ..observability import metrics as _obs_metrics
from ..observability import tracing as _obs_tracing
from ..observability.server import TelemetryServer
from ..observability.slo import SLOTracker
from ..observability.span import span as _obs_span
from ..ops import kernel_launches
from ..quantization import quantize_for_serving
from .drafter import draft_tokens, forced_chain
from .faults import (DEGRADE_LEVELS, FAULT_POOL_EXHAUSTED,
                     SITE_ENGINE_ADMIT, _SRV_DEGRADATION, _SRV_SHED)
from .kv_cache import PagedKVCache, token_bytes
from .kv_host_tier import HostKVTier
from .paged_attention import check_kernel_geometry
from .prefix_cache import PrefixCache
from .sampling import (
    SamplingParams, _unpack_mask, apply_mask, draw_uniforms, row_params,
    sample_batch, sample_rows, sampled_rows,
)
from .scheduler import FINISH_ABORT, FINISHED, RUNNING, WAITING, Scheduler
from .structured.grammar import GrammarSlab, as_grammar_spec, compile_grammar

# typed registry families the engine publishes into, labelled by engine
# instance so two engines in one process stay distinguishable (names and
# help strings are the JAX engine's)
_SRV_TOKENS = _obs_metrics.counter(
    "serving.tokens_generated", "tokens sampled across prefill+decode")
_SRV_REQS = _obs_metrics.counter(
    "serving.requests_finished", "requests retired (EOS or max-tokens)")
_SRV_DECODE_STEPS = _obs_metrics.counter(
    "serving.decode_steps", "fused decode steps executed")
_SRV_PREFILL = _obs_metrics.counter(
    "serving.prefill_calls", "batched prefill dispatches")
_SRV_PREFILL_REQS = _obs_metrics.counter(
    "serving.prefill_requests", "requests prefilled (across batches)")
_SRV_PREFIX_HIT = _obs_metrics.counter(
    "serving.prefix_hit_tokens",
    "prompt tokens served from the prefix KV cache instead of recomputed")
_SRV_PREFIX_RATIO = _obs_metrics.gauge(
    "serving.prefix_hit_ratio",
    "cumulative prefix-cache hit tokens / admitted prompt tokens")
_SRV_PREFILL_BATCH = _obs_metrics.histogram(
    "serving.prefill_batch_size", "requests co-prefilled per dispatch",
    buckets=(1, 2, 4, 8, 16, 32))
_SRV_WASTED = _obs_metrics.counter(
    "serving.wasted_lane_tokens",
    "masked tokens scanned for lanes that retired mid-horizon")
_SRV_QUEUE = _obs_metrics.gauge(
    "serving.queue_depth", "requests waiting for a slot")
_SRV_ACTIVE = _obs_metrics.gauge(
    "serving.active_slots", "slots currently decoding")
_SRV_UTIL = _obs_metrics.gauge(
    "serving.slot_utilization", "mean active/total slots over decode steps")
_SRV_TPS = _obs_metrics.gauge(
    "serving.tokens_per_s", "generated tokens per engine-busy second")
_SRV_TTFT = _obs_metrics.histogram(
    "serving.ttft_seconds", "submit-to-first-token wall seconds")
_SRV_STEP = _obs_metrics.histogram(
    "serving.step_seconds", "wall seconds per engine step()")
_SRV_HORIZON = _obs_metrics.histogram(
    "serving.horizon", "fused decode steps per compiled horizon dispatch",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128))
_SRV_KV_BLOCKS = _obs_metrics.gauge(
    "serving.kv_blocks_in_use",
    "unified-pool KV blocks currently referenced (tables + prefix store)")
_SRV_KV_BYTES = _obs_metrics.counter(
    "serving.kv_bytes_read",
    "KV bytes gathered by decode attention (table-mapped blocks only)")
_SRV_PREEMPTIONS = _obs_metrics.counter(
    "serving.preemptions",
    "running requests swapped out under KV block pressure")
_SRV_SWAP_OUT_BYTES = _obs_metrics.counter(
    "serving.kv_swap_out_bytes",
    "KV bytes moved device->host by the tiered cache (kind=\"lane\" "
    "preempted-lane chains, kind=\"demote\" evicted prefix blocks)")
_SRV_SWAP_IN_BYTES = _obs_metrics.counter(
    "serving.kv_swap_in_bytes",
    "KV bytes uploaded host->device by tiered-cache swap-ins instead "
    "of being recomputed")
_SRV_HOST_OCC = _obs_metrics.gauge(
    "serving.host_arena_occupancy_ratio",
    "host spill-arena blocks in use / arena capacity")
_SRV_SPEC_ACCEPT = _obs_metrics.histogram(
    "serving.spec_accept_len",
    "tokens emitted per speculative verify window (accepted prefix + 1)",
    buckets=(1, 2, 3, 4, 5, 6, 8, 12, 17))
_SRV_SPEC_DRAFTED = _obs_metrics.counter(
    "serving.spec_draft_tokens",
    "draft tokens proposed to the verify forward")
_SRV_SPEC_ACCEPTED = _obs_metrics.counter(
    "serving.spec_accepted_tokens",
    "draft tokens whose sampled verification matched")
_SRV_SPEC_RATE = _obs_metrics.gauge(
    "serving.spec_accept_rate",
    "cumulative accepted / drafted speculative tokens")
_SRV_SPEC_EMA = _obs_metrics.gauge(
    "serving.spec_lane_accept_ema",
    "per-lane speculative acceptance EMA driving the adaptive gates")
_SRV_SPEC_FORCED = _obs_metrics.counter(
    "serving.spec_forced_tokens",
    "accepted draft tokens proposed by the grammar's forced-token "
    "chains (a subset of serving.spec_accepted_tokens)")
_SRV_GRAMMAR_MASKED = _obs_metrics.histogram(
    "serving.grammar_masked_fraction",
    "fraction of the vocab masked per constrained emitted token",
    buckets=(0.5, 0.9, 0.99, 0.999, 0.9999, 1.0))
_SRV_KV_OCC = _obs_metrics.gauge(
    "serving.kv_pool_occupancy_ratio",
    "unified KV pool blocks in use / pool capacity")
_SRV_BUCKETS = _obs_metrics.gauge(
    "serving.decode_bucket_count",
    "distinct compiled decode programs ((horizon, nb, K) triples)")
_SRV_ABORTS = _obs_metrics.counter(
    "serving.requests_aborted", "requests cancelled by the caller")
_SRV_DEADLINE = _obs_metrics.counter(
    "serving.deadline_expired",
    "queued requests aborted because their admission deadline passed "
    "(a subset of serving.requests_aborted)")
_SRV_QUEUE_WAIT = _obs_metrics.histogram(
    "serving.queue_wait_seconds",
    "submit-to-admission wall seconds, observed when a request claims "
    "a slot (re-admissions after preemption observe again)")
_SRV_PREFILL_CHUNKS = _obs_metrics.histogram(
    "serving.prefill_chunks",
    "chunk dispatches per chunked-prefill request, observed when its "
    "final chunk samples the first token",
    buckets=(1, 2, 4, 8, 16, 32, 64))
_SRV_PREFILL_INTERFERE = _obs_metrics.counter(
    "serving.prefill_interference_seconds",
    "wall seconds decode horizons were delayed by interleaved prefill "
    "chunk dispatches (chunk dispatches issued while decode lanes were "
    "active)")


@dataclass
class EngineConfig:
    num_slots: int = 8
    max_seq_len: int = 256
    #: smallest prefill bucket; prompts pad up to the next power of two
    min_prefill_bucket: int = 8
    #: chunked prefill: a suffix longer than this many tokens prefills
    #: one chunk per step boundary, interleaved with decode horizons.
    #: Normalized to a power of two in [min_prefill_bucket, max_seq_len];
    #: 0 disables (whole-prompt prefill)
    prefill_chunk_tokens: int = 0
    #: largest number of decode steps one horizon runs (power of two)
    max_horizon: int = 8
    #: pool block size in tokens, which is also the prefix cache's block
    #: size (0: blocks of 16 and no prefix cache)
    prefix_block_size: int = 16
    #: device-byte budget of the prefix store: it holds at most
    #: budget // bytes_per_block pool blocks, LRU-evicted
    prefix_cache_bytes: int = 8 << 20
    #: admission reorder window: a queued request is overtaken by at most
    #: this many later-submitted same-bucket requests
    reorder_window: int = 8
    #: total pool blocks incl. scratch block 0; 0 = auto: every slot can
    #: grow to a full row, plus the prefix store's headroom.  A smaller
    #: value oversubscribes the pool: admission defers, decode preempts
    kv_pool_blocks: int = 0
    #: kv cache dtype; None = the model's parameter dtype
    cache_dtype: object = None
    #: speculative decoding: draft tokens per lane per decode step
    #: (0 = plain decode).  K > 0 self-drafts K tokens from the lane's
    #: prompt+output history, verifies all K+1 positions in one forward
    #: and emits the longest matching prefix plus one; greedy and seeded
    #: streams stay bitwise equal to spec_k=0
    spec_k: int = 0
    #: shrink the dispatch to K=0 when no running lane's acceptance EMA
    #: clears spec_accept_floor; below-floor lanes also draft nothing
    #: inside a K-wide dispatch
    spec_adaptive: bool = True
    #: trailing-suffix length the drafter matches on
    spec_ngram: int = 2
    #: per-lane acceptance floor (EMA of accepted/K per verify window)
    spec_accept_floor: float = 0.125
    #: "int8": per-output-channel int8 weights for every nn.Linear,
    #: rebuilt before each product; None keeps the model's weights
    weight_dtype: object = None
    #: "int8": int8 pool with one f32 scale per token; None keeps the
    #: fp pool (cache_dtype)
    kv_cache_dtype: object = None
    #: request-scoped tracing: attach a RequestTrace flight record to
    #: every request at submit, retained by a bounded FlightRecorder
    #: (all live traces + the last ``flight_recorder_capacity``
    #: finished ones) and served at /debug/requests
    request_tracing: bool = True
    flight_recorder_capacity: int = 256
    #: start a TelemetryServer on this port at engine construction,
    #: stopped by close().  0 binds an ephemeral port
    #: (engine.telemetry.port reports it); None disables
    telemetry_port: int | None = None
    #: SLO objectives over observation-count windows: per-request TTFT
    #: seconds, per-request mean TPOT seconds, and abort rate.  None
    #: disables an objective; with all three None no tracker is created
    #: and /readyz is always ready
    slo_ttft_s: float | None = None
    slo_tpot_s: float | None = None
    slo_abort_rate: float | None = None
    #: compliance target shared by the latency objectives and the
    #: burn-rate denominator
    slo_target: float = 0.95
    #: rolling window sizes in OBSERVATIONS (retired requests), not
    #: wall-clock; unhealthy requires both windows burning above 1x
    slo_fast_window: int = 64
    slo_slow_window: int = 640
    #: graceful-degradation ladder: under sustained SLO burn or pool
    #: pressure the engine steps down one level per ``degrade_patience``
    #: consecutive burning steps — 1 disables speculative decoding, 2
    #: shrinks the
    #: decode horizon to 1 (admission at every boundary), 3 sheds
    #: lowest-priority queued requests down to ``num_slots`` queued — and
    #: recovers one level per ``degrade_recover_patience`` consecutive
    #: calm steps (hysteresis: recovery is deliberately slower than
    #: escalation, so the ladder can't flap)
    degrade_enabled: bool = True
    #: pool occupancy fraction that counts as block-pool pressure
    degrade_pool_ratio: float = 0.92
    degrade_patience: int = 4
    degrade_recover_patience: int = 16
    #: tiered KV: host-RAM byte budget of the spill arena under the
    #: pool (pinned when the pool is on the card).  Evicted prefix
    #: blocks demote into it, preempted lanes save their block chain,
    #: and re-admission swaps state back in with one batched upload
    #: instead of re-prefilling.  0 disables the tier
    kv_host_bytes: int = 0
    #: swap-vs-recompute policy: "auto" swaps when the estimated upload
    #: seconds (bytes / measured host->device GB/s) beat the estimated
    #: re-prefill seconds (this engine's measured prefill seconds a
    #: token); "always"/"never" pin the decision
    kv_swap_policy: str = "auto"
    #: structured generation: capacity of the token-DFA slab in states
    #: (row 0 is the accept-all state free lanes ride).  0 disables it
    grammar_max_states: int = 0
    #: the vocabulary as token STRINGS indexed by token id (ids >= len()
    #: are unreachable); required to compile grammars
    grammar_vocab: object = None
    #: propose the grammar's forced-token chains (states with exactly
    #: one legal token) ahead of the n-gram drafter's guesses
    grammar_forced_drafting: bool = True
    #: compiled token DFAs stay cached per (grammar, eos) while a live
    #: request references them, plus up to this many retired ones (LRU)
    grammar_cache_keep: int = 8


@dataclass
class _ChunkProgress:
    """Host ledger of one in-flight chunked prefill: the request holds
    its slot (running, decode-inactive) while chunks of its admission
    tokens dispatch one per step boundary; ``covered`` tokens are
    already written into the lane's blocks."""

    req: object
    slot: int
    lease: object
    toks: list
    covered: int
    chunks: int = 1


class Engine:
    """Submit / step / generate over a ``GPTForCausalLM`` (or
    ``LlamaForCausalLM``) that lives on ``device`` (``cuda`` unless the
    caller passes ``"cpu"``)."""

    _instances = 0

    def __init__(self, model, config=None, device=None,
                 register_profiler=True):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}")
        self.model = model.eval()
        self.config = cfg = config or EngineConfig()
        mc = model.config
        n = cfg.num_slots
        dtype = cfg.cache_dtype or model.dtype
        self._weight_dtype = self._norm_quant_knob(cfg.weight_dtype,
                                                   "weight_dtype")
        self._kv_quant = self._norm_quant_knob(cfg.kv_cache_dtype,
                                               "kv_cache_dtype")
        # weight-only int8: {nn.Linear: QuantizedWeight}, rebuilt before
        # each product of the serving forward (models.gpt.serving_weight)
        qmap = quantize_for_serving(model) if self._weight_dtype else {}
        self._wq = {model.get_submodule(name.rsplit(".", 1)[0]): qw
                    for name, qw in qmap.items()}
        self._weight_bytes = sum(qw.nbytes for qw in qmap.values()) + sum(
            t.numel() * t.element_size()
            for name, t in model.state_dict().items() if name not in qmap)
        self._block_size = max(1, int(cfg.prefix_block_size) or 16)
        if self.device.type == "cuda":
            check_kernel_geometry(self._block_size, mc.num_attention_heads,
                                  mc.kv_heads, mc.head_dim, dtype)
        # ONE pool backs every slot's table AND the prefix store; the
        # auto size adds the store's capacity to a full row per slot,
        # counted at the stored block size (int8 + scales when quantized)
        budget = cfg.prefix_cache_bytes if cfg.prefix_block_size else 0
        bytes_per_block = (2 * mc.num_hidden_layers * self._block_size
                           * token_bytes(mc.kv_heads, mc.head_dim, dtype,
                                         self._kv_quant))
        self.cache = PagedKVCache(
            num_layers=mc.num_hidden_layers, num_slots=n,
            max_seq_len=cfg.max_seq_len, block_size=self._block_size,
            kv_heads=mc.kv_heads, head_dim=mc.head_dim, dtype=dtype,
            num_blocks=int(cfg.kv_pool_blocks),
            extra_blocks=int(budget) // bytes_per_block, device=self.device,
            quant_dtype=self._kv_quant)
        self.pool = self.cache.pool
        self._max_blocks = self.cache.max_blocks_per_slot
        self.scheduler = Scheduler(n, reorder_window=cfg.reorder_window)
        self.prefix = PrefixCache(
            num_layers=mc.num_hidden_layers, block_size=self._block_size,
            kv_heads=mc.kv_heads, head_dim=mc.head_dim, dtype=dtype,
            budget_bytes=budget, pool=self.pool,
            bytes_per_block=self.pool.bytes_per_block)
        self._leases = {}            # request_id -> PrefixLease

        # tiered KV: the host spill arena under the pool.  Prefix
        # eviction demotes into it (the spill hooks run while the
        # victim's pool block is still live), preemption saves lane
        # images, and admission promotes matching host blocks back into
        # the radix store (_swap_in), so a swap-in IS a prefix hit
        policy = str(cfg.kv_swap_policy)
        if policy not in ("auto", "always", "never"):
            raise ValueError(
                f"unsupported kv_swap_policy {policy!r} "
                "(supported: 'auto', 'always', 'never')")
        self._swap_policy = policy
        host_budget = int(cfg.kv_host_bytes or 0)
        if host_budget < 0:
            raise ValueError(
                f"kv_host_bytes must be >= 0, got {host_budget}")
        self.host_tier = None
        if host_budget:
            self.host_tier = HostKVTier(
                num_layers=mc.num_hidden_layers,
                block_size=self._block_size, kv_heads=mc.kv_heads,
                head_dim=mc.head_dim, store_dtype=self.pool.store_dtype,
                budget_bytes=host_budget,
                bytes_per_block=self.pool.bytes_per_block,
                quantized=bool(self._kv_quant),
                pin_memory=self.device.type == "cuda")
            self.prefix.spill = self._weak_call(self._demote_block)
            self.prefix.spill_batch = self._weak_call(self._demote_blocks)
        self._swap_ins = 0               # lane/prefix swap-in passes
        self._swap_outs = 0              # lane images saved at preempt
        self._swap_in_blocks = 0
        self._swap_out_blocks = 0
        self._swap_in_bytes = 0
        self._swap_out_bytes = 0         # lane-save bytes
        self._demote_bytes = 0           # prefix-demotion bytes
        self._swaps_averted_tokens = 0
        self._swap_uploads = 0           # batched host->device copies
        self._swap_decisions = {"swap": 0, "recompute": 0}
        # measured input of the "auto" policy: prefill seconds (up to the
        # host sync of the sampled tokens) over the tokens dispatched
        self._prefill_dispatch_s = 0.0
        self._prefill_tokens_dispatched = 0

        ct = int(cfg.prefill_chunk_tokens or 0)
        if ct < 0:
            raise ValueError(f"prefill_chunk_tokens must be >= 0, got {ct}")
        if ct:
            ct = min(self._pow2_ceil(max(ct, cfg.min_prefill_bucket)),
                     cfg.max_seq_len)
        self._chunk_tokens = ct
        self._chunking = {}          # request_id -> _ChunkProgress

        # host mirrors of the per-slot decode state; the device copies
        # are rebuilt from them only when admission dirties them
        self._tokens = np.zeros(n, np.int64)        # last token per slot
        self._pos = np.zeros(n, np.int32)           # row length per slot
        self._seeds = np.zeros(n, np.int64)
        self._counts = np.zeros(n, np.int64)        # tokens sampled so far
        self._temps = np.zeros(n, np.float32)
        self._top_ks = np.zeros(n, np.int64)
        self._top_ps = np.ones(n, np.float32)
        self._eos_ids = np.full(n, -1, np.int64)    # -1 = no EOS token
        self._limits = np.zeros(n, np.int64)        # max_new_tokens
        self._active = np.zeros(n, bool)
        # speculative decoding: the drafter's corpus per slot (prompt +
        # emitted tokens; column max_seq_len is the drop target of
        # unemitted window positions), the acceptance EMA and gate
        self._spec_k = max(0, int(cfg.spec_k))
        self._hist = (np.zeros((n, cfg.max_seq_len + 1), np.int64)
                      if self._spec_k else None)
        self._spec_ema = np.ones(n, np.float32)
        self._spec_gates = np.ones(n, bool)
        # structured generation: per-lane DFA state (0 = the accept-all
        # row free lanes ride) and the host master of the token-DFA
        # slab; the device copies of its tables are re-uploaded only
        # when an install or release dirties them
        cap = int(cfg.grammar_max_states or 0)
        if cap < 0:
            raise ValueError(f"grammar_max_states must be >= 0, got {cap}")
        self._structured = cap > 0
        self._grammar_slab = (GrammarSlab(cap, mc.vocab_size)
                              if self._structured else None)
        self._dfa_state = np.zeros(n, np.int64)
        self._d_dfa = None           # (next, mask as int32, forced)
        self._grammar_cache = {}     # (spec key, eos id) -> TokenDFA;
                                     # pinned while slab-installed, then
                                     # LRU-bounded (grammar_cache_keep)
        self._grammar_keys = {}      # request_id -> slab segment key
        self._grammar_cache_hits = 0
        self._grammar_cache_misses = 0
        self._spec_forced_tokens = 0
        self._spec_forced_drafted = 0  # forced drafts that could emit
        self._masked_sum = 0.0       # masked vocab fraction, summed over
        self._masked_n = 0           # constrained emitted tokens
        self._state_dirty = True
        # (tokens, pos, counts, active, eos, limits, hist, gates, dfa)
        self._d_state = None
        self._d_tables = None
        self._d_tables_nb = -1

        self._grow = 1           # adaptive-horizon growth state
        self._prefill_calls = 0
        self._prefill_requests = 0
        self._prompt_tokens = 0
        self._prefix_hit_tokens = 0
        self._cow_copies = 0
        self._preemptions = 0
        self._chunk_dispatches = 0
        self._chunked_requests = 0
        self._chunk_count_total = 0
        self._prefill_s = 0.0
        self._interference_s = 0.0
        self._prefill_buckets = set()   # (lanes, bucket) per dispatch
        self._decode_steps = 0
        self._decode_horizons = 0
        self._decode_tokens = 0
        self._decode_s = 0.0
        self._decode_buckets = set()    # (horizon, nb, K) per dispatch
        self._spec_draft_tokens = 0
        self._spec_accepted_tokens = 0
        self._spec_windows = 0          # verify windows of drafting lanes
        self._spec_accept_hist = {}     # tokens emitted per window -> n
        self._tokens_generated = 0
        self._finished = 0
        self._aborted = 0
        self._ttft_sum = 0.0
        # degradation ladder
        self._degrade_level = 0
        self._burn_streak = 0            # consecutive burning steps
        self._calm_streak = 0            # consecutive calm steps
        self._degrade_transitions = 0
        self._degrade_history = []       # last 64 transitions
        self._degrade_sheds = 0
        # request lifecycle, fault injection, and the counters of JAX's
        # counters() the port had no use for before
        self._draining = False
        self._deadline_expired = 0
        self._tenants = {}               # tenant -> ledger counts
        self.faults = None               # FaultInjector or None
        self._fault_scope = ""
        self._admit_deferred = False     # injected pool-exhaustion pass
        self._busy_s = 0.0
        self._slot_busy_integral = 0.0   # sum over steps of used/num
        self._wasted_lane_tokens = 0
        self._kv_bytes_read = 0
        self._host_syncs = 0
        self._horizon_buckets = set()

        Engine._instances += 1
        self._profiler_name = f"serving.engine{Engine._instances}"
        self.prefix.metric_label = self._profiler_name
        self._finalizer = None
        if register_profiler:
            # a weakref-backed provider: a bound method in the process
            # registry would pin the engine (and its pool) forever
            ref = weakref.ref(self)

            def _provider():
                eng = ref()
                return eng.counters() if eng is not None else {}

            _obs_metrics.register_provider(self._profiler_name, _provider)
            self._finalizer = weakref.finalize(
                self, _obs_metrics.unregister_provider, self._profiler_name)
        # the device-memory ledger: what the engine knows it holds (the
        # pool, the weights, the device decode state) reconciled against
        # the allocator's live bytes at stats() time; the host arena is
        # a host component, reported beside the reconciliation
        self.ledger = _obs_memory.MemoryLedger(self._profiler_name,
                                               device=self.device)
        for name, fn in (("kv_pool", self._kv_pool_bytes),
                         ("weights", self._weight_device_bytes),
                         ("engine_state", self._state_device_bytes)):
            self.ledger.register(name, self._weak_call(fn, 0))
        if self.host_tier is not None:
            self.ledger.register_host(
                "kv_host_arena", self._weak_call(self._host_arena_bytes, 0))
        # per-request flight records, declared SLOs over the retirement
        # stream, and the HTTP telemetry endpoint (which holds the
        # recorder and tracker, not the engine)
        self.recorder = (
            _obs_tracing.FlightRecorder(cfg.flight_recorder_capacity)
            if cfg.request_tracing else None)
        self.slo = None
        if (cfg.slo_ttft_s is not None or cfg.slo_tpot_s is not None
                or cfg.slo_abort_rate is not None):
            self.slo = SLOTracker(self._profiler_name)
            windows = dict(fast_window=cfg.slo_fast_window,
                           slow_window=cfg.slo_slow_window)
            if cfg.slo_ttft_s is not None:
                self.slo.declare("ttft", cfg.slo_ttft_s,
                                 target=cfg.slo_target, **windows)
            if cfg.slo_tpot_s is not None:
                self.slo.declare("tpot", cfg.slo_tpot_s,
                                 target=cfg.slo_target, **windows)
            if cfg.slo_abort_rate is not None:
                # 0/1 observations per retirement; "abort rate < Z" is
                # "1 - Z of observations must be 0"
                self.slo.declare("abort", 0.5,
                                 target=1.0 - cfg.slo_abort_rate,
                                 unit="bool", **windows)
        self.telemetry = None
        if cfg.telemetry_port is not None:
            self.telemetry = TelemetryServer(
                port=cfg.telemetry_port, recorder=self.recorder,
                slo=self.slo).start()

    def close(self):
        """Stop the telemetry server and unregister this engine's
        counter provider (idempotent; the provider unregistration also
        runs when the engine is garbage-collected)."""
        if self.telemetry is not None:
            self.telemetry.stop()
        if self._finalizer is not None:
            self._finalizer()

    def install_faults(self, injector, scope=""):
        """Arm deterministic fault injection (``faults.FaultInjector``)
        on this engine's ``engine.admit`` site; None disarms.  ``scope``
        names this engine in the plan (usually the worker name)."""
        self.faults = injector
        self._fault_scope = scope or self._profiler_name

    @staticmethod
    def _weak_call(method, default=None):
        """``method`` behind a weak reference to its engine.  The ledger
        and the prefix store hold these: a bound method would close a
        reference cycle, and the engine (and its pool) would then live
        on after its last reference until the cycle collector ran."""
        ref = weakref.WeakMethod(method)

        def call(*args):
            bound = ref()
            return default if bound is None else bound(*args)

        return call

    @staticmethod
    def _norm_quant_knob(value, name):
        """A serving quant knob as None or "int8" (case-insensitive)."""
        key = value if value is None else str(value).lower()
        if key in (None, "", "none"):
            return None
        if key in ("int8", "i8"):
            return "int8"
        raise ValueError(
            f"unsupported {name} {value!r} (supported: None, 'int8')")

    # ------------------------------------------------------------ model
    def _forward(self, ids, tables, pos, last=None):
        """Paged forward of ``ids`` [B, s] at ``pos`` [B] through
        ``tables`` [B, nb]; returns the logits [B, vocab] at positions
        ``last`` [B] of the window, or with ``last=None`` (a decode
        window) the logits [B, s, vocab] of every position."""
        views = self.cache.layer_views(tables, pos)
        with torch.no_grad():
            h, _ = self.model.model(ids, caches=views, wq=self._wq)
            if last is not None:
                h = h[torch.arange(h.shape[0], device=h.device), last]
            return self.model._logits(h, paged=True, wq=self._wq)

    # ------------------------------------------------------------ buckets
    def _bucket(self, n_tokens):
        """``n_tokens`` rounded up to a power-of-two multiple of
        ``min_prefill_bucket``, capped at ``max_seq_len``."""
        b = self.config.min_prefill_bucket
        while b < n_tokens:
            b *= 2
        return min(b, self.config.max_seq_len)

    @staticmethod
    def _admission_tokens(req):
        """The tokens a prefill must cover: the prompt, or on
        re-admission after preemption prompt + all but the last
        generated token (the prefill re-samples that one)."""
        if req.output_ids:
            return req.prompt_ids + req.output_ids[:-1]
        return req.prompt_ids

    def _admission_bucket(self, req):
        """The prefill bucket a request would dispatch in now: its
        suffix past the cached prefix, bucketed, clamped so prefix +
        bucket fits a row, and capped at the chunk size."""
        toks = self._admission_tokens(req)
        matched = self.prefix.lookup(toks)
        bucket = min(self._bucket(len(toks) - matched),
                     self.config.max_seq_len - matched)
        if self._chunk_tokens:
            bucket = min(bucket, self._chunk_tokens)
        return bucket

    def _blocks_needed(self, req):
        """Fresh blocks this request's admission would allocate: its
        table entries out to the covered token, minus the full-block
        hits it leases (a COW tail still needs a private block)."""
        toks = self._admission_tokens(req)
        matched = self.prefix.lookup(toks)
        cover = len(toks)
        if self._chunk_tokens:
            cover = min(cover, matched + self._admission_bucket(req))
        return -(-cover // self._block_size) - matched // self._block_size

    def _lane_bucket(self, n):
        """Lane count for an n-request prefill batch: the next power of
        two, capped at num_slots."""
        lanes = 1
        while lanes < n:
            lanes *= 2
        return min(lanes, self.config.num_slots)

    @staticmethod
    def _pow2_floor(x):
        return 1 << (int(x).bit_length() - 1)

    @staticmethod
    def _pow2_ceil(x):
        return 1 << max(0, int(x) - 1).bit_length()

    def _table_width(self, n_tokens):
        """Table columns covering ``n_tokens`` positions, bucketed to a
        power of two (the kernel's output is bitwise invariant to it)."""
        need = -(-int(n_tokens) // self._block_size)
        return min(self._max_blocks, max(1, self._pow2_ceil(need)))

    def _attn_blocks(self, h, w=1):
        """The decode table width: enough entries for the deepest live
        row's next ``h * w`` positions (``w = K + 1`` when drafting: a
        fully accepted horizon)."""
        mx = max((int(self._pos[s]) for s in self.scheduler.running),
                 default=0)
        return self._table_width(mx + h * w)

    def _resolve_spec_k(self):
        """The draft width of the next decode dispatch: ``spec_k``, or
        with ``spec_adaptive`` 0 once no running lane's gate is on
        (below-floor lanes draft nothing inside a K-wide dispatch)."""
        if self._degrade_level >= 1:
            return 0                 # ladder level 1+: spec decoding off
        k = self._spec_k
        if not k or not self.config.spec_adaptive:
            return k
        if any(self._spec_gates[s] for s in self.scheduler.running):
            return k
        return 0

    def _resolve_horizon(self, requested=None):
        """An explicit ``requested`` horizon is clamped to
        ``[1, max_horizon]`` and rounded down to a power of two.
        Otherwise: 1 while requests queue or chunks are in flight (work
        waits at every boundary); else grow multiplicatively toward
        ``max_horizon``, capped by the smallest remaining budget.  Ladder
        level 2 and above: always 1."""
        if self._degrade_level >= 2:
            return 1                 # admit at every boundary
        max_h = max(1, int(self.config.max_horizon))
        if requested is not None:
            return self._pow2_floor(min(max(1, int(requested)), max_h))
        if self.scheduler.queue_depth or self._chunking:
            return 1
        rem = min(r.remaining_budget
                  for r in self.scheduler.running.values())
        return self._pow2_floor(max(1, min(max_h, self._grow, rem)))

    # ------------------------------------------------ structured decoding
    def _norm_grammar(self, grammar, sampling):
        """Validate and eagerly compile a request grammar; returns the
        ``GrammarSpec`` or None.  Every failure surfaces here, at
        submit(), before anything queues: ``GrammarError`` for an
        unsupported grammar (naming the feature), ``ValueError`` for an
        engine configured without structured generation."""
        if grammar is None:
            return None
        spec = as_grammar_spec(grammar)
        if not self._structured:
            raise ValueError(
                "grammar-constrained request on an engine without "
                "structured generation (set "
                "EngineConfig.grammar_max_states > 0 and grammar_vocab)")
        if sampling.eos_token_id is None:
            raise ValueError(
                "grammar-constrained requests require "
                "sampling.eos_token_id: EOS is legal exactly in the "
                "grammar's accept states, so without one the lane "
                "could never legally stop")
        key = (spec.key, int(sampling.eos_token_id))
        if key in self._grammar_cache:
            # LRU touch: re-insertion order is the eviction order of
            # retired entries in _trim_grammar_cache
            self._grammar_cache[key] = self._grammar_cache.pop(key)
            self._grammar_cache_hits += 1
        else:
            if self.config.grammar_vocab is None:
                raise ValueError(
                    "EngineConfig.grammar_vocab is required for "
                    "structured generation: the compiler walks every "
                    "vocab token's characters through the grammar")
            self._grammar_cache[key] = compile_grammar(
                spec, self.config.grammar_vocab,
                int(sampling.eos_token_id),
                vocab_size=self.model.config.vocab_size)
            self._grammar_cache_misses += 1
        return spec

    @staticmethod
    def _walk_grammar(dfa, tokens):
        """Advance the compiled ``TokenDFA`` through ``tokens`` from its
        start state; returns the grammar-local state.  Walks the cached
        TokenDFA, whose REJECT is -1, never the slab, which stores
        REJECT as row 0 (the accept-all state) and so would silently
        un-constrain the lane.  Raises ``ValueError`` naming the first
        illegal transition."""
        st = 0
        for i, t in enumerate(tokens):
            t = int(t)
            nxt = (int(dfa.next_state[st, t])
                   if 0 <= t < dfa.vocab_size else -1)
            if nxt < 0:
                raise ValueError(
                    f"token {t} at output position {i} is illegal "
                    f"under the request grammar (DFA state {st})")
            st = nxt
        return st

    def _dfa_admission_state(self, req):
        """The slab-global DFA state a (re-)admitted constrained lane
        samples its next token from: the start state advanced by every
        token already emitted EXCEPT the last, which the prefill
        re-samples under the mask (and checks bit for bit)."""
        key = self._grammar_keys[req.request_id]
        try:
            st = self._walk_grammar(self._grammar_cache[key],
                                    req.output_ids[:-1])
        except ValueError as e:
            raise RuntimeError(
                f"request {req.request_id} diverged from its grammar "
                f"mid-admission: {e}") from None
        return self._grammar_slab.offset(key) + st

    def _release_grammar(self, req):
        """Drop a finished or aborted request's slab reference and park
        its lane on the accept-all row."""
        key = self._grammar_keys.pop(req.request_id, None)
        if key is not None:
            self._grammar_slab.release(key)
            self._trim_grammar_cache()
        if req.slot is not None:
            self._dfa_state[req.slot] = 0

    def _trim_grammar_cache(self):
        """Bound the host compile cache: entries whose slab segment is
        live stay (admission walks through them), retired ones survive
        as an LRU of ``grammar_cache_keep``."""
        keep = max(0, int(self.config.grammar_cache_keep))
        retired = [k for k in self._grammar_cache
                   if not self._grammar_slab.installed(k)]
        for k in retired[:len(retired) - keep]:
            del self._grammar_cache[k]

    def _sync_grammar_tables(self):
        """Upload the slab's tables, only when an install or release
        dirtied them: the dense next-state table, the packed mask (its
        uint32 words as int32) and the forced tokens."""
        if not self._structured or not self._grammar_slab.dirty:
            return
        slab, d = self._grammar_slab, self.device
        self._d_dfa = (torch.from_numpy(slab.next).to(d),
                       torch.from_numpy(slab.mask.view(np.int32)).to(d),
                       torch.from_numpy(slab.forced).to(d))
        slab.dirty = False

    def _forced_run(self, st, k, budget, eos):
        """How many of the forced chain's ``k`` drafts from slab state
        ``st`` a window could emit: the chain up to its first state that
        is not forced, cut after EOS and at the lane's remaining
        ``budget``.  Each of them must be accepted (the mask leaves its
        position one legal token), which ``stats()["structured"]``
        shows as ``forced_tokens == forced_drafted``."""
        slab, n = self._grammar_slab, 0
        while n < min(k, budget):
            f = int(slab.forced[st])
            if f < 0:
                break
            n += 1
            if f == eos:
                break
            st = int(slab.next[st, f])
        return n

    def _observe_masked(self, st):
        """One constrained emitted token's masked vocab fraction."""
        frac = 1.0 - float(self._grammar_slab.popcount[st]) \
            / int(self.model.config.vocab_size)
        self._masked_sum += frac
        self._masked_n += 1
        _SRV_GRAMMAR_MASKED.observe(frac, engine=self._profiler_name)

    # ------------------------------------------------------------ requests
    def submit(self, prompt_ids, sampling=None, priority=0,
               deadline_s=None, tenant=None, resume_ids=None,
               grammar=None):
        """Queue one request; returns its ``Request`` handle, whose
        ``output_ids`` fill in as the engine steps.

        ``priority`` widens the scheduler's overtake budget (negative:
        the offline batch lane, shed and preempted first); ``deadline_s``
        bounds queue wait — a request still QUEUED when it passes is
        aborted at the next admission pass (``finish_reason="abort"``);
        ``tenant`` tags the request for :meth:`tenant_ledger`.

        ``resume_ids`` is the failover entry point: tokens this request
        already generated on another engine over the same weights.  The
        request queues as ``resumed`` and admission takes the
        preemption-resume path — re-prefill ``prompt + resume_ids[:-1]``,
        re-sample token ``len(resume_ids) - 1`` and check it bit for bit
        against ``resume_ids[-1]`` — then decode continues the stream.
        Requires ``len(resume_ids) < max_new_tokens``.

        ``grammar`` constrains the output: a regex string, a JSON-schema
        dict or a ``GrammarSpec``.  It is validated and compiled here,
        eagerly: an unsupported grammar raises ``GrammarError`` (the
        gateway's 400 ``invalid_grammar``) before anything queues.  It
        requires ``grammar_max_states > 0``, ``grammar_vocab`` and a
        ``sampling.eos_token_id``.  Slab exhaustion raises
        ``RuntimeError`` here, with nothing queued, and ``resume_ids``
        that do not walk the grammar raise ``ValueError``."""
        if self._draining:
            raise RuntimeError("engine is draining; submissions refused")
        prompt_ids = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        if not prompt_ids:
            raise ValueError("empty prompt")
        if deadline_s is not None and not float(deadline_s) > 0:
            raise ValueError(
                f"deadline_s must be > 0 or None, got {deadline_s}")
        sampling = sampling or SamplingParams()
        if len(prompt_ids) + sampling.max_new_tokens > self.config.max_seq_len:
            raise ValueError(
                f"prompt_len {len(prompt_ids)} + max_new_tokens "
                f"{sampling.max_new_tokens} exceeds max_seq_len "
                f"{self.config.max_seq_len}")
        resume_ids = [int(t) for t in resume_ids] if resume_ids else None
        if resume_ids and len(resume_ids) >= sampling.max_new_tokens:
            raise ValueError(
                f"resume_ids already holds {len(resume_ids)} tokens, "
                f">= max_new_tokens {sampling.max_new_tokens}: nothing "
                "left to generate")
        grammar = self._norm_grammar(grammar, sampling)
        key = None
        if grammar is not None:
            key = (grammar.key, int(sampling.eos_token_id))
            if resume_ids:
                # the other replica generated these under the same mask:
                # an illegal transition means corrupt resume data
                try:
                    self._walk_grammar(self._grammar_cache[key], resume_ids)
                except ValueError as e:
                    raise ValueError(
                        f"resume_ids diverged from the request "
                        f"grammar: {e}") from None
            # install BEFORE the scheduler sees the request: slab
            # exhaustion must leave nothing queued
            try:
                self._grammar_slab.install(key, self._grammar_cache[key])
            except Exception:
                self._trim_grammar_cache()
                raise
        try:
            req = self.scheduler.submit(prompt_ids, sampling,
                                        priority=priority,
                                        deadline_s=deadline_s,
                                        tenant=tenant, grammar=grammar)
        except BaseException:
            if key is not None:
                self._grammar_slab.release(key)
                self._trim_grammar_cache()
            raise
        if key is not None:
            self._grammar_keys[req.request_id] = key
        if resume_ids:
            req.output_ids = list(resume_ids)
            req.resumed = True
        t = self._tenants.setdefault(
            tenant if tenant is not None else "",
            {"submitted": 0, "finished": 0, "aborted": 0,
             "tokens_generated": 0})
        t["submitted"] += 1
        if self.recorder is not None:
            req.trace = _obs_tracing.RequestTrace(
                req.request_id, engine=self._profiler_name)
            gw = {}
            if req.priority:
                gw["priority"] = req.priority
            if req.deadline_s is not None:
                gw["deadline_s"] = req.deadline_s
            if req.tenant is not None:
                gw["tenant"] = req.tenant
            if resume_ids:
                gw["resumed_tokens"] = len(resume_ids)
            if grammar is not None:
                gw["grammar"] = grammar.kind
            req.trace.add(_obs_tracing.QUEUED, prompt_len=req.prompt_len,
                          max_new_tokens=sampling.max_new_tokens, **gw)
            self.recorder.attach(req.trace)
        _SRV_QUEUE.set(self.scheduler.queue_depth,
                       engine=self._profiler_name)
        return req

    def admit(self):
        """Advance the in-flight chunked prefills by one chunk, then
        admit queued requests into free slots: co-bucketed batches
        (``Scheduler.pop_batch``) prefill in one forward each.  A batch
        whose blocks do not fit first reclaims unpinned prefix blocks;
        if still short it waits for running requests to retire, or, with
        nothing running, the longest queue-head prefix that fits is
        admitted.  Expired deadlines abort first; at ladder level 3 the
        queue is then shed down to ``num_slots`` requests, and an armed
        ``pool_exhausted`` fault defers the whole pass."""
        self._expire_deadlines()
        self._admit_deferred = False
        if self.scheduler.queue_depth:
            if self._degrade_level >= 3:
                # resumed requests are never shed: their tokens are
                # already streamed
                for req in self.scheduler.shed_victims(
                        self.cache.num_slots):
                    self._degrade_sheds += 1
                    _SRV_SHED.inc(engine=self._profiler_name)
                    self.abort(req, cause="shed")
            if self.faults is not None:
                spec = self.faults.fire(SITE_ENGINE_ADMIT,
                                        scope=self._fault_scope)
                if spec is not None and spec.kind == FAULT_POOL_EXHAUSTED:
                    # behave exactly like a dry pool: defer this whole
                    # admission pass to the next horizon boundary
                    self._admit_deferred = True
                    return
        self._advance_chunks()
        # tiered KV: promote host-arena state for the requests this pass
        # could pop (the free slots plus the reorder window), so their
        # admission is a prefix hit instead of a re-prefill
        if self.host_tier is not None and self.scheduler.queue_depth:
            window = self.cache.free_slots + self.config.reorder_window
            for req in list(self.scheduler.queue)[:window]:
                if self._swap_in(req) is None:
                    # pool dry even after a reclaim: a later request
                    # cannot fare better; no host state was consumed
                    break
        while self.cache.free_slots and self.scheduler.queue_depth:
            batch = self.scheduler.pop_batch(
                self.cache.free_slots, bucket_of=self._admission_bucket)
            if not batch:
                break
            need = sum(self._blocks_needed(r) for r in batch)
            short = need - self.pool.free_blocks
            while short > 0 and self.prefix.reclaim(short):
                # the reclaim may have evicted blocks this batch counted
                # as hits: re-derive the need until it stabilizes (each
                # pass closes the gap or shrinks the unpinned set)
                need = sum(self._blocks_needed(r) for r in batch)
                short = need - self.pool.free_blocks
            if short > 0:
                self.scheduler.queue.extendleft(reversed(batch))
                if self.scheduler.running:
                    break            # retry after retirements free blocks
                fit, free = [], self.pool.free_blocks
                for r in batch:
                    nb = self._blocks_needed(r)
                    if nb > free:
                        break
                    free -= nb
                    fit.append(r)
                if not fit:
                    raise RuntimeError(
                        f"KV pool too small: the queue head alone needs "
                        f"{self._blocks_needed(batch[0])} blocks, the pool "
                        f"has {self.pool.free_blocks} free and nothing is "
                        "running to retire (raise kv_pool_blocks or free "
                        "the prefix budget)")
                for _ in fit:
                    self.scheduler.queue.popleft()
                batch = fit
            self._prefill_batch(batch)

    def _expire_deadlines(self):
        """Abort every still-QUEUED request whose admission deadline
        passed (deadlines bound queue wait: a request that already
        claimed a slot runs to completion).  Counted in both
        ``serving.requests_aborted`` and ``serving.deadline_expired``."""
        for req in [r for r in self.scheduler.queue if r.deadline_expired]:
            self._deadline_expired += 1
            _SRV_DEADLINE.inc(engine=self._profiler_name)
            self.abort(req, cause="deadline")

    def _prefill_batch(self, batch):
        """One batched prefill forward: claim slots, lease the cached
        prefix blocks into the tables, allocate private blocks out to
        the covered token, COW + suffix-prefill every lane, adopt the
        new full blocks, then sample first tokens (or, for a chunked
        lane, register its progress)."""
        bucket = max(self._admission_bucket(r) for r in batch)
        bs = self._block_size
        entries = []
        name = self._profiler_name
        for req in batch:
            slot = self.cache.alloc()
            was_resumed = req.resumed
            self.scheduler.start(req, slot)
            _SRV_QUEUE_WAIT.observe(req.queue_seconds, engine=name)
            toks = self._admission_tokens(req)
            lease = self.prefix.acquire(toks)
            self._leases[req.request_id] = lease
            req.prefix_hit_tokens = lease.matched_tokens
            start = lease.matched_tokens
            take = len(toks) - start
            if self._chunk_tokens:
                take = min(take, bucket)
            cover = start + take
            full = len(lease.block_ids)
            for j, bid in enumerate(lease.block_ids):
                self.cache.lease_block(slot, j, bid)
            for j in range(full, -(-cover // bs)):
                if self.cache.alloc_entry(slot, j) is None:
                    # a batch-mate's acquire may have evicted blocks this
                    # lane's lookup counted; every lease taken so far is
                    # pinned, so a reclaim drops only blocks nobody here
                    # holds
                    if (not self.prefix.reclaim(1)
                            or self.cache.alloc_entry(slot, j) is None):
                        raise RuntimeError(
                            "KV pool exhausted mid-admission: admit()'s "
                            "capacity check diverged from the allocation")
            cow = None
            if lease.tail_tokens:
                cow = (lease.tail_block, int(self.cache.tables[slot, full]))
                self._cow_copies += 1
            entries.append(dict(req=req, slot=slot, lease=lease, toks=toks,
                                start=start, take=take,
                                final=cover == len(toks), cow=cow))
            _obs_events.instant("serving.slot_alloc", cat="serving",
                                slot=slot, request=req.request_id,
                                prompt_len=req.prompt_len, bucket=bucket,
                                prefix_hit=lease.matched_tokens)
            if req.trace is not None:
                req.trace.add(
                    _obs_tracing.RESUME if (req.output_ids or was_resumed)
                    else _obs_tracing.PREFILL,
                    slot=slot, bucket=bucket, prefill_tokens=len(toks),
                    prefix_hit_tokens=lease.matched_tokens)
            if not req.output_ids and not was_resumed:
                # async span: a request's life overlaps other requests
                # on this thread, so it pairs by id (a preempted
                # request's span is already open)
                _obs_events.record(
                    "serving.request", phase=_obs_events.ASYNC_BEGIN,
                    cat="serving", id=req.request_id,
                    args={"slot": slot, "prompt_len": req.prompt_len,
                          "prefix_hit_tokens": lease.matched_tokens})

        first, dfa = self._dispatch_prefill(entries, bucket,
                                            self._lane_bucket(len(batch)))
        self._prefill_requests += len(batch)
        _SRV_PREFILL_REQS.inc(len(batch), engine=name)
        _SRV_PREFILL_BATCH.observe(len(batch), engine=name)
        for e in entries:
            row = self.cache.tables[e["slot"]]
            self.prefix.adopt(e["toks"][:e["start"] + e["take"]], e["lease"],
                              block_of=lambda j, row=row: row[j])
        for i, e in enumerate(entries):
            req, slot = e["req"], e["slot"]
            hit = e["lease"].matched_tokens
            self._prefix_hit_tokens += hit
            self._prompt_tokens += len(e["toks"])
            if hit:
                _SRV_PREFIX_HIT.inc(hit, engine=name)
            if e["final"]:
                self._finish_prefill_lane(req, slot, e["toks"], first[i],
                                          int(dfa[i]))
                continue
            # chunked admission: the first chunk is written and no token
            # sampled; the lane stays decode-inactive at its cover
            cover = e["start"] + e["take"]
            self._chunked_requests += 1
            self._chunk_count_total += 1
            self._chunking[req.request_id] = _ChunkProgress(
                req, slot, e["lease"], e["toks"], cover)
            self._pos[slot] = cover
            self._active[slot] = False
            self._state_dirty = True

    def _dispatch_prefill(self, entries, bucket, lanes):
        """Build the lane arrays of a prefill (admission batches and
        chunk continuations alike) and run its ONE forward: the COW
        copies first, then the suffix windows at ``pos = prefix_lens``,
        sampling each lane's token at ``lengths - 1`` under count
        ``max(0, n_generated - 1)`` (a re-admission re-samples its last
        token), a constrained final lane masked to its DFA admission
        state's legal tokens.  Padding lanes keep all-zero table rows:
        their writes land in scratch.  Returns the sampled tokens as a
        list and the lanes' DFA admission states (0, the accept-all
        row, for free, padding and non-final chunk lanes)."""
        ids = np.zeros((lanes, bucket), np.int64)
        lengths = np.ones(lanes, np.int64)
        prefix_lens = np.zeros(lanes, np.int32)
        cow_src = np.zeros(lanes, np.int64)
        cow_dst = np.zeros(lanes, np.int64)
        counts = np.zeros(lanes, np.int64)
        seeds = np.zeros(lanes, np.int64)
        temps = np.zeros(lanes, np.float32)
        top_ks = np.zeros(lanes, np.int64)
        top_ps = np.ones(lanes, np.float32)
        dfa = np.zeros(lanes, np.int64)
        for i, e in enumerate(entries):
            req = e["req"]
            if e["final"] and req.grammar is not None:
                dfa[i] = self._dfa_admission_state(req)
            window = e["toks"][e["start"]:e["start"] + e["take"]]
            ids[i, :len(window)] = window
            lengths[i] = len(window)
            prefix_lens[i] = e["start"]
            if e["cow"] is not None:
                cow_src[i], cow_dst[i] = e["cow"]
            if e["final"]:
                counts[i] = max(0, req.n_generated - 1)
            s = req.sampling
            seeds[i], temps[i] = s.seed, s.temperature
            top_ks[i], top_ps[i] = s.top_k, s.top_p
        nb = self._table_width(int(prefix_lens.max()) + bucket)
        tables = np.zeros((lanes, nb), np.int32)
        for i, e in enumerate(entries):
            tables[i] = self.cache.tables[e["slot"], :nb]
        d = self.device
        t0 = time.perf_counter()
        with _obs_span("serving.prefill_pass", cat="serving",
                       engine=self._profiler_name,
                       event_args={"batch_size": len(entries),
                                   "lanes": lanes, "bucket": bucket}):
            if cow_dst.any():
                # on the forward's stream, ahead of it: the suffix writes
                # then overwrite the copied block from the divergence
                # offset on
                self.cache.copy_blocks(torch.from_numpy(cow_src).to(d),
                                       torch.from_numpy(cow_dst).to(d))
            logits = self._forward(
                torch.from_numpy(ids).to(d), torch.from_numpy(tables).to(d),
                torch.from_numpy(prefix_lens).to(d),
                torch.from_numpy(lengths - 1).to(d))
            if self._structured:
                self._sync_grammar_tables()
                allowed = _unpack_mask(
                    self._d_dfa[1][torch.from_numpy(dfa).to(d)],
                    logits.shape[-1])
                logits = apply_mask(logits, allowed)
            first = sample_batch(logits, seeds, counts, temps, top_ks,
                                 top_ps).tolist()     # the one host sync
        dt = time.perf_counter() - t0
        self._prefill_s += dt
        # the "auto" swap policy's recompute estimate: seconds up to the
        # host sync of the sampled tokens, over the tokens dispatched
        self._prefill_dispatch_s += dt
        self._prefill_tokens_dispatched += int(lengths[:len(entries)].sum())
        self._prefill_calls += 1
        self._prefill_buckets.add((lanes, bucket))
        _SRV_PREFILL.inc(engine=self._profiler_name)
        return first, dfa

    def _finish_prefill_lane(self, req, slot, toks, tok, dfa_i):
        """Arm a lane whose prefill just completed (whole, or the final
        chunk): verify a re-admission's re-sampled token or record the
        first one, then bring the lane's decode mirrors live (a
        constrained lane's DFA state: its admission state ``dfa_i``
        advanced by ``tok``)."""
        if req.output_ids:
            if tok != req.output_ids[-1]:
                raise RuntimeError(
                    f"preemption resume diverged for request "
                    f"{req.request_id}: re-prefill sampled {tok}, "
                    f"expected {req.output_ids[-1]}")
        else:
            self._tokens_generated += 1
            _SRV_TOKENS.inc(engine=self._profiler_name)
            done = req.record_token(tok)
            if req.trace is not None:
                req.trace.add(_obs_tracing.FIRST_TOKEN, token=tok,
                              ttft_s=round(req.ttft, 6))
            if done:
                self._retire(req)
                return
        s = req.sampling
        self._tokens[slot] = tok
        self._pos[slot] = len(toks)
        if self._hist is not None:
            # the drafter's corpus: prompt (plus the regenerated tokens of
            # a resume), then the sampled token; the tail is zeroed so a
            # reused slot keeps nothing of its previous tenant
            self._hist[slot, :len(toks)] = toks
            self._hist[slot, len(toks)] = tok
            self._hist[slot, len(toks) + 1:] = 0
        self._spec_ema[slot] = 1.0       # optimistic: draft until shown
        self._spec_gates[slot] = True    # not to pay off
        self._dfa_state[slot] = (int(self._grammar_slab.next[dfa_i, tok])
                                 if req.grammar is not None else 0)
        self._seeds[slot] = s.seed
        self._counts[slot] = req.n_generated
        self._temps[slot] = s.temperature
        self._top_ks[slot] = s.top_k
        self._top_ps[slot] = s.top_p
        self._eos_ids[slot] = -1 if s.eos_token_id is None \
            else int(s.eos_token_id)
        self._limits[slot] = s.max_new_tokens
        self._active[slot] = True
        self._state_dirty = True

    def _make_room(self, req, what):
        """One step of the pressure ladder for ``req``: reclaim an
        unpinned prefix block, else preempt the lowest-priority,
        youngest other running request.  Raises when neither is left."""
        if self.prefix.reclaim(1):
            return
        victim = max((r for r in self.scheduler.running.values()
                      if r is not req),
                     key=lambda r: (-r.priority, r.request_id), default=None)
        if victim is None:
            raise RuntimeError(
                f"KV pool exhausted: {what} of request {req.request_id} "
                "needs blocks and there is nothing left to reclaim or "
                "preempt (raise kv_pool_blocks)")
        self.preempt(victim)

    def _advance_chunks(self):
        """One continuation chunk for every in-flight chunked prefill,
        all in ONE forward at the chunk bucket.  Each table first grows
        to cover its next chunk (under pressure: reclaim, then preempt
        another request); the completed blocks are adopted at every
        boundary; a lane's final chunk samples its first token."""
        if not self._chunking:
            return
        decode_live = any(bool(self._active[s])
                          for s in self.scheduler.running)
        entries = []
        for prog in list(self._chunking.values()):
            req, slot = prog.req, prog.slot
            if self.scheduler.running.get(slot) is not req:
                continue             # preempted meanwhile
            remaining = len(prog.toks) - prog.covered
            take = min(remaining, self._chunk_tokens)
            while not self.cache.ensure_blocks(slot, prog.covered + take):
                self._make_room(req, "a prefill chunk")
            entries.append(dict(req=req, slot=slot, lease=prog.lease,
                                toks=prog.toks, start=prog.covered,
                                take=take, final=take == remaining,
                                cow=None, prog=prog))
        # a later lane's pressure may have preempted an earlier entry
        entries = [e for e in entries
                   if self.scheduler.running.get(e["slot"]) is e["req"]]
        if not entries:
            return
        t0 = time.perf_counter()
        first, dfa = self._dispatch_prefill(entries, self._chunk_tokens,
                                            self._lane_bucket(len(entries)))
        name = self._profiler_name
        if decode_live:
            # the decode lanes' next horizon waited for this dispatch
            dt = time.perf_counter() - t0
            self._interference_s += dt
            _SRV_PREFILL_INTERFERE.inc(dt, engine=name)
        self._chunk_dispatches += 1
        self._chunk_count_total += len(entries)
        for i, e in enumerate(entries):
            req, slot, prog = e["req"], e["slot"], e["prog"]
            cover = e["start"] + e["take"]
            row = self.cache.tables[slot]
            self.prefix.adopt(e["toks"][:cover], e["lease"],
                              block_of=lambda j, row=row: row[j])
            prog.covered = cover
            prog.chunks += 1
            _obs_events.instant("serving.prefill_chunk", cat="serving",
                                slot=slot, request=req.request_id,
                                chunk=prog.chunks, covered=cover,
                                total=len(prog.toks))
            if e["final"]:
                del self._chunking[req.request_id]
                _SRV_PREFILL_CHUNKS.observe(prog.chunks, engine=name)
                if req.trace is not None:
                    req.trace.add("prefill_chunked", chunks=prog.chunks,
                                  prefill_tokens=len(prog.toks))
                self._finish_prefill_lane(req, slot, e["toks"], first[i],
                                          int(dfa[i]))
            else:
                self._pos[slot] = cover
                self._state_dirty = True

    def _release_lane(self, req):
        """Give back a running request's table entries, prefix lease and
        slot; the lane goes inactive."""
        self._chunking.pop(req.request_id, None)
        self.cache.release_slot_blocks(req.slot)
        lease = self._leases.pop(req.request_id, None)
        if lease is not None:
            self.prefix.release(lease)   # the chain becomes evictable
        self._active[req.slot] = False

    def _retire(self, req):
        """Release the request's blocks, lease, slot, grammar reference
        and any unconsumed lane image."""
        slot = req.slot
        if self._structured:
            self._release_grammar(req)
        if self.host_tier is not None:
            self.host_tier.drop_lane(req.request_id)
        self._release_lane(req)
        self.cache.free(slot)
        self.scheduler.finish(req)
        self._finished += 1
        self._ttft_sum += req.ttft
        tn = self._tenants.get(req.tenant if req.tenant is not None
                               else "")
        if tn is not None:
            tn["finished"] += 1
            tn["tokens_generated"] += req.n_generated
        name = self._profiler_name
        _SRV_REQS.inc(engine=name)
        _SRV_TTFT.observe(req.ttft, engine=name)
        _obs_events.instant("serving.slot_retire", cat="serving",
                            slot=slot, request=req.request_id,
                            reason=req.finish_reason,
                            n_generated=req.n_generated)
        _obs_events.record(
            "serving.request", phase=_obs_events.ASYNC_END,
            cat="serving", id=req.request_id,
            args={"reason": req.finish_reason,
                  "n_generated": req.n_generated,
                  "ttft_s": round(req.ttft, 6)})
        if req.trace is not None:
            req.trace.add(_obs_tracing.FINISH, reason=req.finish_reason,
                          n_generated=req.n_generated,
                          ttft_s=round(req.ttft, 6))
            self.recorder.finish(req.trace)
        if self.slo is not None:
            self.slo.observe("ttft", req.ttft)
            if req.n_generated > 1:
                self.slo.observe(
                    "tpot", (time.time() - req.first_token_time)
                    / (req.n_generated - 1))
            self.slo.observe("abort", 0.0)

    def preempt(self, req):
        """Swap a RUNNING request out: release its slot, table entries
        and prefix lease, and requeue it at the queue front with its
        generated tokens.  Re-admission re-prefills prompt + all but the
        last generated token and re-samples that one under the same
        count, so the stream goes on unchanged.  Called under pool
        pressure; public for callers that swap requests out themselves."""
        if req.status != RUNNING:
            raise ValueError(
                f"cannot preempt request {req.request_id}: {req.status}")
        slot = req.slot
        # tiered KV: save the lane's block chain into the host arena
        # BEFORE its pool references drop
        self._swap_out_lane(req, slot)
        self._release_lane(req)
        # the vacated lane rides the accept-all row; the request keeps
        # its slab reference (it re-admits), so its tables stay
        self._dfa_state[slot] = 0
        self._state_dirty = True
        self.scheduler.requeue_front(req)
        self.cache.free(slot)
        self._preemptions += 1
        _SRV_PREEMPTIONS.inc(engine=self._profiler_name)
        _obs_events.instant("serving.preempt", cat="serving", slot=slot,
                            request=req.request_id,
                            n_generated=req.n_generated)
        if req.trace is not None:
            req.trace.add(_obs_tracing.PREEMPT, slot=slot,
                          n_generated=req.n_generated)

    def abort(self, req, cause=None):
        """Cancel a request: a QUEUED one leaves the queue, a RUNNING one
        releases its slot, table entries and prefix lease (the
        preemption teardown) without requeueing.  The request finishes
        with ``finish_reason="abort"`` and keeps the tokens it has
        generated; aborts feed the ``abort`` SLO objective and the flight
        record ends with an ``abort`` event.  ``cause`` (``"deadline"``,
        ``"drain"``, ``"shed"``, ``"client_disconnect"``, ...) is
        recorded on the trace event and the process event ring.
        Returns the request."""
        if req.status == FINISHED:
            raise ValueError(
                f"cannot abort request {req.request_id}: already "
                f"finished ({req.finish_reason})")
        if self.host_tier is not None:
            self.host_tier.drop_lane(req.request_id)
        if req.status == WAITING:
            try:
                self.scheduler.queue.remove(req)
            except ValueError:
                raise ValueError(
                    f"cannot abort request {req.request_id}: waiting "
                    "but not queued on this engine") from None
            req.status = FINISHED
            if self._structured:
                self._release_grammar(req)
        else:
            slot = req.slot
            if self._structured:
                self._release_grammar(req)
            self._release_lane(req)
            self._state_dirty = True
            self.scheduler.finish(req)
            self.cache.free(slot)
        req.finish_reason = FINISH_ABORT
        self._aborted += 1
        tn = self._tenants.get(req.tenant if req.tenant is not None
                               else "")
        if tn is not None:
            tn["aborted"] += 1
            tn["tokens_generated"] += req.n_generated
        name = self._profiler_name
        _SRV_ABORTS.inc(engine=name)
        _SRV_QUEUE.set(self.scheduler.queue_depth, engine=name)
        if req.admit_time is not None:
            # only requests that prefilled opened an async span
            _obs_events.record(
                "serving.request", phase=_obs_events.ASYNC_END,
                cat="serving", id=req.request_id,
                args={"reason": FINISH_ABORT, "cause": cause,
                      "n_generated": req.n_generated})
        if req.trace is not None:
            extra = {} if cause is None else {"cause": cause}
            req.trace.add(_obs_tracing.ABORT,
                          n_generated=req.n_generated, **extra)
            self.recorder.finish(req.trace)
        if self.slo is not None:
            self.slo.observe("abort", 1.0)
        return req

    def _ensure_blocks(self, h, w=1):
        """Extend every decoding slot's table to cover its next ``h * w``
        write positions (``w = K + 1`` when drafting; mid-chunk lanes
        grow chunk by chunk instead).
        Under pressure: reclaim, then preempt (:meth:`_make_room`).
        Runs before the horizon's snapshot of the active lanes, so a
        preempted lane is never harvested."""
        for slot, req in sorted(self.scheduler.running.items()):
            if self.scheduler.running.get(slot) is not req:
                continue                 # preempted earlier in this loop
            if not self._active[slot]:
                continue
            need = min(int(self._pos[slot]) + h * w,
                       self.config.max_seq_len)
            while not self.cache.ensure_blocks(slot, need):
                self._make_room(req, "the decode window")

    # ---------------------------------------------------------- tiered KV
    def _fetch_blocks(self, bids):
        """Device copies of pool blocks ``bids`` gathered on the engine's
        stream: ``[n, L, bs, kvh, hd]`` k and v plus ``[n, L, bs]`` scale
        planes (None on fp pools).  The host tier copies them into its
        pinned rows on the same stream, so a later kernel that rewrites
        a source block is ordered after the gather."""
        p = self.pool
        idx = torch.tensor([int(b) for b in bids], dtype=torch.long,
                           device=self.device)
        gather = lambda bufs: torch.stack([b[idx] for b in bufs], dim=1)
        if not self._kv_quant:
            return gather(p.k), gather(p.v), None, None
        return (gather(p.k), gather(p.v), gather(p.k_scale),
                gather(p.v_scale))

    def _demote_block(self, path, block_id):
        """``PrefixCache.spill`` hook: copy one evicted radix block into
        the host arena (called BEFORE the pool block is released).  True
        means the arena kept it: the eviction is a demotion."""
        return self._demote_blocks([path], [block_id])[0]

    def _demote_blocks(self, paths, bids):
        """``PrefixCache.spill_batch`` hook: demote a whole eviction
        pass's victims with ONE batched gather (called BEFORE the pool
        blocks are released).  One bool per block: True when the arena
        kept it."""
        tier = self.host_tier
        if tier is None or not tier.capacity:
            return [False] * len(bids)
        k, v, ks, vs = self._fetch_blocks(bids)
        name = self._profiler_name
        nbytes = self.pool.bytes_per_block
        out = []
        for i, path in enumerate(paths):
            ok = tier.store_prefix(path, k[i], v[i],
                                   None if ks is None else ks[i],
                                   None if vs is None else vs[i])
            if ok:
                self._demote_bytes += nbytes
                _SRV_SWAP_OUT_BYTES.inc(nbytes, engine=name, kind="demote")
            out.append(ok)
        return out

    def _swap_worthwhile(self, n_blocks, n_tokens):
        """The swap-vs-recompute model: estimated upload seconds (bytes
        over the measured host->device GB/s) against estimated
        re-prefill seconds (this engine's measured prefill seconds a
        token).  ``always``/``never`` pin the decision; ``auto`` with
        no prefill measured yet swaps.  Every decision is counted in
        ``stats()["kv_pool"]["swap_decisions"]``."""
        if self._swap_policy == "always":
            ok = True
        elif self._swap_policy == "never" or n_blocks <= 0 \
                or n_tokens <= 0:
            ok = False
        elif not self._prefill_tokens_dispatched:
            ok = True
        else:
            recompute_s = (self._prefill_dispatch_s
                           / self._prefill_tokens_dispatched) * n_tokens
            bw = _obs_memory.host_device_bandwidth_gbs(self.device)
            upload_s = n_blocks * self.pool.bytes_per_block / (bw * 1e9)
            ok = upload_s < recompute_s
        self._swap_decisions["swap" if ok else "recompute"] += 1
        return ok

    def _swap_out_lane(self, req, slot):
        """Tiered KV at preempt: save the lane's whole block chain into
        the host arena BEFORE its pool blocks are released, so
        re-admission can swap it back in instead of re-prefilling.
        Skipped for mid-chunk lanes (their chunks live in the radix
        store and resume as a prefix hit) and when the policy prefers
        recompute; an arena full of pinned images falls back to
        recompute."""
        tier = self.host_tier
        if tier is None or not tier.capacity:
            return False
        if req.request_id in self._chunking or not self._active[slot]:
            return False
        pos = int(self._pos[slot])
        nb = -(-pos // self._block_size)
        if pos <= 0 or not self._swap_worthwhile(nb, pos):
            return False
        bids = [int(b) for b in self.cache.tables[slot, :nb]]
        if any(b == 0 for b in bids):
            return False             # defensive: the chain has a hole
        k, v, ks, vs = self._fetch_blocks(bids)
        blocks = [(k[i], v[i], None if ks is None else ks[i],
                   None if vs is None else vs[i]) for i in range(nb)]
        if not tier.save_lane(req.request_id, pos, blocks):
            return False
        nbytes = nb * self.pool.bytes_per_block
        self._swap_outs += 1
        self._swap_out_blocks += nb
        self._swap_out_bytes += nbytes
        name = self._profiler_name
        _SRV_SWAP_OUT_BYTES.inc(nbytes, engine=name, kind="lane")
        _obs_events.instant("serving.swap_out", cat="serving", slot=slot,
                            request=req.request_id, blocks=nb,
                            bytes=nbytes, n_tokens=pos)
        if req.trace is not None:
            req.trace.add(_obs_tracing.SWAP_OUT, blocks=nb, bytes=nbytes,
                          n_tokens=pos)
        return True

    def _swap_in(self, req):
        """Promote a QUEUED request's host-arena KV into the radix store,
        so its coming admission is an ordinary prefix hit.  A lane image
        restores the full chain, its partial tail block grafted under
        its short token key that only copy-on-write matching can hit
        (the resume prefill still computes >= 1 token, and the resume
        check stays the parity gate); without one, demoted prefix blocks
        extending the device-side match are promoted.  Any failure
        degrades to recompute.  Returns True on a landed swap-in, None
        when the pool was dry (the admission loop stops; no host state
        was consumed), False otherwise."""
        tier = self.host_tier
        if tier is None:
            return False
        toks = self._admission_tokens(req)
        before = self.prefix.lookup(toks)
        chain = self.prefix._walk(toks, len(toks) - 1)
        # pin the matched parent chain: the reclaim fallback below must
        # not evict the parents every graft needs
        for node in chain:
            node.refcount += 1
        try:
            return self._swap_in_pinned(req, tier, toks, before,
                                        len(chain))
        finally:
            for node in chain:
                if node.refcount > 0:
                    node.refcount -= 1

    def _swap_in_pinned(self, req, tier, toks, before, have):
        bs = self._block_size
        img = tier.peek_lane(req.request_id)
        lane = img is not None and img.n_tokens == len(toks)
        if img is not None and not lane:
            tier.drop_lane(req.request_id)   # stale: the tokens moved on
        paths = []
        if lane:
            idxs = list(range(have, -(-len(toks) // bs)))
            if not idxs or not self._swap_worthwhile(
                    len(idxs), len(toks) - have * bs):
                return False
        else:
            paths = tier.match_prefix(toks, have)
            if not paths or not self._swap_worthwhile(
                    len(paths), len(paths) * bs):
                return False
            idxs = [have + j for j in range(len(paths))]
        # allocate the device blocks BEFORE consuming any host state (a
        # dry pool leaves the image / entries for the next pass); the
        # matched entries are pinned, since the reclaim fallback spills
        # new victims into the arena
        tier.pin_prefix(paths)
        try:
            dev_ids = []
            for _ in idxs:
                bid = self.pool.alloc()
                if bid is None and self.prefix.reclaim(1):
                    bid = self.pool.alloc()
                if bid is None:
                    for b in dev_ids:
                        self.pool.release(b)
                    return None
                dev_ids.append(bid)
            if lane:
                img = tier.take_lane(req.request_id)
                plan = [(i, img.hbs[i]) for i in idxs]
                consumed = list(img.hbs)
            else:
                plan = []
                for i, path in zip(idxs, paths):
                    hb = tier.pop_prefix(path)
                    if hb is None:
                        break
                    plan.append((i, hb))
                for b in dev_ids[len(plan):]:
                    self.pool.release(b)
                dev_ids = dev_ids[:len(plan)]
                if not plan:
                    return False
                consumed = [hb for _, hb in plan]
        finally:
            tier.unpin_prefix(paths)
        n = len(plan)
        # upload in host-row order: demoted blocks sit in the arena in
        # eviction order (leaf first), and rows that form a run upload
        # straight from the arena (HostKVTier.gather); the grafts below
        # keep path order
        order = sorted(range(n), key=lambda i: plan[i][1])
        payload = tier.gather([plan[i][1] for i in order])
        for hb in consumed:
            tier.release(hb)
        self._upload_blocks([dev_ids[i] for i in order], *payload)
        grafted = 0
        for (idx, _), bid in zip(plan, dev_ids):
            if self.prefix.graft(toks, idx, bid):
                grafted += 1
            else:
                self.pool.release(bid)   # chain broke: recompute covers
        if not grafted:
            return False
        averted = max(0, self.prefix.lookup(toks) - before)
        nbytes = n * self.pool.bytes_per_block
        name = self._profiler_name
        self._swap_ins += 1
        self._swap_in_blocks += n
        self._swap_in_bytes += nbytes
        _SRV_SWAP_IN_BYTES.inc(nbytes, engine=name)
        self._swaps_averted_tokens += averted
        source = "lane" if lane else "prefix"
        _obs_events.instant("serving.swap_in", cat="serving",
                            request=req.request_id, blocks=n, bytes=nbytes,
                            averted_tokens=averted, source=source)
        if req.trace is not None:
            req.trace.add(_obs_tracing.SWAP_IN, blocks=n, bytes=nbytes,
                          averted_tokens=averted, source=source)
        return True

    def _upload_blocks(self, ids, kd, vd, ksd, vsd):
        """A swap-in's upload: ONE host->device copy of each stacked
        host payload (``[n, L, ...]``, page-locked on the card: arena
        rows or a staged copy of them), then one indexed write a layer
        and buffer into the pool at the freshly allocated ``ids``, all
        on the engine's stream, so a later write into the same arena
        rows is ordered after the read.  The uploaded bytes ARE the
        bytes the pool once held."""
        d, p = self.device, self.pool
        idx = torch.tensor([int(b) for b in ids], dtype=torch.long,
                           device=d)
        pairs = [(p.k, kd), (p.v, vd)]
        if ksd is not None:
            pairs += [(p.k_scale, ksd), (p.v_scale, vsd)]
        for bufs, host in pairs:
            dev = host.to(d, non_blocking=True)
            for layer, buf in enumerate(bufs):
                buf[idx] = dev[:, layer]
        self._swap_uploads += 1

    def _host_arena_bytes(self):
        """Host bytes of the spill arena (allocated in full at
        construction, so constant while the tier lives)."""
        return 0 if self.host_tier is None else self.host_tier.nbytes

    # ------------------------------------------------- memory accounting
    @staticmethod
    def _tensor_bytes(tensors):
        """Bytes of the distinct storages among ``tensors`` (None
        entries skipped)."""
        seen, total = set(), 0
        for t in tensors:
            if t is None:
                continue
            key = (t.device, t.untyped_storage().data_ptr())
            if key not in seen:
                seen.add(key)
                total += t.untyped_storage().nbytes()
        return total

    def _kv_pool_bytes(self):
        p = self.pool
        return self._tensor_bytes(p.k + p.v + (p.k_scale or [])
                                  + (p.v_scale or []))

    def _weight_device_bytes(self):
        """The model's parameters and buffers as stored, plus the int8
        payloads and scales of a weight-quantized engine (which keeps
        the model's own weights too)."""
        quant = [t for qw in self._wq.values() for t in (qw.q, qw.scale)]
        return self._tensor_bytes(list(self.model.state_dict().values())
                                  + quant)

    def _state_device_bytes(self):
        return self._tensor_bytes(list(self._d_state or ())
                                  + [self._d_tables]
                                  + list(self._d_dfa or ()))

    # ------------------------------------------------------------ decode
    def _sync_device_state(self):
        if not self._state_dirty:
            return
        d = self.device
        up = lambda a: None if a is None else torch.from_numpy(a).to(d)
        self._d_state = tuple(up(a) for a in (
            self._tokens, self._pos, self._counts, self._active,
            self._eos_ids, self._limits, self._hist,
            self._spec_gates if self._spec_k else None,
            self._dfa_state if self._structured else None))
        self._state_dirty = False

    def _sync_tables(self, nb):
        if self.cache.tables_dirty or nb != self._d_tables_nb:
            self._d_tables = torch.from_numpy(
                np.ascontiguousarray(self.cache.tables[:, :nb])).to(
                    self.device)
            self._d_tables_nb = nb
            self.cache.tables_dirty = False

    def _dispatch_horizon(self, h, k):
        """``h`` decode steps over every slot, each a window of ``W = k+1``
        positions (draft, verify, accept); returns the harvested
        [h, num_slots, W] token array (-1 where nothing was emitted)
        after the one host sync.  A lane that emits its EOS id or
        reaches its budget freezes: its pos and count stop, its token
        stops changing.  Inactive lanes (free, mid-chunk) run at their
        frozen pos: their writes land in a private block of their own or
        in scratch.

        Sampled lanes draw by their device counts: the uniforms of
        tokens ``count .. count + h*W - 1`` of each sampled lane are
        drawn once, here (:func:`.sampling.draw_uniforms`), and a step
        takes those of ``cnt .. cnt + W - 1``, so no count comes back to
        the host mid-horizon and token ``c`` of a request sees the draw
        it sees at K = 0.  Greedy lanes draw nothing.

        Structured generation: the lane's DFA state ``ds`` rides the
        device state.  With K > 0 the grammar's forced chains overlay
        the n-gram drafts before the gate mask; window position j is
        masked by the state reached by walking ``drafts[:j]`` (for an
        emitted position that walk is the true state: the acceptance
        chain only reaches j when every earlier draft matched its
        masked sample), and the state advances by emitted tokens only.
        Free lanes ride the accept-all row, whose mask is the
        identity."""
        w = k + 1
        nb = self._attn_blocks(h, w)
        self._decode_buckets.add((h, nb, k))
        self._sync_device_state()
        self._sync_tables(nb)
        self._sync_grammar_tables()
        tok, p, cnt, act, eos, limits, hist, gates, ds = self._d_state
        if ds is not None:
            d_next, d_mask, d_forced = self._d_dfa
            forced_on = bool(self.config.grammar_forced_drafting)
        d, n = self.device, self.config.num_slots
        vocab = self.model.config.vocab_size
        # only lanes active at dispatch can emit; the others sample
        # greedily (discarded) so they cost no generator work
        rows = sampled_rows(np.where(self._active, self._temps, 0.0))
        j_idx = torch.arange(w, device=d)[None, :]
        t0 = time.perf_counter()
        if rows:
            u_all = draw_uniforms(self._seeds, self._counts, rows, h * w,
                                  vocab, d)
            ridx = torch.tensor(rows, device=d)
            c0 = cnt[ridx]
            win = [i * w + j for i in rows for j in range(w)]
            params = row_params(win, np.repeat(self._temps, w),
                                np.repeat(self._top_ks, w),
                                np.repeat(self._top_ps, w), d)
            win = torch.tensor(win, device=d)
            lanes = torch.arange(len(rows), device=d)[:, None]
        harvest = []
        for _ in range(h):
            if k:
                drafts = draft_tokens(hist[:, :-1], p.long() + 1, k,
                                      self.config.spec_ngram)
                if ds is not None and forced_on:
                    fd = forced_chain(ds, d_next, d_forced, k)
                    drafts = torch.where(fd >= 0, fd, drafts)
                drafts = torch.where(gates[:, None], drafts, -1)
                ids = torch.cat([tok[:, None], drafts.clamp_min(0)], 1)
            else:
                ids = tok[:, None]
            logits = self._forward(ids, self._d_tables, p).view(n * w, vocab)
            if ds is not None:
                sts = [ds]
                for j in range(k):
                    sts.append(d_next[sts[-1],
                                      drafts[:, j].clamp_min(0)].long())
                allowed = _unpack_mask(d_mask[torch.stack(sts, 1)], vocab)
                logits = apply_mask(logits, allowed.view(n * w, vocab))
            if rows:
                u = u_all[lanes, (cnt[ridx] - c0)[:, None] + j_idx]
                e = sample_rows(logits, win, params, u.view(-1, vocab))
            else:
                e = torch.argmax(logits, dim=-1)
            e = e.view(n, w)
            n_acc = (torch.cumprod((drafts == e[:, :k]).long(), 1).sum(1)
                     if k else torch.zeros_like(cnt))
            # emit the accepted prefix plus the bonus token, cut at the
            # first position that retires the lane (EOS or budget)
            stop = (e == eos[:, None]) | \
                (cnt[:, None] + j_idx + 1 >= limits[:, None])
            keep = torch.cumprod((~stop).long(), 1)
            prev_ok = torch.cat([torch.ones_like(keep[:, :1]),
                                 keep[:, :-1]], 1) > 0
            emitted = (j_idx <= n_acc[:, None]) & prev_ok & act[:, None]
            n_emit = emitted.sum(1)
            done = act & (emitted & stop).any(1)
            if ds is not None:
                for j in range(w):
                    ds = torch.where(emitted[:, j],
                                     d_next[ds, e[:, j]].long(), ds)
            last = e.gather(1, (n_emit - 1).clamp_min(0)[:, None])[:, 0]
            if hist is not None:
                # unemitted positions go to the drop column
                cols = torch.where(emitted, p.long()[:, None] + 1 + j_idx,
                                   hist.shape[1] - 1)
                hist.scatter_(1, cols, e)
            harvest.append(torch.where(emitted, e, -1))
            tok = torch.where(act, last, tok)
            cnt = cnt + n_emit
            p = p + n_emit.to(p.dtype)
            act = act & ~done
        toks = torch.stack(harvest).cpu().numpy()   # the one host sync
        self._host_syncs += 1
        self._decode_s += time.perf_counter() - t0
        # KV traffic of the horizon: every lane reads its nb table-mapped
        # blocks (k + v, all layers) per step, at the pool's stored size
        step_bytes = n * nb * self.pool.bytes_per_block
        self._kv_bytes_read += step_bytes * h
        _SRV_KV_BYTES.inc(step_bytes * h, engine=self._profiler_name)
        self._d_state = (tok, p, cnt, act, eos, limits, hist, gates, ds)
        return toks

    def _harvest(self, toks, active, h, k, finished):
        """Replay the [h, num_slots, k+1] harvested windows into the
        running requests (each window emits 1..k+1 tokens, its -1 tail
        unemitted), keep the host mirrors (token, row length, count,
        history) equal to the frozen device state, update each drafting
        lane's acceptance EMA and gate (a flip dirties the device
        state), and retire (appending to ``finished``) the requests that
        ended.  Returns (tokens harvested, lane steps scanned after their
        lane retired)."""
        harvested = wasted = drafted = accepted = forced_total = 0
        name = self._profiler_name
        floor = float(self.config.spec_accept_floor)
        gated = self._spec_gates.copy()      # the gates the dispatch ran
        slab = self._grammar_slab
        for slot, req in active.items():
            done = False
            lane_tokens = lane_accept = lane_forced = 0
            # replay the lane's DFA walk on the host mirror over the
            # same slab tables and emitted tokens the device walked
            st = int(self._dfa_state[slot]) if self._structured else 0
            constrained = st != 0
            fd_on = (constrained and k
                     and bool(self.config.grammar_forced_drafting))
            for step_i in range(h):
                if done:
                    wasted += 1
                    continue
                row = toks[step_i, slot]
                if row[0] < 0:
                    raise RuntimeError(
                        f"horizon froze slot {slot} at step {step_i} but "
                        "the scheduler still runs its request")
                n_emit = 0
                # a forced draft counts only while the window's chain
                # from its start state held (forced_chain breaks at the
                # first state that is not forced)
                win_chain = fd_on and bool(gated[slot])
                if win_chain:
                    self._spec_forced_drafted += self._forced_run(
                        st, k, int(self._limits[slot]) - req.n_generated,
                        int(self._eos_ids[slot]))
                for j, t in enumerate(row):
                    t = int(t)
                    if t < 0:
                        break                # rejected / unemitted tail
                    n_emit += 1
                    self._tokens[slot] = t
                    self._pos[slot] += 1
                    if self._hist is not None:
                        self._hist[slot, self._pos[slot]] = t
                    if constrained:
                        self._observe_masked(st)
                        if (win_chain and j < k
                                and int(slab.forced[st]) == t):
                            lane_forced += 1
                        else:
                            win_chain = False
                        st = int(slab.next[st, t])
                    if req.record_token(t):
                        done = True
                        break
                harvested += n_emit
                lane_tokens += n_emit
                if k and gated[slot]:
                    drafted += k
                    accepted += n_emit - 1
                    lane_accept += n_emit - 1
                    self._spec_windows += 1
                    _SRV_SPEC_ACCEPT.observe(n_emit, engine=name)
                    self._spec_accept_hist[n_emit] = \
                        self._spec_accept_hist.get(n_emit, 0) + 1
                    ema = 0.5 * float(self._spec_ema[slot]) \
                        + 0.5 * (n_emit - 1) / k
                    self._spec_ema[slot] = ema
                    if self.config.spec_adaptive and \
                            (ema >= floor) != bool(self._spec_gates[slot]):
                        self._spec_gates[slot] = ema >= floor
                        self._state_dirty = True
            self._counts[slot] = req.n_generated
            if constrained:
                self._dfa_state[slot] = st
                forced_total += lane_forced
            if req.trace is not None and lane_tokens:
                extra = {"forced": lane_forced} if constrained else {}
                req.trace.add(_obs_tracing.DECODE, horizon=h, spec_k=k,
                              tokens=lane_tokens, accepted=lane_accept,
                              **extra)
            if done:
                self._retire(req)
                finished.append(req)
        self._tokens_generated += harvested
        self._decode_tokens += harvested
        self._wasted_lane_tokens += wasted
        if forced_total:
            self._spec_forced_tokens += forced_total
            _SRV_SPEC_FORCED.inc(forced_total, engine=name)
        if drafted:
            self._spec_draft_tokens += drafted
            self._spec_accepted_tokens += accepted
            _SRV_SPEC_DRAFTED.inc(drafted, engine=name)
            _SRV_SPEC_ACCEPTED.inc(accepted, engine=name)
            _SRV_SPEC_RATE.set(self._accept_rate(), engine=name)
        return harvested, wasted

    def step(self, horizon=None):
        """Admit queued requests (chunks, then prefill), then run one
        horizon of decode steps over every slot: ``horizon`` steps
        (bucketed to a power of two), or the adaptive choice.  Returns
        the requests that finished during the horizon."""
        t0 = time.time()
        finished = []
        self._update_degradation()
        self.admit()
        if any(self._active[s] for s in self.scheduler.running):
            h = self._resolve_horizon(horizon)
            k = self._resolve_spec_k()
            # block coverage (and any preemption) before the snapshot
            self._ensure_blocks(h, k + 1)
        active = {s: r for s, r in self.scheduler.running.items()
                  if self._active[s]}
        if active:
            self._horizon_buckets.add(h)
            with _obs_span("serving.decode_step", cat="serving",
                           engine=self._profiler_name,
                           event_args={"horizon": h, "spec_k": k}) as sp:
                toks = self._dispatch_horizon(h, k)
                harvested, wasted = self._harvest(toks, active, h, k,
                                                  finished)
                sp.event_args["tokens_harvested"] = harvested
            self._decode_steps += h
            self._decode_horizons += 1
            self._slot_busy_integral += (h * len(active)
                                         / self.cache.num_slots)
            name = self._profiler_name
            _SRV_DECODE_STEPS.inc(h, engine=name)
            _SRV_HORIZON.observe(h, engine=name)
            _SRV_TOKENS.inc(harvested, engine=name)
            if wasted:
                _SRV_WASTED.inc(wasted, engine=name)
            # a stable horizon (nothing retired, nothing waiting) doubles
            # the next one; churn resets it to 1
            if finished or self.scheduler.queue_depth:
                self._grow = 1
            else:
                self._grow = min(max(1, int(self.config.max_horizon)),
                                 max(self._grow, h) * 2)
        dt = time.time() - t0
        self._busy_s += dt
        _SRV_STEP.observe(dt, engine=self._profiler_name)
        self._publish_gauges()
        return finished

    # ------------------------------------------------- degradation ladder
    def _degrade_signal(self):
        """The pressure signal driving the ladder: the reason string
        while the engine is burning (any SLO objective unhealthy, or
        pool occupancy at/above ``degrade_pool_ratio``), else None."""
        if self.slo is not None and not self.slo.healthy:
            return "slo_burn"
        if (self.pool.blocks_in_use / self.pool.capacity
                >= float(self.config.degrade_pool_ratio)):
            return "pool_pressure"
        return None

    def _update_degradation(self):
        """One ladder tick (called every step): ``degrade_patience``
        consecutive burning steps escalate one level,
        ``degrade_recover_patience`` consecutive calm steps step back
        down one level — asymmetric on purpose (hysteresis), so a
        marginal signal can't flap the ladder."""
        if not self.config.degrade_enabled:
            return
        reason = self._degrade_signal()
        if reason is not None:
            self._calm_streak = 0
            self._burn_streak += 1
            if (self._degrade_level < len(DEGRADE_LEVELS) - 1
                    and self._burn_streak
                    >= int(self.config.degrade_patience)):
                self._set_degrade_level(self._degrade_level + 1, reason)
                self._burn_streak = 0
        else:
            self._burn_streak = 0
            if self._degrade_level == 0:
                return
            self._calm_streak += 1
            if (self._calm_streak
                    >= int(self.config.degrade_recover_patience)):
                self._set_degrade_level(self._degrade_level - 1,
                                        "recovered")
                self._calm_streak = 0

    def _set_degrade_level(self, level, reason):
        prev, level = self._degrade_level, int(level)
        self._degrade_level = level
        self._degrade_transitions += 1
        self._degrade_history.append(
            {"from": prev, "to": level,
             "level": DEGRADE_LEVELS[level], "reason": reason,
             "decode_horizons": self._decode_horizons})
        del self._degrade_history[:-64]
        name = self._profiler_name
        _SRV_DEGRADATION.set(level, engine=name)
        _obs_events.instant("serving.degrade", cat="serving",
                            engine=name, level=level,
                            level_name=DEGRADE_LEVELS[level],
                            from_level=prev, reason=reason)

    def _publish_gauges(self):
        """Refresh the point-in-time typed gauges (once per step; the
        counters and histograms accumulate incrementally)."""
        name = self._profiler_name
        _SRV_DEGRADATION.set(self._degrade_level, engine=name)
        _SRV_QUEUE.set(self.scheduler.queue_depth, engine=name)
        _SRV_ACTIVE.set(self.cache.used_slots, engine=name)
        _SRV_KV_BLOCKS.set(self.pool.blocks_in_use, engine=name)
        _SRV_KV_OCC.set(self.pool.blocks_in_use / self.pool.capacity,
                        engine=name)
        if self.host_tier is not None:
            _SRV_HOST_OCC.set(self.host_tier.occupancy, engine=name)
        _SRV_BUCKETS.set(len(self._decode_buckets), engine=name)
        if self._spec_k:
            for slot in range(self.cache.num_slots):
                _SRV_SPEC_EMA.set(float(self._spec_ema[slot]),
                                  engine=name, lane=slot)
        if self._decode_steps:
            _SRV_UTIL.set(self._slot_busy_integral / self._decode_steps,
                          engine=name)
        if self._busy_s > 0:
            _SRV_TPS.set(self._tokens_generated / self._busy_s,
                         engine=name)
        if self._prompt_tokens:
            _SRV_PREFIX_RATIO.set(
                self._prefix_hit_tokens / self._prompt_tokens, engine=name)

    def run(self):
        """Step until every submitted request finished; returns the
        requests retired by decode horizons."""
        out = []
        while self.scheduler.has_work:
            before = self._finished
            out.extend(self.step())
            if (self._finished == before and not self.scheduler.running
                    and self.scheduler.queue_depth
                    and not self._admit_deferred):
                raise RuntimeError("engine stalled with queued work")
        return out

    def drain(self):
        """Graceful shutdown of admission: refuse new submissions, abort
        every still-QUEUED request (cause ``"drain"``), run the in-flight
        lanes to completion, then reclaim the prefix store's (now
        unpinned) blocks and check ``kv_blocks_in_use == 0`` — the
        block-leak invariant a replica must satisfy before the router
        removes it.  Returns every request retired during the drain
        (aborted queued requests first).  The engine is usable again
        afterwards.  With the host tier, the demoted prefix entries are
        dropped too and no host block may stay referenced (a leaked
        lane image)."""
        self._draining = True
        try:
            out = [self.abort(req, cause="drain")
                   for req in list(self.scheduler.queue)]
            # every running lane progresses each step (preempted lanes
            # requeue as resumed and re-admit as slots free), so this
            # ends within the remaining token budget
            while self.scheduler.has_work:
                out.extend(self.step())
        finally:
            self._draining = False
        # every lease is back, so every prefix chain is unpinned and
        # reclaimable; a block the reclaim cannot free is a leak.  The
        # spill hooks are off for this sweep: shutdown eviction is
        # disposal, not demotion
        spill, spill_batch = self.prefix.spill, self.prefix.spill_batch
        self.prefix.spill = self.prefix.spill_batch = None
        try:
            self.prefix.reclaim(self.prefix._held)
        finally:
            self.prefix.spill, self.prefix.spill_batch = spill, spill_batch
        if self.pool.blocks_in_use != 0:
            raise RuntimeError(
                f"drain() left {self.pool.blocks_in_use} KV pool blocks "
                f"referenced ({self.cache.leased_blocks} leased by slot "
                f"tables, {self.prefix._held} pinned by the prefix "
                "store): block-leak invariant violated")
        if self.host_tier is not None:
            self.host_tier.clear_prefixes()
            if self.host_tier.blocks_in_use != 0:
                raise RuntimeError(
                    f"drain() left {self.host_tier.blocks_in_use} host "
                    f"arena blocks referenced "
                    f"({len(self.host_tier._lanes)} lane images): host "
                    "block-leak invariant violated")
        self._publish_gauges()
        return out

    def generate(self, prompts, sampling=None):
        """One prompt (list of ids) or a batch (list of lists); submits,
        drains, and returns the generated ids — a list per prompt, in
        submission order."""
        single = bool(prompts) and np.isscalar(prompts[0])
        batch = [prompts] if single else list(prompts)
        if isinstance(sampling, (list, tuple)):
            reqs = [self.submit(p, s) for p, s in zip(batch, sampling)]
        else:
            reqs = [self.submit(p, sampling) for p in batch]
        self.run()
        outs = [r.output_ids for r in reqs]
        return outs[0] if single else outs

    def counters(self):
        """The JAX engine's ``counters()`` under its key names (host
        numbers only; also this engine's counter provider), plus
        ``grammar_masked_fraction``: the mean over constrained emitted
        tokens of the vocab fraction their mask excluded (the mean of
        the ``serving.grammar_masked_fraction`` histogram).  Left out:
        the XLA-only ``decode_calls`` and the compile counts
        (``decode_compiles``, ``decode_cache_hits``,
        ``prefill_compiles``, ``prefill_cache_hits``).
        ``prefix_insert_calls`` stays 0, as in the JAX engine."""
        c = {
            "queue_depth": self.scheduler.queue_depth,
            "active_slots": self.cache.used_slots,
            "num_slots": self.cache.num_slots,
            "requests_finished": self._finished,
            "tokens_generated": self._tokens_generated,
            "decode_steps": self._decode_steps,
            "decode_horizons": self._decode_horizons,
            "decode_host_syncs": self._host_syncs,
            "wasted_lane_tokens": self._wasted_lane_tokens,
            "prefill_calls": self._prefill_calls,
            "prefill_requests": self._prefill_requests,
            "prefill_chunk_dispatches": self._chunk_dispatches,
            "prefill_chunked_requests": self._chunked_requests,
            "prefix_hit_tokens": self._prefix_hit_tokens,
            "prompt_tokens": self._prompt_tokens,
            "prefix_hit_ratio": (
                self._prefix_hit_tokens / self._prompt_tokens
                if self._prompt_tokens else 0.0),
            "prefix_insert_calls": 0,
            "kv_blocks_in_use": self.pool.blocks_in_use,
            "kv_bytes_read": self._kv_bytes_read,
            "cow_copies": self._cow_copies,
            "preemptions": self._preemptions,
            "kv_swap_ins": self._swap_ins,
            "kv_swap_outs": self._swap_outs,
            "kv_swap_in_bytes": self._swap_in_bytes,
            "kv_swap_out_bytes": self._swap_out_bytes,
            "requests_aborted": self._aborted,
            "deadline_expired": self._deadline_expired,
            "spec_draft_tokens": self._spec_draft_tokens,
            "spec_accepted_tokens": self._spec_accepted_tokens,
            "spec_accept_rate": self._accept_rate(),
            "spec_forced_tokens": self._spec_forced_tokens,
            "grammar_masked_fraction": (self._masked_sum / self._masked_n
                                        if self._masked_n else 0.0),
            "degradation_level": self._degrade_level,
            "degradation_sheds": self._degrade_sheds,
        }
        if self._decode_steps:
            c["slot_utilization"] = (self._slot_busy_integral
                                     / self._decode_steps)
        if self._finished:
            c["ttft_avg_s"] = self._ttft_sum / self._finished
        if self._busy_s > 0:
            c["tokens_per_s"] = self._tokens_generated / self._busy_s
        return c

    def tenant_ledger(self):
        """The per-tenant accounting ledger (tenant None bills to "") as
        a copy: submitted, finished, aborted and tokens generated."""
        return {k: dict(v) for k, v in self._tenants.items()}

    def stats(self):
        """:meth:`counters` plus the port's own timers
        (``prefill_seconds``, ``decode_seconds``, ``decode_tokens``), the
        pool's capacity, the process-wide kernel launch counts
        (``kernel_launches``), the radix store's ``stats()`` under
        ``prefix``, and JAX's ``tenants``, ``draining``, ``degradation``,
        ``kv_pool`` (with the host tier's keys), ``quant``, ``spec``,
        ``structured``, ``memory`` (the ledger's snapshot), ``slo`` and
        ``tracing`` blocks.  ``prompt_tokens`` counts every admitted token, prefix
        hits and re-admissions included.  Host numbers only: safe to
        read from another thread."""
        c = self.counters()
        slab = self._grammar_slab
        lane_steps = self._decode_tokens + self._wasted_lane_tokens
        c.update({
            "prefill_seconds": self._prefill_s,
            "decode_tokens": self._decode_tokens,
            "decode_seconds": self._decode_s,
            "kv_blocks_capacity": self.pool.capacity,
            "wasted_lane_fraction": (self._wasted_lane_tokens / lane_steps
                                     if lane_steps else 0.0),
            "horizon_buckets": sorted(self._horizon_buckets),
            "decode_buckets": sorted(self._decode_buckets),
            "kernel_launches": kernel_launches(),
            "prefill": {
                "chunk_tokens": self._chunk_tokens,
                "chunks_in_flight": len(self._chunking),
                "chunk_count_total": self._chunk_count_total,
                "interference_seconds": self._interference_s,
                "buckets": sorted(self._prefill_buckets),
            },
            "prefix": self.prefix.stats(),
            "tenants": self.tenant_ledger(),
            "draining": self._draining,
            "degradation": {
                "level": self._degrade_level,
                "level_name": DEGRADE_LEVELS[self._degrade_level],
                "transitions": self._degrade_transitions,
                "sheds": self._degrade_sheds,
                "history": list(self._degrade_history[-8:]),
            },
            "kv_pool": {
                "block_size": self._block_size,
                "capacity_blocks": self.pool.capacity,
                "free_blocks": self.pool.free_blocks,
                "blocks_in_use": self.pool.blocks_in_use,
                "leased_blocks": self.cache.leased_blocks,
                "bytes_per_block": self.pool.bytes_per_block,
                "dtype": str(self.pool.store_dtype).replace("torch.", ""),
                "quant_dtype": self.pool.quant_dtype,
            },
            "structured": {
                "enabled": self._structured,
                "constrained_lanes": int(sum(
                    1 for slot in range(self.cache.num_slots)
                    if self._active[slot] and self._dfa_state[slot] != 0)),
                "capacity_states": slab.capacity if slab else 0,
                "states_used": slab.states_used if slab else 0,
                "grammars_installed": slab.grammars_installed
                if slab else 0,
                "table_bytes": slab.device_bytes if slab else 0,
                "compile_cache_hits": self._grammar_cache_hits,
                "compile_cache_misses": self._grammar_cache_misses,
                "compile_cache_entries": len(self._grammar_cache),
                "forced_tokens": self._spec_forced_tokens,
                "forced_drafted": self._spec_forced_drafted,
                "masked_fraction_mean": c["grammar_masked_fraction"],
            },
            "quant": {
                "weight_dtype": self._weight_dtype,
                "kv_cache_dtype": self._kv_quant,
                "quantized_weights": len(self._wq),
                # the parameter bytes a forward reads: int8 payload and
                # scales of the quantized weights, the rest as stored
                "weight_bytes": self._weight_bytes,
            },
            "spec": {
                "k": self._spec_k,
                "adaptive": bool(self.config.spec_adaptive),
                "ngram": int(self.config.spec_ngram),
                "draft_tokens": self._spec_draft_tokens,
                "accepted_tokens": self._spec_accepted_tokens,
                "accept_rate": self._accept_rate(),
                # tokens emitted per verify window (accepted prefix + the
                # bonus token) -> windows, drafting lanes only
                "accept_len_hist": dict(sorted(
                    self._spec_accept_hist.items())),
                "mean_accept_len": (
                    sum(n * c for n, c in self._spec_accept_hist.items())
                    / self._spec_windows if self._spec_windows else 0.0),
                "lane_accept_ema": [round(float(x), 4)
                                    for x in self._spec_ema],
            },
        })
        # tiered KV: lane saves in kv_swap_out_bytes, prefix demotions
        # in kv_demote_bytes
        tier = self.host_tier
        c["kv_pool"].update({
            "cached_blocks": self.prefix._held,
            "host_capacity_blocks": tier.capacity if tier else 0,
            "host_blocks_in_use": tier.blocks_in_use if tier else 0,
            "host_arena_bytes": self._host_arena_bytes(),
            "host_occupancy_ratio": tier.occupancy if tier else 0.0,
            "kv_swap_ins": self._swap_ins,
            "kv_swap_outs": self._swap_outs,
            "kv_swap_in_blocks": self._swap_in_blocks,
            "kv_swap_out_blocks": self._swap_out_blocks,
            "kv_swap_in_bytes": self._swap_in_bytes,
            "kv_swap_out_bytes": self._swap_out_bytes,
            "kv_demote_bytes": self._demote_bytes,
            "kv_swaps_averted_tokens": self._swaps_averted_tokens,
            "swap_policy": self._swap_policy,
            "swap_decisions": dict(self._swap_decisions),
            "swap_uploads": self._swap_uploads,
        })
        if tier is not None:
            c["kv_pool"]["host_tier"] = tier.stats()
        c["memory"] = self.ledger.snapshot()
        if self.slo is not None:
            c["slo"] = self.slo.snapshot()
        if self.recorder is not None:
            c["tracing"] = {
                "live_traces": len(self.recorder.live()),
                "finished_retained": len(self.recorder.recent()),
                "dropped_finished": self.recorder.dropped,
                "capacity": self.recorder.capacity,
            }
        if self.telemetry is not None:
            c["telemetry_port"] = self.telemetry.port
        return c

    def _accept_rate(self):
        return (self._spec_accepted_tokens / self._spec_draft_tokens
                if self._spec_draft_tokens else 0.0)
