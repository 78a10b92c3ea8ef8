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

Left out of the JAX engine's ``serving.*`` families: the host-tier
ones (``kv_swap_out_bytes``, ``kv_swap_in_bytes``,
``kv_swaps_averted_flops``, ``host_arena_occupancy_ratio``), the
grammar ones (``spec_forced_tokens``, ``grammar_masked_fraction``) and
the shared ``jit.*`` compile families.

Not ported yet (later slices): grammar-constrained decoding (and the
drafter's grammar ``forced_chain``; ``submit(grammar=...)`` raises
``NotImplementedError``), the host KV tier (and with it the host-tier
branch of :meth:`Engine.drain`), the device-memory ledger and program
cards.
"""

from __future__ import annotations

import time
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..observability import events as _obs_events
from ..observability import metrics as _obs_metrics
from ..observability import tracing as _obs_tracing
from ..observability.server import TelemetryServer
from ..observability.slo import SLOTracker
from ..observability.span import span as _obs_span
from ..ops import kernel_launches
from ..quantization import quantize_for_serving
from .drafter import draft_tokens
from .faults import (DEGRADE_LEVELS, FAULT_POOL_EXHAUSTED,
                     SITE_ENGINE_ADMIT, _SRV_DEGRADATION, _SRV_SHED)
from .kv_cache import PagedKVCache, token_bytes
from .paged_attention import check_kernel_geometry
from .prefix_cache import PrefixCache
from .sampling import (
    SamplingParams, draw_uniforms, row_params, sample_batch, sample_rows,
    sampled_rows,
)
from .scheduler import FINISH_ABORT, FINISHED, RUNNING, WAITING, Scheduler

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
        self._state_dirty = True
        # (tokens, pos, counts, active, eos, limits, hist, gates)
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

        ``grammar`` (structured generation) is not ported yet and
        raises ``NotImplementedError``."""
        if grammar is not None:
            raise NotImplementedError(
                "grammar-constrained decoding is not ported yet "
                "(ROADMAP Queue 1 item 3)")
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
        req = self.scheduler.submit(prompt_ids, sampling, priority=priority,
                                    deadline_s=deadline_s, tenant=tenant)
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

        first = self._dispatch_prefill(entries, bucket,
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
                self._finish_prefill_lane(req, slot, e["toks"], first[i])
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
        token).  Padding lanes keep all-zero table rows: their writes
        land in scratch.  Returns the sampled tokens as a list."""
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
        for i, e in enumerate(entries):
            req = e["req"]
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
            first = sample_batch(logits, seeds, counts, temps, top_ks,
                                 top_ps).tolist()     # the one host sync
        self._prefill_s += time.perf_counter() - t0
        self._prefill_calls += 1
        self._prefill_buckets.add((lanes, bucket))
        _SRV_PREFILL.inc(engine=self._profiler_name)
        return first

    def _finish_prefill_lane(self, req, slot, toks, tok):
        """Arm a lane whose prefill just completed (whole, or the final
        chunk): verify a re-admission's re-sampled token or record the
        first one, then bring the lane's decode mirrors live."""
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
        first = self._dispatch_prefill(entries, self._chunk_tokens,
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
                self._finish_prefill_lane(req, slot, e["toks"], first[i])
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
        """Release the request's blocks, lease and slot."""
        slot = req.slot
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
        self._release_lane(req)
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
        if req.status == WAITING:
            try:
                self.scheduler.queue.remove(req)
            except ValueError:
                raise ValueError(
                    f"cannot abort request {req.request_id}: waiting "
                    "but not queued on this engine") from None
            req.status = FINISHED
        else:
            slot = req.slot
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

    # ------------------------------------------------------------ decode
    def _sync_device_state(self):
        if not self._state_dirty:
            return
        d = self.device
        up = lambda a: None if a is None else torch.from_numpy(a).to(d)
        self._d_state = tuple(up(a) for a in (
            self._tokens, self._pos, self._counts, self._active,
            self._eos_ids, self._limits, self._hist,
            self._spec_gates if self._spec_k else None))
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
        it sees at K = 0.  Greedy lanes draw nothing."""
        w = k + 1
        nb = self._attn_blocks(h, w)
        self._decode_buckets.add((h, nb, k))
        self._sync_device_state()
        self._sync_tables(nb)
        tok, p, cnt, act, eos, limits, hist, gates = self._d_state
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
                drafts = torch.where(gates[:, None], drafts, -1)
                ids = torch.cat([tok[:, None], drafts.clamp_min(0)], 1)
            else:
                ids = tok[:, None]
            logits = self._forward(ids, self._d_tables, p).view(n * w, vocab)
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
        self._d_state = (tok, p, cnt, act, eos, limits, hist, gates)
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
        harvested = wasted = drafted = accepted = 0
        name = self._profiler_name
        floor = float(self.config.spec_accept_floor)
        gated = self._spec_gates.copy()      # the gates the dispatch ran
        for slot, req in active.items():
            done = False
            lane_tokens = lane_accept = 0
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
                for t in row:
                    t = int(t)
                    if t < 0:
                        break                # rejected / unemitted tail
                    n_emit += 1
                    self._tokens[slot] = t
                    self._pos[slot] += 1
                    if self._hist is not None:
                        self._hist[slot, self._pos[slot]] = t
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
            if req.trace is not None and lane_tokens:
                req.trace.add(_obs_tracing.DECODE, horizon=h, spec_k=k,
                              tokens=lane_tokens, accepted=lane_accept)
            if done:
                self._retire(req)
                finished.append(req)
        self._tokens_generated += harvested
        self._decode_tokens += harvested
        self._wasted_lane_tokens += wasted
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
        afterwards.  (The JAX engine's host-tier branch waits for the
        host KV tier.)"""
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
        # reclaimable; a block the reclaim cannot free is a leak
        self.prefix.reclaim(self.prefix._held)
        if self.pool.blocks_in_use != 0:
            raise RuntimeError(
                f"drain() left {self.pool.blocks_in_use} KV pool blocks "
                f"referenced ({self.cache.leased_blocks} leased by slot "
                f"tables, {self.prefix._held} pinned by the prefix "
                "store): block-leak invariant violated")
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
        numbers only; also this engine's counter provider).  Left out:
        the XLA-only ``decode_calls`` and the compile counts
        (``decode_compiles``, ``decode_cache_hits``,
        ``prefill_compiles``, ``prefill_cache_hits``), and the host-tier
        ``kv_swap_ins``, ``kv_swap_outs``, ``kv_swap_in_bytes`` and
        ``kv_swap_out_bytes``.  ``spec_forced_tokens`` (grammar-forced
        drafts) and ``prefix_insert_calls`` stay 0, as the JAX engine
        without a grammar."""
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
            "requests_aborted": self._aborted,
            "deadline_expired": self._deadline_expired,
            "spec_draft_tokens": self._spec_draft_tokens,
            "spec_accepted_tokens": self._spec_accepted_tokens,
            "spec_accept_rate": self._accept_rate(),
            "spec_forced_tokens": 0,
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
        ``kv_pool``, ``quant``, ``spec``, ``slo`` and ``tracing``
        blocks.  ``prompt_tokens`` counts every admitted token, prefix
        hits and re-admissions included.  Host numbers only: safe to
        read from another thread."""
        c = self.counters()
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
