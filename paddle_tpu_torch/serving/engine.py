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
auto-sized pool in which no request can starve.  The JAX horizon
``lax.scan`` is a Python loop of ``h`` steps here; device state stays
on the device between horizons and the host syncs once per horizon.

Not ported yet (later slices): the prefix cache, speculative decoding,
chunked prefill, grammar-constrained decoding, the host KV tier, int8
weights and KV, preemption, observability, degradation, fault injection
and the gateway.  Without preemption a decode step that finds the pool
dry raises.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..ops import kernel_launches
from .kv_cache import PagedKVCache
from .sampling import SamplingParams, sample_batch
from .scheduler import Scheduler


@dataclass
class EngineConfig:
    num_slots: int = 8
    max_seq_len: int = 256
    #: smallest prefill bucket; prompts pad up to the next power of two
    min_prefill_bucket: int = 8
    #: largest number of decode steps one horizon runs (power of two)
    max_horizon: int = 8
    #: pool block size in tokens (the JAX engine's prefix block size)
    prefix_block_size: int = 16
    #: total pool blocks incl. scratch block 0; 0 = auto: every slot can
    #: grow to a full row
    kv_pool_blocks: int = 0
    #: kv cache dtype; None = the model's parameter dtype
    cache_dtype: object = None


class Engine:
    """Submit / step / generate over a ``GPTForCausalLM`` (or
    ``LlamaForCausalLM``) that lives on ``device`` (``cuda`` unless the
    caller passes ``"cpu"``)."""

    def __init__(self, model, config=None, device=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}")
        self.model = model.eval()
        self.config = config or EngineConfig()
        mc = model.config
        n = self.config.num_slots
        self._block_size = max(1, int(self.config.prefix_block_size) or 16)
        self.cache = PagedKVCache(
            num_layers=mc.num_hidden_layers, num_slots=n,
            max_seq_len=self.config.max_seq_len,
            block_size=self._block_size, kv_heads=mc.kv_heads,
            head_dim=mc.head_dim,
            dtype=self.config.cache_dtype or model.dtype,
            num_blocks=int(self.config.kv_pool_blocks), device=self.device)
        self.pool = self.cache.pool
        self._max_blocks = self.cache.max_blocks_per_slot
        self.scheduler = Scheduler(n)

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
        self._state_dirty = True
        self._d_state = None     # (tokens, pos, counts, active, eos, limits)
        self._d_tables = None
        self._d_tables_nb = -1

        self._grow = 1           # adaptive-horizon growth state
        self._prefill_calls = 0
        self._prompt_tokens = 0
        self._prefill_s = 0.0
        self._decode_steps = 0
        self._decode_tokens = 0
        self._decode_s = 0.0
        self._tokens_generated = 0
        self._finished = 0
        self._ttft_sum = 0.0

    # ------------------------------------------------------------ model
    def _forward(self, ids, tables, pos, last):
        """Paged forward of ``ids`` [B, s] at ``pos`` [B] through
        ``tables`` [B, nb]; returns the logits [B, vocab] at positions
        ``last`` [B] of the window."""
        views = self.cache.layer_views(tables, pos)
        with torch.no_grad():
            h, _ = self.model.model(ids, caches=views)
            h = h[torch.arange(h.shape[0], device=h.device), last]
            return self.model._logits(h)

    # ------------------------------------------------------------ buckets
    def _admission_bucket(self, req):
        """The prefill length bucket: the prompt length rounded up to a
        power-of-two multiple of ``min_prefill_bucket``."""
        b = self.config.min_prefill_bucket
        while b < req.prompt_len:
            b *= 2
        return min(b, self.config.max_seq_len)

    def _lane_bucket(self, n):
        """Lane count for an n-request prefill batch: the next power of
        two, capped at num_slots."""
        lanes = 1
        while lanes < n:
            lanes *= 2
        return min(lanes, self.config.num_slots)

    def _blocks_needed(self, req):
        return -(-req.prompt_len // self._block_size)

    @staticmethod
    def _pow2_floor(x):
        return 1 << (int(x).bit_length() - 1)

    @staticmethod
    def _pow2_ceil(x):
        return 1 << max(0, int(x) - 1).bit_length()

    def _attn_blocks(self, h):
        """The decode table width ``nb``: enough entries for the deepest
        live row's next ``h`` positions, bucketed to a power of two."""
        mx = max((int(self._pos[s]) for s in self.scheduler.running),
                 default=0)
        need = -(-(mx + h) // self._block_size)
        return min(self._max_blocks, max(1, self._pow2_ceil(need)))

    def _resolve_horizon(self):
        """1 while requests queue (admit at every boundary); otherwise
        grow multiplicatively toward ``max_horizon``, capped by the
        smallest remaining budget of a running request."""
        max_h = max(1, int(self.config.max_horizon))
        if self.scheduler.queue_depth:
            return 1
        rem = min(r.remaining_budget
                  for r in self.scheduler.running.values())
        return self._pow2_floor(max(1, min(max_h, self._grow, rem)))

    # ------------------------------------------------------------ requests
    def submit(self, prompt_ids, sampling=None):
        """Queue one request; returns its ``Request`` handle, whose
        ``output_ids`` fill in as the engine steps."""
        prompt_ids = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        if not prompt_ids:
            raise ValueError("empty prompt")
        sampling = sampling or SamplingParams()
        if len(prompt_ids) + sampling.max_new_tokens > self.config.max_seq_len:
            raise ValueError(
                f"prompt_len {len(prompt_ids)} + max_new_tokens "
                f"{sampling.max_new_tokens} exceeds max_seq_len "
                f"{self.config.max_seq_len}")
        return self.scheduler.submit(prompt_ids, sampling)

    def admit(self):
        """Admission + batched prefill of queued requests into free
        slots: co-bucketed batches (``Scheduler.pop_batch``) prefill in
        one forward each.  A batch whose blocks do not fit waits for
        running requests to retire; with nothing running, the longest
        queue-head prefix that fits is admitted."""
        while self.cache.free_slots and self.scheduler.queue_depth:
            batch = self.scheduler.pop_batch(
                self.cache.free_slots, bucket_of=self._admission_bucket)
            if not batch:
                break
            need = sum(self._blocks_needed(r) for r in batch)
            if need > self.pool.free_blocks:
                self.scheduler.queue.extendleft(reversed(batch))
                if self.scheduler.running:
                    break            # retry after retirements free blocks
                fit, free = [], self.pool.free_blocks
                for r in batch:
                    if self._blocks_needed(r) > free:
                        break
                    free -= self._blocks_needed(r)
                    fit.append(r)
                if not fit:
                    raise RuntimeError(
                        f"KV pool too small: the queue head alone needs "
                        f"{self._blocks_needed(batch[0])} blocks, the pool "
                        f"has {self.pool.free_blocks} free")
                for _ in fit:
                    self.scheduler.queue.popleft()
                batch = fit
            self._prefill_batch(batch)

    def _prefill_batch(self, batch):
        """One batched prefill forward: claim slots and blocks, run the
        padded [lanes, bucket] window at position 0, sample every
        request's first token from its last valid position."""
        n = len(batch)
        bucket = max(self._admission_bucket(r) for r in batch)
        lanes = self._lane_bucket(n)
        bs = self._block_size
        nb = min(self._max_blocks, -(-bucket // bs))
        ids = np.zeros((lanes, bucket), np.int64)
        lengths = np.ones(lanes, np.int64)
        tables = np.zeros((lanes, nb), np.int32)
        seeds = np.zeros(lanes, np.int64)
        temps = np.zeros(lanes, np.float32)
        top_ks = np.zeros(lanes, np.int64)
        top_ps = np.ones(lanes, np.float32)
        slots = []
        for i, req in enumerate(batch):
            slot = self.cache.alloc()
            self.scheduler.start(req, slot)
            for j in range(-(-req.prompt_len // bs)):
                if self.cache.alloc_entry(slot, j) is None:
                    raise RuntimeError(
                        "KV pool exhausted mid-admission: admit()'s "
                        "capacity check diverged from the allocation")
            slots.append(slot)
            ids[i, :req.prompt_len] = req.prompt_ids
            lengths[i] = req.prompt_len
            tables[i] = self.cache.tables[slot, :nb]
            s = req.sampling
            seeds[i], temps[i] = s.seed, s.temperature
            top_ks[i], top_ps[i] = s.top_k, s.top_p
        # padding lanes keep all-zero table rows: their writes go to
        # scratch block 0 and their sampled tokens are dropped
        d = self.device
        t0 = time.perf_counter()
        logits = self._forward(
            torch.from_numpy(ids).to(d), torch.from_numpy(tables).to(d),
            torch.zeros(lanes, dtype=torch.int32, device=d),
            torch.from_numpy(lengths - 1).to(d))
        first = sample_batch(logits, seeds, np.zeros(lanes, np.int64),
                             temps, top_ks, top_ps).tolist()
        self._prefill_s += time.perf_counter() - t0
        self._prefill_calls += 1
        self._prompt_tokens += int(lengths[:n].sum())
        for i, req in enumerate(batch):
            self._finish_prefill_lane(req, slots[i], int(first[i]))

    def _finish_prefill_lane(self, req, slot, tok):
        """Record the first token and arm the lane's decode mirrors."""
        self._tokens_generated += 1
        if req.record_token(tok):
            self._retire(req)
            return
        s = req.sampling
        self._tokens[slot] = tok
        self._pos[slot] = req.prompt_len
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

    def _retire(self, req):
        """Release the request's table entries and slot."""
        self.cache.release_slot_blocks(req.slot)
        self.cache.free(req.slot)
        self.scheduler.finish(req)
        self._finished += 1
        self._ttft_sum += req.ttft
        self._active[req.slot] = False

    def _ensure_blocks(self, h):
        """Extend every active slot's table to cover its next ``h``
        write positions.  No preemption in this port yet: a dry pool
        raises (the auto-sized pool never runs dry)."""
        for slot in sorted(self.scheduler.running):
            if not self._active[slot]:
                continue
            need = min(int(self._pos[slot]) + h, self.config.max_seq_len)
            if not self.cache.ensure_blocks(slot, need):
                raise RuntimeError(
                    f"KV pool exhausted: slot {slot} needs blocks for its "
                    "decode window (raise kv_pool_blocks)")

    # ------------------------------------------------------------ decode
    def _sync_device_state(self):
        if not self._state_dirty:
            return
        d = self.device
        self._d_state = (
            torch.from_numpy(self._tokens).to(d),
            torch.from_numpy(self._pos).to(d),
            torch.from_numpy(self._counts).to(d),
            torch.from_numpy(self._active).to(d),
            torch.from_numpy(self._eos_ids).to(d),
            torch.from_numpy(self._limits).to(d))
        self._state_dirty = False

    def _sync_tables(self, nb):
        if self.cache.tables_dirty or nb != self._d_tables_nb:
            self._d_tables = torch.from_numpy(
                np.ascontiguousarray(self.cache.tables[:, :nb])).to(
                    self.device)
            self._d_tables_nb = nb
            self.cache.tables_dirty = False

    def _dispatch_horizon(self, h):
        """``h`` decode steps over every slot; returns the harvested
        [h, num_slots] token array (-1 for frozen lanes) after the one
        host sync.  A lane that samples its EOS id or reaches its budget
        freezes: its pos and count stop, its token stops changing."""
        self._ensure_blocks(h)
        nb = self._attn_blocks(h)
        self._sync_device_state()
        self._sync_tables(nb)
        tok, p, cnt, act, eos, limits = self._d_state
        # only lanes active at dispatch can emit; the others sample
        # greedily (discarded) so they cost no generator work
        temps = np.where(self._active, self._temps, 0.0)
        zeros = torch.zeros_like(tok)
        t0 = time.perf_counter()
        harvest = []
        for step in range(h):
            logits = self._forward(tok[:, None], self._d_tables, p, zeros)
            e = sample_batch(logits, self._seeds, self._counts + step,
                             temps, self._top_ks, self._top_ps)
            stop = (e == eos) | (cnt + 1 >= limits)
            harvest.append(torch.where(act, e, -1))
            tok = torch.where(act, e, tok)
            cnt = cnt + act
            p = p + act.to(p.dtype)
            act = act & ~stop
        toks = torch.stack(harvest).cpu().numpy()   # the one host sync
        self._decode_s += time.perf_counter() - t0
        self._d_state = (tok, p, cnt, act, eos, limits)
        return toks

    def _harvest(self, toks, active, h, finished):
        """Replay the [h, num_slots] harvested tokens into the running
        requests, keep the host mirrors equal to the frozen device state,
        and retire (appending to ``finished``) the requests that ended."""
        harvested = 0
        for slot, req in active.items():
            done = False
            for step_i in range(h):
                if done:
                    break
                t = int(toks[step_i, slot])
                if t < 0:
                    raise RuntimeError(
                        f"horizon froze slot {slot} at step {step_i} but "
                        "the scheduler still runs its request")
                harvested += 1
                self._tokens[slot] = t
                self._pos[slot] += 1
                done = req.record_token(t)
            self._counts[slot] = req.n_generated
            if done:
                self._retire(req)
                finished.append(req)
        self._tokens_generated += harvested
        self._decode_tokens += harvested

    def step(self):
        """Admit queued requests (prefill), then run one horizon of
        decode steps over every slot.  Returns the requests that
        finished during the horizon."""
        finished = []
        self.admit()
        active = {s: r for s, r in self.scheduler.running.items()
                  if self._active[s]}
        if active:
            h = self._resolve_horizon()
            toks = self._dispatch_horizon(h)
            self._harvest(toks, active, h, finished)
            self._decode_steps += h
            # a stable horizon (nothing retired, nothing waiting) doubles
            # the next one; churn resets it to 1
            if finished or self.scheduler.queue_depth:
                self._grow = 1
            else:
                self._grow = min(max(1, int(self.config.max_horizon)),
                                 max(self._grow, h) * 2)
        return finished

    def run(self):
        """Step until every submitted request finished; returns the
        requests retired by decode horizons."""
        out = []
        while self.scheduler.has_work:
            before = self._finished
            out.extend(self.step())
            if (self._finished == before and not self.scheduler.running
                    and self.scheduler.queue_depth):
                raise RuntimeError("engine stalled with queued work")
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

    def stats(self):
        """Counters of this engine, plus the process-wide kernel launch
        counts (``kernel_launches``).  ``ttft_avg_s``, the mean TTFT of
        the finished requests, is present once one has finished (the JAX
        engine's key and rule)."""
        c = {
            "requests_finished": self._finished,
            "prefill_calls": self._prefill_calls,
            "prompt_tokens": self._prompt_tokens,
            "prefill_seconds": self._prefill_s,
            "decode_steps": self._decode_steps,
            "decode_tokens": self._decode_tokens,
            "decode_seconds": self._decode_s,
            "tokens_generated": self._tokens_generated,
            "kv_blocks_in_use": self.pool.blocks_in_use,
            "kv_blocks_capacity": self.pool.capacity,
            "kernel_launches": kernel_launches(),
        }
        if self._finished:
            c["ttft_avg_s"] = self._ttft_sum / self._finished
        return c
