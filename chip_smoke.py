#!/usr/bin/env python3
"""Build and run the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU
and check it: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

Phases, each printing one JSON line per case; any failure raises, so
the script exits nonzero and prints no result:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, and the build of every CUDA kernel from csrc/ (nvcc,
   one process per source, with the ptxas register / spill report and
   the functions whose stack frame or spills are not 0).
2. kernels: each kernel against its plain PyTorch twin on the same card
   inputs — ragged paged attention at the LLaMA-2-7B (32/32/128) and
   LLaMA-3-8B GQA (32/8/128) head layouts, decode (s=1, 8 lanes, ragged
   pos 0..2000), spec verify windows (s=5 at the decode lanes' pos) and
   prefill windows (s=128, s=512), bf16, f32 and an int8 pool with
   per-token scales, and the engine's own prefill geometry (8 lanes x
   1024 at pos 0, bf16 and the int8 pool); then the paged kernels' row
   invariance for
   bf16, f32 and int8 pools, bit for bit (tables widened by scratch
   columns; one s=512 window against 8 windows of 64, 512 one-row decode
   lanes and 103 s=5 verify windows);
   RMSNorm forward at [8,4096], [4096,4096]
   and [8192,4096]; RMSNorm backward at [8192,4096] (bf16, f32) and
   [8,4096]; flash attention forward, dQ and dK/dV at the train phase's
   batch of 2 sequences: 7B MHA s=4096 causal (bf16, f32), 8B GQA s=4096,
   s=1000 (ragged edge), s=1024 not causal, a 256-query block over 1024
   keys and 1024 queries over 256 keys (causal: the first 768 rows see no
   key, so their dQ must be exactly 0 and the visible rows alone must
   give the same dK/dV); and at the SD UNet's attention calls (batch 4, 8
   heads, self over 4096/1024/256/64 tokens and cross over 77, head dims
   40/80/160/160), and at BERT-base's (b=32, 12 heads of 64, not causal,
   s=128 in bf16 and f32, s=512 in bf16), each case with the dK/dV
   kernel's query split
   (dkv_splits); then the bf16 backward's determinism, dQ, dK and dV bit
   for bit over two calls at the LM shape (one query range) and the
   UNet's level-0 cross-attention (16 ranges summed by a second kernel);
   LayerNorm forward and backward at [16384,320], [4096,640], [1024,1280],
   [256,1280] (bf16), [4096,640] (f32), [4096,768] and [16384,768]
   (BERT's width: bert_train's 32 x 128 rows, and 32 x 512) and
   [4096,100] (rows not in whole 16-byte vectors: the CTA-per-row
   kernels); GroupNorm forward and backward at [4,320,64,64],
   [4,960,64,64], [4,2560,8,8] (bf16, 32 groups), [4,320,64,64] (f32),
   [2,6,5,7] with 3 groups (odd spatial size: the scalar streaming
   kernels) and [1,64,128,128] f32 with 1 group (a row too long for
   shared memory: the vector streaming kernels), each call's profile
   holding its own kernel alone; then the norms' determinism, the
   backwards' dx, dw and db bit for bit over two calls at [16384,320]
   and [4,960,64,64], the GroupNorm forward's y, mean and rstd at
   [4,960,64,64] and [4,320,64,64], the LayerNorm forward's at
   [16384,320] and [4096,640] (bf16); then the GroupNorm forward at the
   14 shapes of the UNet step (UNET_GN_SHAPES, bf16): device and
   CUDA-event ms, bound and F.group_norm's device ms, and their sums over
   the step weighted by the calls (gn_fwd_sweep; run alone with
   ``--gn-fwd-sweep``, see sweep_main); and the LayerNorm forward at the
   step's 4 shapes (UNET_LN_SHAPES) likewise, with the backward's device
   and CUDA-event ms beside it (ln_fwd_sweep, ``--ln-fwd-sweep``).
   Tolerances are
   stated with the comparisons (TOLERANCES).  Each case
   prints its kernel, plain and library times and its bound; the
   attention and norm cases (RMSNorm too) also the kernel's and the
   library's device time under torch.profiler (device_ms), which leaves
   out the host launch path, and the attention cases the achieved TFLOP/s and share of
   the bound from it.  Then the
   RMSNorm autograd repair: gradients through the kernel path's
   rms_norm must equal those of the plain forward under torch autograd;
   and a shape, dtype or head dim that no kernel takes (2-D GroupNorm,
   float64 norms, head dim 192, float16 attention) must raise through
   nn.functional on the card, and a serving engine whose pool the paged
   kernel cannot take (block 8, head dim 32) must raise when it is built.
3. engine: LlamaForCausalLM(LLAMA2_7B) in bf16, all 32 layers, random
   weights from a seeded generator on the card, served by
   Engine(num_slots=8, max_seq_len=2048) for 8 requests (prompts 16..1024
   tokens, half greedy, half sampled, 32 new tokens each), with the
   kernels' launch counts checked against the forwards the engine ran.
   The same workload then runs once more under torch.profiler for the
   device's idle share and the kernel time by name.
4. parity: one request through the engine (prefill + 8 greedy decode
   steps) against the uncached full-sequence forward of the same model,
   which runs the flash-attention kernel: two independent kernels (paged
   and flash), both held against the uncached forward over an f32 copy
   of the weights (see PARITY_FACTOR).
   serve_prefix, on the same model and engine geometry (SERVE_SLOTS,
   SERVE_MAX_SEQ), three drives, each with the launch counts reset
   before it, checked after it, and the block-leak invariant after its
   drain: A (PREFIX_DRIVE), a 1000-token system prompt and eight
   suffixes, request 0 alone, then 1-7 together, with a 2 GiB prefix
   store: exactly 1000 hit tokens (62 blocks + an 8-token COW tail) for
   each of 1-7, and against a store of 0 bytes each request's logits
   rows within the parity tolerance of an f32 reference (greedy streams
   up to where they may part: a top-2 gap within 2 x tol); B
   (CHUNK_DRIVE), a 1536-token prompt joining seven decoding requests,
   prefilled in chunks of 256 with a decode step between any two, its
   first-token row held against whole prefill the same way; then
   serve_rows (ROWS_DRIVE), whether a row's logits depend on the number
   of rows in the window's products (decode at 8 lanes vs a prefill
   window, with the shipped row-tiled products and with one F.linear,
   and the decode rate of both); and C (PREEMPT_DRIVE), eight requests
   in a pool of 96 blocks: at least one preemption, every request
   complete, every resume re-sampling its token exactly, the engine's
   degradation ladder on (JAX's default; its ``stats()["degradation"]``
   printed).
   serve_spec (SPEC_DRIVE), same model and geometry: 8 requests of 64
   new tokens, half greedy, half sampled, four prompts repeating one
   48-token span, four random; spec K = 0, K = 4, K = 4 adaptive, K = 4
   with the oracle drafter (oracle_drafter: drafts the K = 0 stream, so
   windows accept), K = 4, K = 0, every run's streams bitwise equal to
   the first; the accept counters and decode rates of each.
   serve_quant: the same requests with weight_dtype = kv_cache_dtype =
   "int8" (bf16 K = 0, int8 K = 0, int8 K = 4, int8 K = 4 oracle, int8
   K = 0, bf16 K = 0): int8 K = 4 and oracle equal int8 K = 0 bitwise;
   drive A in int8 (cache on equals off) and drive C in int8 (at least
   one preemption, every resume exact, the ladder's stats printed); the
   greedy streams' mean LCP
   against bf16, weight bytes and pool bytes a block recorded.
   serve_gateway, on the same model: the engine phase's 8 requests as
   concurrent SSE ``POST /v1/completions`` streams (client threads)
   through a ``Gateway`` over two ``EngineWorker`` replicas, each
   Engine(num_slots=8, max_seq_len=2048) on the one model object, the
   server on 127.0.0.1 at port 0: every stream equal bit for bit to the
   same request's in-process run, the launch totals over both replicas
   equal to the forwards both ran (the counts are process-wide), no
   replica condemned; a capped tenant's second request answers 429 with
   Retry-After, a request whose deadline_s passed in the queue finishes
   "abort", ``/metrics`` passes validate_exposition, and drain() leaves
   no pool block in use on either replica.  Then GATEWAY_DRIVE's crash
   failover, greedy and then seeded, each on a fresh pair of replicas: a
   FAULT_CRASH at SITE_WORKER_DISPATCH (at=2) on the replica a
   1000-token prompt routes to, the stream bitwise equal to its
   uninterrupted run with one failover, the seam in the adopting
   engine's RequestTrace (resumed + emitted tokens = the stream), both
   replicas holding no block afterwards.  Printed: TTFT mean and max
   and decode tokens/s through HTTP beside the same requests' in-process
   run and the engine phase's figures, and each failover's seam gap.
   serve_structured (STRUCT_DRIVE), same model and geometry: a seeded
   32,000-token vocabulary of strings (EOS at id 2, the printable ASCII
   characters, JSON pieces, random 2-6-letter pieces) and a finite JSON
   schema (STRUCT_SCHEMA); 8 constrained requests of at most 64 new
   tokens, half sampled, at K = 0, at K = 4 with forced drafting, then
   unconstrained on an engine without the grammar knobs, then both once
   more (decode rates in turns); 4 constrained and 4 free requests in
   one batch against their separate runs; one request through a
   one-replica Gateway as a json_schema response_format.  Every
   constrained output parses, keeps the schema and ends at EOS; K = 4 =
   K = 0, mixed = separate and HTTP = in-process bit for bit; every
   forced draft a window could emit accepted.  Printed: the grammar's
   compile seconds cold and on a cache hit, the slab's device bytes,
   decode rates, the spec and forced counters.
   serve_tier (TIER_DRIVE), same model: drive C with a 2 GiB pinned host
   arena under kv_swap_policy "auto" and without one, in turns, both
   with a 48-block radix store (a swap-in lands as a prefix hit): the
   streams bitwise equal, swap-outs and swap-ins above 0, the arena
   pinned, no host block after drain; drive C under int8 KV with the
   arena against its recompute run, bitwise; drive A with a 40-block
   store: request 0 alone, a 700-token request that evicts (demotes)
   the system prompt's blocks, then 1-7 together, promoted back from
   the arena, against the drop.  Printed: host->device GB/s, swap bytes
   and synchronized seconds, the resumed lanes' prefill seconds and
   TTFT, and the memory ledger against torch.cuda.memory_allocated.
5. train: LLaMA-2-7B widths cut to 8 layers (TRAIN_LAYERS), bf16 params,
   the fused LM-head loss, AdamW(0.9, 0.95, eps 1e-5, decay 0.1,
   multi_precision) with ClipGradByGlobalNorm(1.0) and LinearWarmup into
   CosineAnnealingDecay, jit.TrainStep on one seeded batch of 2 x 4096
   tokens (labels = ids, unshifted): 2 warm-up and 4 timed steps with
   the five kernels' launch counts asserted per step and a finite,
   strictly decreasing loss; then one step under torch.profiler.
6. train parity: 2 layers of the same widths, b=2, s=2048: one step's
   loss and every parameter's gradient through the kernels in bf16,
   against the same step through the plain functions in bf16 and on an
   f32 copy (see GRAD_PARITY_FACTOR).
7. unet_train: the SD-1.x UNet at full width (UNetConfig(), 0.81 B
   parameters, channels_last=False so every GroupNorm reaches its
   kernel), bf16, seeded random weights made on the card, batch 4 of
   64x64 latents with a [4, 77, 768] context, AdamW(1e-4,
   multi_precision) and mse_loss against the latents as bench_unet,
   through jit.TrainStep: 2 warm-up and 4 timed steps with the seven
   kernels' launch counts asserted per step (GroupNorm 61 + 61,
   LayerNorm 48 + 48, flash 32 each), a finite loss whose last timed
   value is below the first; then one step under torch.profiler.
8. unet_train_parity: a reduced UNet (block_out_channels (320, 640,
   1280), one layer a level: head dims 40, 80, 160 and a concat
   GroupNorm all occur), b=2, 32x32 latents: one step's loss and every
   parameter's gradient through the kernels in bf16, against the plain
   functions in bf16 and on an f32 copy (see GRAD_PARITY_FACTOR).
9. bert_train: BASELINE config 2 as bench_bert: BertForMaskedLM(BERT_BASE)
   in bf16 from seeded weights made on the card, b32 x s128, MLM labels
   at 15 % of positions (-100 elsewhere; 80/10/10 [MASK]/random/kept),
   dropout 0.1 (so attention drops and runs the plain f32 path), AdamW
   (1e-4, 0.9, 0.999, 1e-8, decay 0.01 off biases and LayerNorms,
   multi_precision), LinearWarmup into PolynomialDecay(power 1) to 0,
   clip 1.0, through jit.TrainStep: 3 warm-up and 4 timed steps,
   LayerNorm 26 + 26 and flash 0 launches asserted a step, 49 dropout
   keys a step, a finite loss whose last timed value is below the first
   (a bf16 value: a late step can leave it unchanged); sequences and tokens
   a second, model FLOP/s and its share of 989 TFLOP/s, peak memory,
   the host time of a step's generators; then one step under
   torch.profiler.
10. bert_train_flash: the same with attention dropout 0: flash 12 + 12
   + 12 launches a step, 37 keys; its step time beside bert_train's
   (bert_attention_dropout_cost).
11. bert_parity: BERT-base, bf16, dropout 0: one step's loss and every
   gradient through the kernels against their plain twins in bf16
   (twin_path) and the plain functions on an f32 copy, the dense plain
   path's q/k errors printed beside; an eval forward at s=512 with a
   ragged padding mask
   (8 sequences of 512 down to 1 visible tokens), the visible logits
   likewise; bert_train's first step twice from the same seeds, loss and
   every gradient bit for bit.
12. train_recompute: the train phase's model with hidden dropout 0.1, two
   AdamW steps with use_recompute against the same two without: losses,
   gradients and updated parameters bit for bit; each step's
   forward+backward peak memory above the resident state and its time.
13. optimizers: each of the 13 optimizers 3 steps on BERT-base-shaped f32
   parameters on the card against the CPU (OPTIMIZER_CASES).

The last three lines are the card's nvidia-smi line, the per-kernel JSON
summary and {"ok": true, "device": {...}}.  Exits 1 without a CUDA device.

    python3 chip_smoke.py --gn-fwd-sweep [--variants] [--tree DIR]
    python3 chip_smoke.py --ln-fwd-sweep [--variants] [--tree DIR]
    python3 chip_smoke.py --paged-sweep [--tree DIR]
    python3 chip_smoke.py --serve-phases serve_structured,serve_tier

The last runs the named serve phases alone on the engine phase's model
(no other phase and no kernels line).  The sweeps run the GroupNorm or
the LayerNorm forward sweep alone (or the paged attention cases and
their row-invariance checks): with ``--variants`` also every launch the
kernel takes at each shape
(GroupNorm: mode x cluster size x hold; LayerNorm: threads a row x
vectors a thread x grid), and with ``--tree DIR`` the
``paddle_tpu_torch`` of another checkout (a parent commit's, to compare
two versions in one run on one card).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import re
import itertools
import statistics
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}   # dense, no TF32

# (rtol, fraction of max |plain|) of every kernel vs its plain twin on
# identical inputs: elementwise |kernel - plain| <= rtol |plain| + frac
# max|plain|.  Both sides compute in f32 and differ in summation order
# (and the exp/log/rsqrt ulps).  A bf16 output rounds an f32 value that
# moved by ~1e-6, so it may flip to the neighbouring bf16 value (at most
# 2**-7 of itself; an f16 output, 2**-10); values near 0 are held to 1e-3
# of the tensor's largest.  f32 outputs agree to ~1e-6 relative over 4096
# keys: 1e-4 leaves two orders of margin, and 1e-5 of the largest value
# covers elements that cancel to near 0.
TOLERANCES = {"bfloat16": (2.0 ** -7, 1e-3), "float16": (2.0 ** -10, 1e-3),
              "float32": (1e-4, 1e-5)}
# engine vs the uncached forward: both run in bf16 and round at different
# points through 32 layers of GEMMs whose cuBLAS algorithms differ with M,
# so neither is the truth; the truth is the same forward over an f32 copy
# of the weights.  The engine's logits must be no further from it than
# PARITY_FACTOR times the bf16 uncached forward's own distance, plus
# PARITY_FLOOR of the largest |logit|; a wrong mask, rope position or cache
# write moves them far more than that
PARITY_FACTOR = 2.0
PARITY_FLOOR = 1e-3
# training parity: the kernel path's relative gradient error against the
# f32 plain step must stay within GRAD_PARITY_FACTOR times the plain bf16
# step's own error plus GRAD_PARITY_FLOOR (both bf16 steps round at other
# places through the GEMMs; a wrong gradient kernel moves far more)
GRAD_PARITY_FACTOR = 2.0
GRAD_PARITY_FLOOR = 1e-3
TRAIN_LAYERS = 8               # LLaMA-2-7B has 32; its AdamW state is ~94 GB
TRAIN_BATCH, TRAIN_SEQ = 2, 4096
TRAIN_WARMUP, TRAIN_TIMED = 2, 4
# the SD-UNet train step (SD-1.x widths, 512-px training: 64x64 latents)
UNET_BATCH, UNET_LATENT, UNET_CONTEXT = 4, 64, 77
# the GroupNorm forwards of one such step (32 groups), x shape: calls a
# step; tests/test_torch_norm_plan.py traces the model to the same table
UNET_GN_SHAPES = {
    (4, 960, 64, 64): 1, (4, 640, 64, 64): 2, (4, 1920, 32, 32): 1,
    (4, 320, 64, 64): 13, (4, 1280, 32, 32): 1, (4, 960, 32, 32): 1,
    (4, 640, 32, 32): 11, (4, 2560, 16, 16): 2, (4, 1920, 16, 16): 1,
    (4, 320, 32, 32): 1, (4, 1280, 16, 16): 11, (4, 640, 16, 16): 1,
    (4, 2560, 8, 8): 3, (4, 1280, 8, 8): 12}
# its LayerNorm forwards, [4 * HW, C] rows: calls a step (the same test
# traces them)
UNET_LN_SHAPES = {(16384, 320): 15, (4096, 640): 15, (1024, 1280): 15,
                  (256, 1280): 3}
# BERT-base MLM pretraining as bench_bert (benchmarks/bench_models.py:
# 154-187): b32 x s128, 3 warm-up and 4 timed steps, 15 % of positions
# scored (Devlin et al. 2019, sec. 3.1)
BERT_BATCH, BERT_SEQ = 32, 128
BERT_WARMUP, BERT_TIMED = 3, 4
BERT_MLM_RATE = 0.15
BERT_LR = 1e-4
BERT_FLASH_CASE = f"bert_base/s{BERT_SEQ}/full"


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def ptxas_spills(lines):
    """{function: its ptxas spill line} for each function whose stack
    frame, spill stores or spill loads are not 0."""
    out, fn = {}, None
    for ln in lines:
        if "Function properties for" in ln:
            fn = ln.split("Function properties for", 1)[1].strip()
        elif "spill" in ln and fn is not None and any(
                int(n) for n in re.findall(r"(\d+) bytes", ln)):
            out[fn] = ln
    return out


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn`` over ``reps`` back-to-back launches,
    by CUDA events, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps):
    """Device milliseconds of one ``fn()`` call under torch.profiler (after
    one warm-up call): for each kernel name, the median duration of its
    events times the number of its launches per call.  Unlike
    :func:`cuda_ms` it leaves out the host's launch path, which bounds
    back-to-back calls of a kernel shorter than it.  The profiler can drop
    kernel events (a run read 0.0 for a kernel that ran, and two-thirds
    of another's time), so a mean over all events would undercount; the
    median of those that arrived does not; a window in which none arrived
    is profiled again, up to four windows."""

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    by_name = {}
    for _ in range(4):         # again when no kernel event arrived
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name.setdefault(e.name, []).append(
                    e.time_range.elapsed_us())
        if by_name:
            break
    if not by_name:
        return "not measured"
    return sum(statistics.median(t) * max(1, round(len(t) / reps))
               for t in by_name.values()) / 1e3


def bound(nbytes, ops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, out, ref, dtype_name):
    """Elementwise |out - ref| <= rtol |ref| + frac max|ref| (see
    TOLERANCES); returns the max abs error."""
    import torch

    rtol, frac = TOLERANCES[dtype_name]
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (out - ref).abs()
    limit = rtol * ref.abs() + frac * ref.abs().max()
    if not (err <= limit).all():
        worst = (err - limit).argmax()
        raise AssertionError(
            f"{name}: |kernel - plain| {err.flatten()[worst].item():.3e} "
            f"beyond {limit.flatten()[worst].item():.3e} (rtol {rtol}, "
            f"{frac} of max {ref.abs().max().item():.3e})")
    return err.max().item()


# ------------------------------------------------------------ phase 2
def paged_case(torch, qh, kh, s, pos_list, dtype, quant, seed, dev):
    """Random card inputs for one paged-attention call: pools of
    randn (or int8 with per-token scales), tables of distinct shuffled
    blocks covering each lane's keys 0 .. pos+s-1, scratch elsewhere."""
    d, bs = 128, 16
    g = torch.Generator(device="cpu").manual_seed(seed)
    b = len(pos_list)
    need = [-(-(p + s) // bs) for p in pos_list]
    nb = max(need)
    num_blocks = 1 + sum(need)
    perm = (1 + torch.randperm(num_blocks - 1, generator=g)).to(torch.int32)
    tables = torch.zeros(b, nb, dtype=torch.int32)
    at = 0
    for i, n in enumerate(need):
        tables[i, :n] = perm[at:at + n]
        at += n
    q = torch.randn(b, s, qh, d, generator=g).to(dtype)
    shape = (num_blocks, bs, kh, d)
    if quant:
        k = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
        ks = torch.rand(num_blocks, bs, generator=g) * 0.02 + 0.005
        vs = torch.rand(num_blocks, bs, generator=g) * 0.02 + 0.005
    else:
        k = torch.randn(shape, generator=g).to(dtype)
        v = torch.randn(shape, generator=g).to(dtype)
        ks = vs = None
    pos = torch.tensor(pos_list, dtype=torch.int32)
    mv = lambda t: None if t is None else t.to(dev).contiguous()
    return tuple(mv(t) for t in (q, k, v, tables, pos, ks, vs)), need


def paged_library_fn(torch, q, k, v, tables, pos, ks=None, vs=None):
    """SDPA over K/V gathered to contiguous memory (an int8 pool
    dequantized to q's dtype in advance) with the same visibility mask:
    the library yardstick (set-up not timed)."""
    import torch.nn.functional as F

    b, s, qh, d = q.shape
    kh = k.shape[2]
    length = int(pos.max().item()) + s
    nbl = -(-length // k.shape[1])
    tab = tables[:, :nbl].long()
    if ks is not None:
        k = (k[tab].float() * ks[tab][..., None, None]).to(q.dtype)
        v = (v[tab].float() * vs[tab][..., None, None]).to(q.dtype)
        k, v = k.flatten(0, 1), v.flatten(0, 1)
        tab = torch.arange(b * nbl, device=q.device).view(b, nbl)
    kg = k[tab].reshape(b, -1, kh, d)[:, :length]
    vg = v[tab].reshape(b, -1, kh, d)[:, :length]
    kg = kg.repeat_interleave(qh // kh, dim=2).transpose(1, 2).contiguous()
    vg = vg.repeat_interleave(qh // kh, dim=2).transpose(1, 2).contiguous()
    qt = q.transpose(1, 2).contiguous()
    q_pos = pos.long()[:, None] + torch.arange(s, device=q.device)
    mask = (torch.arange(length, device=q.device)[None, None, :]
            <= q_pos[:, :, None])[:, None]                  # [B,1,s,L]
    return lambda: F.scaled_dot_product_attention(qt, kg, vg,
                                                  attn_mask=mask)


def rates(case, ops):
    """Achieved TFLOP/s and share of the bound from a case's device time."""
    dev_ms = case.get("device_ms")
    if isinstance(dev_ms, float) and dev_ms > 0:
        case["tflops"] = ops / dev_ms / 1e9
        case["bound_share"] = case["bound_ms"] / dev_ms
    return case


def paged_invariance_check(torch, dev):
    """Row invariance of the paged kernels, bit for bit on the card, for
    the bf16 and int8 pools under a bf16 query (the tensor-core kernel,
    the int8 one with per-token scales) and the f32 pool (the FMA
    kernel), both layouts: (a) nb:
    the decode and prefill512 inputs with 7 scratch columns appended to
    every table give equal outputs; (b) the window: the rows of one
    s = 512 window at pos 0 equal the same rows computed as 8 windows of
    64 at pos 0, 64, ..., as 512 one-row decode lanes (lane r at pos r),
    and as 103 lanes of s = 5 spec verify windows at pos 0, 5, ..., 510
    (the last one ragged: its rows past 511 are dropped), over the same
    pool.  Raises on any differing element."""
    from paddle_tpu_torch.serving.paged_attention import paged_attention

    report = {}
    for pname, quant in (("bfloat16", False), ("float32", False),
                         ("int8", True)):
        dtype = torch.float32 if pname == "float32" else torch.bfloat16
        for lname, qh, kh in (("llama2_7b", 32, 32),
                              ("llama3_8b_gqa", 32, 8)):
            for wname, s, pos_list in (("decode", 1, [0, 17, 130, 511, 777,
                                                      1024, 1500, 2000]),
                                       ("prefill512", 512, [0, 700])):
                (q, k, v, tables, pos, ks, vs), _ = paged_case(
                    torch, qh, kh, s, pos_list, dtype, quant, 77, dev)
                wide = torch.cat([tables, torch.zeros_like(tables[:, :7])], 1)
                a = paged_attention(q, k, v, tables, pos, ks, vs)
                b = paged_attention(q, k, v, wide.contiguous(), pos, ks, vs)
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"paged nb invariance {pname}/{lname}/{wname}: "
                        f"{(a != b).sum().item()} elements differ")
                report[f"{pname}/{lname}/{wname}/nb+7"] = "equal"
            (q, k, v, tables, pos, ks, vs), _ = paged_case(
                torch, qh, kh, 512, [0], dtype, quant, 78, dev)
            call = lambda qq, tt, pp: paged_attention(
                qq.contiguous(), k, v, tt.contiguous(), pp, ks, vs)
            whole = call(q, tables, pos)[0]
            pos64 = torch.arange(0, 512, 64, dtype=torch.int32, device=dev)
            win = torch.cat([call(q[:, w:w + 64], tables, pos64[i:i + 1])[0]
                             for i, w in enumerate(range(0, 512, 64))])
            rows = call(q[0][:, None], tables.expand(512, -1),
                        torch.arange(512, dtype=torch.int32, device=dev))[:, 0]
            q5 = torch.zeros(103 * 5, qh, q.shape[-1], dtype=dtype,
                             device=dev)
            q5[:512] = q[0]
            verify = call(q5.view(103, 5, qh, -1), tables.expand(103, -1),
                          torch.arange(0, 515, 5, dtype=torch.int32,
                                       device=dev)).reshape(515, qh, -1)[:512]
            for form, got in (("8 windows of 64", win),
                              ("512 decode rows", rows),
                              ("103 verify windows of 5", verify)):
                if not torch.equal(whole, got):
                    raise AssertionError(
                        f"paged window invariance {pname}/{lname}: {form} "
                        f"differ from one s=512 window in "
                        f"{(whole != got).sum().item()} elements")
                report[f"{pname}/{lname}/s512 vs {form}"] = "equal"
    emit({"phase": "paged_invariance", "pools": ["bfloat16", "float32",
                                                 "int8"], "checks": report})


def paged_cases(torch, dev, summary, seed):
    """The paged kernel against its plain twin, timed beside its bound and
    SDPA, at every window and pool of the kernel phase."""
    from paddle_tpu_torch.serving.paged_attention import (
        paged_attention, paged_attention_plain,
    )

    decode_pos = [0, 17, 130, 511, 777, 1024, 1500, 2000]
    # verify5: a spec K = 4 window at the decode lanes' positions
    windows = [("decode", 1, decode_pos), ("verify5", 5, decode_pos),
               ("prefill128", 128, [0, 700]),
               ("prefill512", 512, [0, 700]),
               ("prefill8x1024", 1024, [0] * 8)]   # the engine's prefill
    layouts = [("llama2_7b", 32, 32), ("llama3_8b_gqa", 32, 8)]
    variants = [("bfloat16", False), ("float32", False), ("bfloat16", True)]
    for lname, qh, kh in layouts:
        for wname, s, pos_list in windows:
            for dname, quant in variants:
                if (wname == "prefill8x1024" or wname == "verify5") and (
                        dname == "float32"):
                    continue
                seed += 1
                dtype = getattr(torch, dname)
                (q, k, v, tables, pos, ks, vs), need = paged_case(
                    torch, qh, kh, s, pos_list, dtype, quant, seed, dev)
                out = paged_attention(q, k, v, tables, pos, ks, vs)
                ref = paged_attention_plain(q, k, v, tables, pos, ks, vs)
                torch.cuda.synchronize()
                name = (f"paged_attention/{lname}/{wname}/{dname}"
                        + ("/int8_pool" if quant else ""))
                err = check_close(name, out, ref, dname)
                del out, ref
                kern = lambda: paged_attention(q, k, v, tables, pos, ks, vs)
                kern_ms, kern_dev = cuda_ms(kern, 20), device_ms(torch, kern, 5)
                plain_ms = cuda_ms(
                    lambda: paged_attention_plain(q, k, v, tables, pos,
                                                  ks, vs), 3)
                lib = paged_library_fn(torch, q, k, v, tables, pos, ks, vs)
                lib_ms, lib_dev = cuda_ms(lib, 10), device_ms(torch, lib, 3)
                del lib
                item = k.element_size()
                d = q.shape[-1]
                kv_tokens = sum(need) * 16
                nbytes = (kv_tokens * kh * d * 2 * item
                          + (kv_tokens * 2 * 4 if quant else 0)
                          + sum(need) * 4 + pos.numel() * 4
                          + 2 * q.numel() * q.element_size())
                keys = sum(p + r + 1 for p in pos_list for r in range(s))
                ops = 4 * keys * qh * d
                b_ms, b_by = bound(nbytes, ops, dname)
                case = rates({"phase": "kernel", "name": name,
                              "q": list(q.shape), "pos": pos_list,
                              "max_abs_err": err, "ms": kern_ms,
                              "device_ms": kern_dev, "plain_ms": plain_ms,
                              "library_ms": lib_ms,
                              "library_device_ms": lib_dev,
                              "bound_ms": b_ms, "bound_by": b_by,
                              "bytes": nbytes, "ops": ops}, ops)
                emit(case)
                if (lname, wname, dname) == ("llama2_7b", "decode",
                                             "bfloat16"):
                    summary["paged_attention_int8" if quant
                            else "paged_attention"] = case
                del q, k, v, tables, pos, ks, vs
    return seed


def kernel_phase(torch, dev):
    from paddle_tpu_torch.ops.rms_norm import rms_norm, rms_norm_plain

    summary = {}
    seed = paged_cases(torch, dev, summary, 0)
    paged_invariance_check(torch, dev)
    for shape in ((8, 4096), (4096, 4096), (8192, 4096)):
        for dname in ("bfloat16", "float32"):
            dtype = getattr(torch, dname)
            g = torch.Generator(device="cpu").manual_seed(seed)
            seed += 1
            x = torch.randn(*shape, generator=g).to(dtype).to(dev)
            w = (1.0 + 0.1 * torch.randn(shape[-1], generator=g)).to(
                dtype).to(dev)
            out = rms_norm(x, w, 1e-6)
            ref = rms_norm_plain(x, w, 1e-6)
            torch.cuda.synchronize()
            name = f"rms_norm/{shape[0]}x{shape[1]}/{dname}"
            err = check_close(name, out, ref, dname)
            kern = lambda: rms_norm(x, w, 1e-6)
            kern_ms, kern_dev = cuda_ms(kern, 50), device_ms(torch, kern, 5)
            plain_ms = cuda_ms(lambda: rms_norm_plain(x, w, 1e-6), 10)
            lib = getattr(torch.nn.functional, "rms_norm", None)
            lib_ms = lib_dev = None
            if lib is not None:
                lib_fn = lambda: lib(x, (shape[-1],), w, 1e-6)
                lib_ms = cuda_ms(lib_fn, 50)
                lib_dev = device_ms(torch, lib_fn, 5)
            nbytes = (2 * x.numel() + w.numel()) * x.element_size()
            b_ms, b_by = bound(nbytes, 4 * x.numel(), dname)
            case = {"phase": "kernel", "name": name, "x": list(shape),
                    "max_abs_err": err, "ms": kern_ms,
                    "device_ms": kern_dev, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "library_device_ms": lib_dev,
                    "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}
            emit(case)
            if (shape, dname) == ((8192, 4096), "bfloat16"):
                summary["rms_norm"] = case
    seed = rms_bwd_cases(torch, dev, summary, seed)
    seed = flash_cases(torch, dev, summary, seed)
    seed = flash_bwd_determinism_check(torch, dev, seed)
    seed = norm_cases(torch, dev, summary, seed)
    seed = ln_fwd_dtype_check(torch, dev, seed)
    seed = norm_bwd_determinism_check(torch, dev, seed)
    seed = gn_fwd_sweep(torch, dev, seed)
    seed = ln_fwd_sweep(torch, dev, seed)
    rms_autograd_check(torch, dev, seed)
    unsupported_check(torch, dev)
    return summary


def rms_bwd_cases(torch, dev, summary, seed):
    """RMSNorm backward kernel vs its plain twin from the same rstd;
    library yardstick: the backward of torch.nn.functional.rms_norm
    (forward not timed)."""
    from paddle_tpu_torch.ops.rms_norm import (
        rms_norm_bwd, rms_norm_bwd_plain, rms_norm_fwd_plain,
    )

    import torch.nn.functional as F

    for shape, dname in (((8192, 4096), "bfloat16"),
                         ((8192, 4096), "float32"), ((8, 4096), "bfloat16")):
        dtype = getattr(torch, dname)
        g = torch.Generator(device="cpu").manual_seed(seed)
        seed += 1
        x = torch.randn(*shape, generator=g).to(dtype).to(dev)
        w = (1.0 + 0.1 * torch.randn(shape[-1], generator=g)).to(dtype).to(dev)
        gy = torch.randn(*shape, generator=g).to(dtype).to(dev)
        _, rstd = rms_norm_fwd_plain(x, w, 1e-6)
        dx, dw = rms_norm_bwd(x, w, rstd, gy)
        dx_p, dw_p = rms_norm_bwd_plain(x, w, rstd, gy)
        torch.cuda.synchronize()
        name = f"rms_norm_bwd/{shape[0]}x{shape[1]}/{dname}"
        err = max(check_close(name + "/dx", dx, dx_p, dname),
                  check_close(name + "/dw", dw, dw_p, dname))
        kern = lambda: rms_norm_bwd(x, w, rstd, gy)
        kern_ms, kern_dev = cuda_ms(kern, 50), device_ms(torch, kern, 5)
        plain_ms = cuda_ms(lambda: rms_norm_bwd_plain(x, w, rstd, gy), 10)
        xl = x.detach().requires_grad_(True)
        wl = w.detach().requires_grad_(True)
        yl = F.rms_norm(xl, (shape[-1],), wl, 1e-6)
        lib_fn = lambda: torch.autograd.grad(yl, (xl, wl), gy,
                                             retain_graph=True)
        lib_ms, lib_dev = cuda_ms(lib_fn, 50), device_ms(torch, lib_fn, 5)
        item = x.element_size()
        nbytes = (3 * x.numel() + 2 * w.numel()) * item + rstd.numel() * 4
        b_ms, b_by = bound(nbytes, 8 * x.numel(), dname)
        case = {"phase": "kernel", "name": name, "x": list(shape),
                "max_abs_err": err, "ms": kern_ms, "device_ms": kern_dev,
                "plain_ms": plain_ms, "library_ms": lib_ms,
                "library_device_ms": lib_dev, "bound_ms": b_ms,
                "bound_by": b_by, "bytes": nbytes}
        emit(case)
        if (shape, dname) == ((8192, 4096), "bfloat16"):
            summary["rms_norm_bwd"] = case
    return seed


def visible_pairs(sq, sk, causal):
    """(query, key) pairs that the causal mask leaves visible, per batch
    row and query head."""
    if not causal:
        return sq * sk
    off = sk - sq
    return sum(min(sk, max(0, i + off + 1)) for i in range(sq))


def flash_cases(torch, dev, summary, seed):
    """Flash forward, dQ and dK/dV kernels vs the plain twins on the same
    card inputs, at the train phase's batch of TRAIN_BATCH sequences and
    at the UNet's attention shapes (:func:`unet_flash_shapes`; the
    backward from the plain forward's out and lse, so each kernel is held
    alone).  Library yardstick: SDPA forward, and its
    backward alone (graph built once, not timed).  Bounds: 4 D flops per
    visible pair and query head forward, 6 D for dQ (QK^T, dO V^T, dS K)
    and 8 D for dK/dV (QK^T, dO V^T, P^T dO, dS^T Q), over the card's
    peak for the dtype, or the bytes of the inputs and outputs over
    3.35 TB/s, whichever is larger."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.flash_attention import (
        dkv_splits, flash_bwd_dkv_kernel, flash_bwd_dq_kernel,
        flash_bwd_plain, flash_fwd_kernel, flash_fwd_plain,
    )

    b, d = TRAIN_BATCH, 128
    cases = [("llama2_7b/s4096/causal", 32, 32, 4096, 4096, True, "bfloat16"),
             ("llama2_7b/s4096/causal", 32, 32, 4096, 4096, True, "float32"),
             ("llama3_8b_gqa/s4096/causal", 32, 8, 4096, 4096, True,
              "bfloat16"),
             ("llama2_7b/s1000/causal", 32, 32, 1000, 1000, True, "bfloat16"),
             ("llama2_7b/s1024/full", 32, 32, 1024, 1024, False, "bfloat16"),
             ("llama2_7b/q256_k1024/causal", 32, 32, 256, 1024, True,
              "bfloat16"),
             ("llama2_7b/q1024_k256/causal", 32, 32, 1024, 256, True,
              "bfloat16")]
    cases = [c + (b, d) for c in cases] + unet_flash_shapes() + \
        bert_flash_shapes()
    for cname, qh, kh, sq, sk, causal, dname, b, d in cases:
        dtype = getattr(torch, dname)
        g = torch.Generator(device="cpu").manual_seed(seed)
        seed += 1
        q = torch.randn(b, sq, qh, d, generator=g).to(dtype).to(dev)
        k = torch.randn(b, sk, kh, d, generator=g).to(dtype).to(dev)
        v = torch.randn(b, sk, kh, d, generator=g).to(dtype).to(dev)
        do = torch.randn(b, sq, qh, d, generator=g).to(dtype).to(dev)
        scale = 1.0 / math.sqrt(d)
        out, lse = flash_fwd_kernel(q, k, v, scale, causal)
        out_p, lse_p = flash_fwd_plain(q, k, v, scale, causal)
        delta = (do.float() * out_p.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        dq = flash_bwd_dq_kernel(q, k, v, do, lse_p, delta, scale, causal)
        dk, dv = flash_bwd_dkv_kernel(q, k, v, do, lse_p, delta, scale,
                                      causal)
        dq_p, dk_p, dv_p = flash_bwd_plain(q, k, v, out_p, lse_p, do, scale,
                                           causal)
        torch.cuda.synchronize()
        name = f"flash/{cname}/{dname}"
        # rows that see no key (causal, sq > sk) have lse = -inf on both
        # sides; the finite rest is compared
        seen = torch.isfinite(lse_p)
        if not torch.equal(seen, torch.isfinite(lse)) or \
                (lse[~seen] != -math.inf).any():
            raise AssertionError(f"{name}/lse: -inf rows differ")
        err_fwd = max(check_close(name + "/out", out, out_p, dname),
                      check_close(name + "/lse", lse[seen], lse_p[seen],
                                  "float32"))
        err_dq = check_close(name + "/dq", dq, dq_p, dname)
        err_dkv = max(check_close(name + "/dk", dk, dk_p, dname),
                      check_close(name + "/dv", dv, dv_p, dname))
        if causal and sq > sk:
            # rows that see no key: dQ exactly 0, and nothing added to
            # dK/dV (the visible rows alone give the same dk, dv)
            blind = sq - sk
            if dq[:, :blind].count_nonzero().item():
                raise AssertionError(f"{name}: nonzero dq on rows that see "
                                     "no key")
            sub = [t[:, blind:].contiguous() for t in (q, do)]
            dk_s, dv_s = flash_bwd_dkv_kernel(
                sub[0], k, v, sub[1], lse_p[:, :, blind:].contiguous(),
                delta[:, :, blind:].contiguous(), scale, causal)
            check_close(name + "/dk_visible_rows", dk, dk_s, dname)
            check_close(name + "/dv_visible_rows", dv, dv_s, dname)
            del dk_s, dv_s, sub
        kern = {"flash_fwd": lambda: flash_fwd_kernel(q, k, v, scale,
                                                     causal),
                "flash_bwd_dq": lambda: flash_bwd_dq_kernel(
                    q, k, v, do, lse_p, delta, scale, causal),
                "flash_bwd_dkv": lambda: flash_bwd_dkv_kernel(
                    q, k, v, do, lse_p, delta, scale, causal)}
        times = {n: (cuda_ms(fn, 5), device_ms(torch, fn, 5))
                 for n, fn in kern.items()}
        plain_fwd_ms = cuda_ms(
            lambda: flash_fwd_plain(q, k, v, scale, causal), 3)
        plain_bwd_ms = cuda_ms(lambda: flash_bwd_plain(
            q, k, v, out_p, lse_p, do, scale, causal), 3)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=qh != kh)
        if causal and sq != sk:
            lib_fwd = lib_bwd = (None, None)  # SDPA's is_causal is top-left
        else:
            lib_fwd = cuda_ms(sdpa, 10), device_ms(torch, sdpa, 5)
            lo = sdpa()
            dot = do.transpose(1, 2)
            sdpa_bwd = lambda: torch.autograd.grad(lo, (qt, kt, vt), dot,
                                                   retain_graph=True)
            lib_bwd = cuda_ms(sdpa_bwd, 10), device_ms(torch, sdpa_bwd, 5)
            del lo, sdpa_bwd
        pairs = visible_pairs(sq, sk, causal) * b * qh
        item = q.element_size()
        qbytes, kbytes = q.numel() * item, k.numel() * item
        rows = b * qh * sq * 4                             # lse / delta
        b_fwd = bound(2 * qbytes + 2 * kbytes + rows, 4 * d * pairs, dname)
        b_dq = bound(3 * qbytes + 2 * kbytes + 2 * rows, 6 * d * pairs,
                     dname)
        b_dkv = bound(2 * qbytes + 4 * kbytes + 2 * rows, 8 * d * pairs,
                      dname)
        ns = dkv_splits(b, sq, sk, kh, d) if dname == "bfloat16" else 1
        base = {"phase": "kernel", "q": list(q.shape), "k": list(k.shape),
                "causal": causal, "pairs": pairs, "dkv_splits": ns}
        per = {"flash_fwd": (err_fwd, plain_fwd_ms, b_fwd, lib_fwd),
               "flash_bwd_dq": (err_dq, plain_bwd_ms, b_dq, lib_bwd),
               "flash_bwd_dkv": (err_dkv, plain_bwd_ms, b_dkv, lib_bwd)}
        flops = {"flash_fwd": 4 * d * pairs, "flash_bwd_dq": 6 * d * pairs,
                 "flash_bwd_dkv": 8 * d * pairs}
        for kname, (err, pms, (b_ms, b_by), (lms, lib_dev)) in per.items():
            case = rates(dict(base, name=f"{kname}/{cname}/{dname}",
                              max_abs_err=err, ms=times[kname][0],
                              device_ms=times[kname][1], plain_ms=pms,
                              library_ms=lms, library_device_ms=lib_dev,
                              bound_ms=b_ms, bound_by=b_by), flops[kname])
            emit(case)
            if (cname, dname) == ("llama2_7b/s4096/causal", "bfloat16"):
                summary[kname] = case
            if (cname, dname) == (BERT_FLASH_CASE, "bfloat16"):
                summary["bert/" + kname] = case
        del out_p, dq_p, dk_p, dv_p
    return seed


def flash_bwd_determinism_check(torch, dev, seed):
    """The bf16 backward kernels give bitwise equal dQ, dK and dV over
    two calls on the same inputs: at the LM shape (one query range) and
    at the UNet's level-0 cross-attention (dkv_splits > 1: f32 partials
    summed in index order by the second kernel)."""
    from paddle_tpu_torch.ops.flash_attention import (
        dkv_splits, flash_bwd_dkv_kernel, flash_bwd_dq_kernel,
        flash_fwd_plain,
    )

    report = {}
    for cname, b, qh, kh, sq, sk, d, causal in (
            ("llama2_7b/s4096/causal", TRAIN_BATCH, 32, 32, 4096, 4096, 128,
             True),
            ("unet_level0_d40/cross", UNET_BATCH, 8, 8, 4096, UNET_CONTEXT,
             40, False)):
        g = torch.Generator(device="cpu").manual_seed(seed)
        seed += 1
        q, k, v, do = (torch.randn(b, s, h, d, generator=g).to(
            torch.bfloat16).to(dev) for s, h in ((sq, qh), (sk, kh),
                                                 (sk, kh), (sq, qh)))
        scale = 1.0 / math.sqrt(d)
        out, lse = flash_fwd_plain(q, k, v, scale, causal)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        runs = [(flash_bwd_dq_kernel(q, k, v, do, lse, delta, scale, causal),)
                + flash_bwd_dkv_kernel(q, k, v, do, lse, delta, scale, causal)
                for _ in range(2)]
        torch.cuda.synchronize()
        ns = dkv_splits(b, sq, sk, kh, d)
        for n, a, c in zip(("dq", "dk", "dv"), *runs):
            if not torch.equal(a, c):
                raise AssertionError(f"flash_bwd_determinism {cname}/{n}: "
                                     f"{(a != c).sum().item()} elements "
                                     f"differ between two calls (NS {ns})")
        report[cname] = {"dkv_splits": ns, "dq_dk_dv": "bitwise equal"}
        del q, k, v, do, out, lse, delta, runs
    if min(r["dkv_splits"] for r in report.values()) != 1 or \
            max(r["dkv_splits"] for r in report.values()) <= 1:
        raise AssertionError(f"flash_bwd_determinism: want NS = 1 and NS > 1 "
                             f"{report}")
    emit({"phase": "flash_bwd_determinism", "dtype": "bfloat16",
          "checks": report})
    return seed


def unet_flash_shapes():
    """The SD UNet's attention calls at UNET_BATCH and 64x64 latents, 8
    heads, not causal: self-attention over the level's HW tokens and
    cross-attention over the context's 77, at head dims 320/8 = 40,
    80 and 160 (40 runs padded to the kernel's 48)."""
    out = []
    for level, d, hw in (("level0", 40, 4096), ("level1", 80, 1024),
                         ("level2", 160, 256), ("mid", 160, 64)):
        for kind, sk in (("self", hw), ("cross", UNET_CONTEXT)):
            out.append((f"unet_{level}_d{d}/{kind}", 8, 8, hw, sk, False,
                        "bfloat16", UNET_BATCH, d))
    return out


def bert_flash_shapes():
    """BERT-base's attention calls (12 heads of 64, not causal) at the
    bert_train batch: s = 128 in bf16 and f32, and s = 512 (the
    bert_parity eval length) in bf16."""
    return [(f"bert_base/s{s}/full", 12, 12, s, s, False, dname,
             BERT_BATCH, 64)
            for s, dname in ((BERT_SEQ, "bfloat16"), (BERT_SEQ, "float32"),
                             (512, "bfloat16"))]


def kernel_names(torch, fn):
    """The names of the kernels one ``fn()`` call launches (after one
    warm-up call), from torch.profiler over three calls; profiled again
    (up to five windows) when no kernel event arrived, as the profiler
    can drop them (see :func:`device_ms`: a run once read [] in three
    windows of one call each for a kernel that ran)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        names = sorted({e.name for e in prof.events()
                        if e.device_type == DeviceType.CUDA})
        if names:
            break
    return names


def norm_cases(torch, dev, summary, seed):
    """LayerNorm and GroupNorm forward and backward kernels vs their
    plain twins on the same card inputs (the backward from the plain
    forward's statistics, so each kernel is held alone), at the UNet
    train step's shapes: LayerNorm over [4 * HW, C] rows, GroupNorm over
    [4, C, H, W] with 32 groups (960 channels at 64x64 is the longest
    row, 30 x 4096 elements); and at shapes that take the backwards'
    other variants (see the module docstring).  Each call's profile
    must hold its own CUDA kernel alone (no torch reduction or cast
    after it), forwards and backwards.  Library yardstick: F.layer_norm
    and F.group_norm, forward and backward (graph built once, not
    timed).  Bounds: bytes (x, y or x, g, dx once each, the affine
    vectors, the f32 statistics) over 3.35 TB/s, or 7 (forward) and 12
    (backward) operations per element, whichever is larger."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.group_norm import (
        group_norm_bwd_kernel, group_norm_bwd_plain, group_norm_fwd_plain,
        group_norm_kernel,
    )
    from paddle_tpu_torch.ops.layer_norm import (
        layer_norm_bwd_kernel, layer_norm_bwd_plain, layer_norm_fwd_plain,
        layer_norm_kernel,
    )

    ln = [((16384, 320), "bfloat16", None), ((4096, 640), "bfloat16", None),
          ((1024, 1280), "bfloat16", None), ((256, 1280), "bfloat16", None),
          ((4096, 640), "float32", None), ((4096, 768), "bfloat16", None),
          ((16384, 768), "bfloat16", None),
          ((4096, 100), "bfloat16", None)]
    gn = [((4, 320, 64, 64), "bfloat16", 32), ((4, 960, 64, 64), "bfloat16", 32),
          ((4, 2560, 8, 8), "bfloat16", 32), ((4, 320, 64, 64), "float32", 32),
          ((2, 6, 5, 7), "bfloat16", 3), ((1, 64, 128, 128), "float32", 1)]
    bwd_names = {"layer_norm": "ln_bwd", "group_norm": "gn_bwd"}
    fwd_keys = {"layer_norm": "ln_fwd", "group_norm": "gn_fwd"}
    for kind, shapes in (("layer_norm", ln), ("group_norm", gn)):
        for shape, dname, groups in shapes:
            dtype = getattr(torch, dname)
            g = torch.Generator(device="cpu").manual_seed(seed)
            seed += 1
            c = shape[-1] if kind == "layer_norm" else shape[1]
            # a large common mean, as activations carry: the variance
            # must not cancel
            x = (3.0 + 2.0 * torch.randn(*shape, generator=g)).to(dtype) \
                .to(dev)
            w = (1.0 + 0.1 * torch.randn(c, generator=g)).to(dtype).to(dev)
            bias = (0.1 * torch.randn(c, generator=g)).to(dtype).to(dev)
            gy = torch.randn(*shape, generator=g).to(dtype).to(dev)
            if kind == "layer_norm":
                args, eps = (), 1e-5
                fwd_k, fwd_p = layer_norm_kernel, layer_norm_fwd_plain
                bwd_k, bwd_p = layer_norm_bwd_kernel, layer_norm_bwd_plain
                lib = lambda x_, w_, b_: F.layer_norm(x_, (c,), w_, b_, eps)
                rows = x.numel() // c
            else:
                args, eps = (groups,), 1e-5
                fwd_k, fwd_p = group_norm_kernel, group_norm_fwd_plain
                bwd_k, bwd_p = group_norm_bwd_kernel, group_norm_bwd_plain
                lib = lambda x_, w_, b_: F.group_norm(x_, groups, w_, b_, eps)
                rows = shape[0] * groups
            out = fwd_k(x, w, bias, *args, eps)
            ref = fwd_p(x, w, bias, *args, eps)
            _, mean, rstd = ref
            grads = bwd_k(x, w, mean, rstd, gy, *args)
            grads_p = bwd_p(x, w, mean, rstd, gy, *args)
            torch.cuda.synchronize()
            name = f"{kind}/{'x'.join(map(str, shape))}/{dname}"
            err_f = max(check_close(f"{name}/{n}", a, r,
                                    dname if n == "y" else "float32")
                        for n, a, r in zip(("y", "mean", "rstd"), out, ref))
            err_b = max(check_close(f"{name}/{n}", a, r, dname)
                        for n, a, r in zip(("dx", "dw", "db"), grads,
                                           grads_p))
            xl, wl, bl = (t.detach().requires_grad_(True)
                          for t in (x, w, bias))
            yl = lib(xl, wl, bl)
            fns = {"fwd": lambda: fwd_k(x, w, bias, *args, eps),
                   "bwd": lambda: bwd_k(x, w, mean, rstd, gy, *args),
                   "lib_fwd": lambda: lib(x, w, bias),
                   "lib_bwd": lambda: torch.autograd.grad(
                       yl, (xl, wl, bl), gy, retain_graph=True)}
            t = {n: (cuda_ms(fn, 20), device_ms(torch, fn, 5))
                 for n, fn in fns.items()}
            names = kernel_names(torch, fns["bwd"])
            if len(names) != 1 or bwd_names[kind] not in names[0]:
                raise AssertionError(f"{kind}_bwd/{name}: one call launched "
                                     f"{names}, want its CUDA kernel alone")
            fwd_names = kernel_names(torch, fns["fwd"])
            if len(fwd_names) != 1 or fwd_keys[kind] not in fwd_names[0]:
                raise AssertionError(f"{name}: one forward call launched "
                                     f"{fwd_names}, want its CUDA kernel "
                                     "alone")
            pf_ms = cuda_ms(lambda: fwd_p(x, w, bias, *args, eps), 5)
            pb_ms = cuda_ms(lambda: bwd_p(x, w, mean, rstd, gy, *args), 5)
            del yl, fns
            item, n_el = x.element_size(), x.numel()
            stats, affine = 2 * rows * 4, 2 * c * w.element_size()
            bound_f = bound(2 * n_el * item + affine + stats, 7 * n_el,
                            dname)
            bound_b = bound(3 * n_el * item + 3 * c * w.element_size()
                            + stats, 12 * n_el, dname)
            for kname, err, (ms, dev_ms), pms, (lms, lib_dev), \
                    (bd_ms, bd_by) in (
                        (kind, err_f, t["fwd"], pf_ms, t["lib_fwd"],
                         bound_f),
                        (kind + "_bwd", err_b, t["bwd"], pb_ms, t["lib_bwd"],
                         bound_b)):
                case = {"phase": "kernel", "name": f"{kname}/"
                        f"{'x'.join(map(str, shape))}/{dname}",
                        "x": list(shape), "max_abs_err": err, "ms": ms,
                        "device_ms": dev_ms, "plain_ms": pms,
                        "library_ms": lms, "library_device_ms": lib_dev,
                        "bound_ms": bd_ms, "bound_by": bd_by}
                if groups is not None:
                    case["groups"] = groups
                case["kernels"] = names if kname.endswith("_bwd") \
                    else fwd_names
                emit(case)
                if dname == "bfloat16" and shape in ((4096, 640),
                                                     (4, 960, 64, 64)):
                    summary[kname] = case
                if (dname, shape) == ("bfloat16",
                                      (BERT_BATCH * BERT_SEQ, 768)):
                    summary["bert/" + kname] = case     # bert_train's rows
    return seed


def ln_fwd_dtype_check(torch, dev, seed):
    """The LayerNorm forward with affine dtypes other than x's (each of w
    and b converted by its own dtype code: the kernels' other
    instantiation) and in float16, against its plain twin, in a row of a
    warp ([4096,640]) and of a CTA ([256,1280])."""
    from paddle_tpu_torch.ops.layer_norm import (
        layer_norm_fwd_plain, layer_norm_kernel,
    )

    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    report = {}
    for shape in ((4096, 640), (256, 1280)):
        for xd, wd, bd in ((bf16, f32, f32), (bf16, f32, bf16),
                           (f32, bf16, f16), (f16, f16, f16)):
            g = torch.Generator(device="cpu").manual_seed(seed)
            seed += 1
            x = (3.0 + 2.0 * torch.randn(*shape, generator=g)).to(xd).to(dev)
            w = (1.0 + 0.1 * torch.randn(shape[1], generator=g)).to(wd).to(dev)
            b = (0.1 * torch.randn(shape[1], generator=g)).to(bd).to(dev)
            out = layer_norm_kernel(x, w, b)
            ref = layer_norm_fwd_plain(x, w, b)
            torch.cuda.synchronize()
            name = (f"layer_norm/{shape[0]}x{shape[1]}/"
                    f"{str(xd)[6:]}_{str(wd)[6:]}_{str(bd)[6:]}")
            tol = str(xd)[6:]
            report[name] = max(check_close(f"{name}/{n}", a, r,
                                           tol if n == "y" else "float32")
                               for n, a, r in zip(("y", "mean", "rstd"), out,
                                                  ref))
    emit({"phase": "ln_fwd_dtypes", "max_abs_err": report})
    return seed


def norm_bwd_determinism_check(torch, dev, seed):
    """The norm backward kernels give bitwise equal dx, dw and db over
    two calls on the same inputs (their sums across blocks run in a
    fixed order, with no floating-point atomics): LayerNorm at
    [16384,320] and GroupNorm at [4,960,64,64], bf16; and the forwards
    bitwise equal y, mean and rstd: GroupNorm (the ranks' partials merged
    in rank order) at [4,960,64,64] and [4,320,64,64], LayerNorm (each
    row's sums in lane order) at [16384,320] and [4096,640], bf16."""
    from paddle_tpu_torch.ops.group_norm import (
        group_norm_bwd_kernel, group_norm_fwd_plain, group_norm_kernel,
    )
    from paddle_tpu_torch.ops.layer_norm import (
        layer_norm_bwd_kernel, layer_norm_fwd_plain, layer_norm_kernel,
    )

    report = {}
    for cname, shape in (("layer_norm_bwd/16384x320", (16384, 320)),
                         ("group_norm_bwd/4x960x64x64", (4, 960, 64, 64))):
        g = torch.Generator(device="cpu").manual_seed(seed)
        seed += 1
        c = shape[-1] if len(shape) == 2 else shape[1]
        x = (3.0 + 2.0 * torch.randn(*shape, generator=g)).to(
            torch.bfloat16).to(dev)
        w = (1.0 + 0.1 * torch.randn(c, generator=g)).to(torch.bfloat16) \
            .to(dev)
        gy = torch.randn(*shape, generator=g).to(torch.bfloat16).to(dev)
        if len(shape) == 2:
            _, mean, rstd = layer_norm_fwd_plain(x, w, torch.zeros_like(w))
            runs = [layer_norm_bwd_kernel(x, w, mean, rstd, gy)
                    for _ in range(2)]
        else:
            _, mean, rstd = group_norm_fwd_plain(x, w, torch.zeros_like(w),
                                                 32)
            runs = [group_norm_bwd_kernel(x, w, mean, rstd, gy, 32)
                    for _ in range(2)]
        torch.cuda.synchronize()
        for n, a, b in zip(("dx", "dw", "db"), *runs):
            if not torch.equal(a, b):
                raise AssertionError(f"norm_bwd_determinism {cname}/{n}: "
                                     f"{(a != b).sum().item()} elements "
                                     "differ between two calls")
        report[cname] = {"dx_dw_db": "bitwise equal"}
        del x, w, gy, runs
    for shape in ((4, 960, 64, 64), (4, 320, 64, 64), (16384, 320),
                  (4096, 640)):
        g = torch.Generator(device="cpu").manual_seed(seed)
        seed += 1
        c = shape[-1] if len(shape) == 2 else shape[1]
        x = (3.0 + 2.0 * torch.randn(*shape, generator=g)).to(
            torch.bfloat16).to(dev)
        w = (1.0 + 0.1 * torch.randn(c, generator=g)).to(
            torch.bfloat16).to(dev)
        b = (0.1 * torch.randn(c, generator=g)).to(torch.bfloat16) \
            .to(dev)
        if len(shape) == 2:
            runs = [layer_norm_kernel(x, w, b) for _ in range(2)]
        else:
            runs = [group_norm_kernel(x, w, b, 32) for _ in range(2)]
        torch.cuda.synchronize()
        kind = "layer_norm" if len(shape) == 2 else "group_norm"
        cname = f"{kind}/{'x'.join(map(str, shape))}"
        for n, a, b_ in zip(("y", "mean", "rstd"), *runs):
            if not torch.equal(a, b_):
                raise AssertionError(f"norm_determinism {cname}/{n}: "
                                     f"{(a != b_).sum().item()} elements "
                                     "differ between two calls")
        report[cname] = {"y_mean_rstd": "bitwise equal"}
        del x, w, b, runs
    emit({"phase": "norm_bwd_determinism", "dtype": "bfloat16",
          "checks": report})
    return seed


def gn_fwd_variants(gn, shape, item):
    """Every launch the GroupNorm forward kernel takes at ``shape`` (32
    groups): staged (mode 0) where the chunk fits shared memory and
    streamed (mode 1, with the plan's hold), at each cluster size S <=
    min(8, Cg); and streamed one CTA a row with each hold."""
    n, c, h, w = shape
    cg, hw = c // 32, h * w
    out = {}
    for mode in (0, 1):
        for s in range(1, min(8, cg) + 1):
            max_ch = -(-cg // s)
            smem = gn.group_norm_fwd_smem(mode, max_ch, hw, item)
            if smem <= gn.SMEM_MAX:
                out[f"mode{mode}/S{s}"] = {
                    "mode": mode, "cluster": s, "smem": smem,
                    "hold": gn.group_norm_fwd_hold(mode, max_ch, hw, item)}
    for k in gn.FWD_HOLDS:
        out[f"mode1/S1/hold{k}"] = dict(out["mode1/S1"], hold=k)
    return out


def gn_fwd_sweep(torch, dev, seed, variants=False):
    """The GroupNorm forward at the 14 shapes of the UNet step
    (UNET_GN_SHAPES, bf16, 32 groups), each checked against its plain
    twin: device ms (profiler), CUDA-event ms over back-to-back calls
    (the host launch path included), the byte bound and F.group_norm's
    device ms; then the step's sums weighted by the calls.  With
    ``variants`` (``--variants``) also the device ms of every launch the
    kernel takes (gn_fwd_variants) beside the plan's own."""
    import importlib

    import torch.nn.functional as F

    gn = importlib.import_module("paddle_tpu_torch.ops.group_norm")
    total = {"device_ms": 0.0, "ms": 0.0, "bound_ms": 0.0,
             "library_device_ms": 0.0}
    for shape, calls in UNET_GN_SHAPES.items():
        g = torch.Generator(device="cpu").manual_seed(seed)
        seed += 1
        x = (3.0 + 2.0 * torch.randn(*shape, generator=g)).to(
            torch.bfloat16).to(dev)
        w = (1.0 + 0.1 * torch.randn(shape[1], generator=g)).to(
            torch.bfloat16).to(dev)
        b = (0.1 * torch.randn(shape[1], generator=g)).to(torch.bfloat16) \
            .to(dev)
        name = f"group_norm/{'x'.join(map(str, shape))}/bfloat16"
        ref = gn.group_norm_fwd_plain(x, w, b, 32)
        err = max(check_close(f"{name}/{n}", a, r,
                              "bfloat16" if n == "y" else "float32")
                  for n, a, r in zip(("y", "mean", "rstd"),
                                     gn.group_norm_kernel(x, w, b, 32), ref))
        kern = lambda: gn.group_norm_kernel(x, w, b, 32)
        lib = lambda: F.group_norm(x, 32, w, b, 1e-5)
        n_el, rows = x.numel(), shape[0] * 32
        b_ms, _ = bound(2 * n_el * 2 + 2 * shape[1] * 2 + 2 * rows * 4,
                        7 * n_el, "bfloat16")
        case = {"phase": "gn_fwd_sweep", "x": list(shape), "calls": calls,
                "max_abs_err": err, "device_ms": device_ms(torch, kern, 5),
                "ms": cuda_ms(kern, 200), "bound_ms": b_ms,
                "library_device_ms": device_ms(torch, lib, 5)}
        plan_fn = getattr(gn, "group_norm_fwd_plan", None)
        if plan_fn is not None:
            n, c, h, w_ = shape
            case["plan"] = plan_fn(n, c, 32, h * w_, 2, True)
        if variants and plan_fn is not None:
            case["variants"] = {}
            for k, p in gn_fwd_variants(gn, shape, 2).items():
                launch = gn._fwd_launch(x, w, b, 32, p)
                check_close(f"{name}/{k}/y", gn._fwd_run(
                    launch, x, w, b, 1e-5)[0], ref[0], "bfloat16")
                case["variants"][k] = device_ms(
                    torch, lambda: gn._fwd_run(launch, x, w, b, 1e-5), 5)
        emit(case)
        for k in total:
            if isinstance(case[k], float):
                total[k] += calls * case[k]
        del x, w, b, ref
    emit({"phase": "gn_fwd_sweep_step", "calls": sum(UNET_GN_SHAPES.values()),
          **{f"{k}_per_step": v for k, v in total.items()}})
    return seed


def ln_fwd_variants(ln, n, h, item):
    """Every launch the LayerNorm forward kernel takes at ``n`` rows of
    ``h`` (aligned, 16-byte vectors) with at most half its vector slots
    empty: each thread count of ``LNF_THREADS`` that holds the row in at
    most ``LNF_VALUES`` values a thread.  A row of a warp or less runs in
    CTAs of 8 warps with the grid at the occupancy cap (each warp walking
    several groups of rows, the next group's loads in flight) and with
    one group of rows a warp (more CTAs than the card holds at once where
    the rows need it); a row of a CTA runs one CTA a row."""
    lib, code = ln._lib(), 1 if item == 2 else 0
    nvec = h * item // 16
    out = {}
    for threads in ln.LNF_THREADS:
        k = -(-nvec // threads)
        if k * 16 // item > ln.LNF_VALUES or 2 * nvec < k * threads:
            continue
        warps = 8 if threads <= 32 else threads // 32
        cap = ln._max_ctas(lib.layer_norm_fwd_max_ctas, "layer_norm", code,
                           code, code, k, threads, warps)
        grids = {"row": n}
        if threads <= 32:
            unit = warps * 32 // threads
            per = -(-n // (unit * cap))
            grids = {"cap": -(-n // (unit * per)), "one": -(-n // unit)}
        for grid, ctas in grids.items():
            if grid == "one" and ctas == grids["cap"]:
                continue
            out[f"T{threads}/k{k}/w{warps}/{grid}"] = {
                "k": k, "threads": threads, "warps": warps, "ctas": ctas,
                "cap": cap}
    return out


def ln_fwd_sweep(torch, dev, seed, variants=False):
    """The LayerNorm forward at the 4 shapes of the UNet step
    (UNET_LN_SHAPES, bf16), each checked against its plain twin: device
    ms (profiler), CUDA-event ms over back-to-back calls (the host launch
    path included; the least of three runs of 200, as the host's cores
    are shared), the byte bound and F.layer_norm's device ms; the
    backward's device and CUDA-event ms beside them (its host path); then
    the step's sums weighted by the calls.  With ``variants``
    (``--variants``) also the device ms of every launch the kernel takes
    (ln_fwd_variants) beside the plan's own."""
    import importlib

    import torch.nn.functional as F

    ln = importlib.import_module("paddle_tpu_torch.ops.layer_norm")
    total = {"device_ms": 0.0, "ms": 0.0, "bound_ms": 0.0,
             "library_device_ms": 0.0, "bwd_device_ms": 0.0, "bwd_ms": 0.0}
    for shape, calls in UNET_LN_SHAPES.items():
        g = torch.Generator(device="cpu").manual_seed(seed)
        seed += 1
        n, h = shape
        x = (3.0 + 2.0 * torch.randn(*shape, generator=g)).to(
            torch.bfloat16).to(dev)
        w = (1.0 + 0.1 * torch.randn(h, generator=g)).to(
            torch.bfloat16).to(dev)
        b = (0.1 * torch.randn(h, generator=g)).to(torch.bfloat16).to(dev)
        gy = torch.randn(*shape, generator=g).to(torch.bfloat16).to(dev)
        name = f"layer_norm/{n}x{h}/bfloat16"
        ref = ln.layer_norm_fwd_plain(x, w, b)
        err = max(check_close(f"{name}/{k}", a, r,
                              "bfloat16" if k == "y" else "float32")
                  for k, a, r in zip(("y", "mean", "rstd"),
                                     ln.layer_norm_kernel(x, w, b), ref))
        _, mean, rstd = ref
        kern = lambda: ln.layer_norm_kernel(x, w, b)
        bwd = lambda: ln.layer_norm_bwd_kernel(x, w, mean, rstd, gy)
        lib = lambda: F.layer_norm(x, (h,), w, b, 1e-5)
        b_ms, _ = bound(2 * n * h * 2 + 2 * h * 2 + 2 * n * 4, 7 * n * h,
                        "bfloat16")
        case = {"phase": "ln_fwd_sweep", "x": list(shape), "calls": calls,
                "max_abs_err": err, "device_ms": device_ms(torch, kern, 5),
                "ms": min(cuda_ms(kern, 200) for _ in range(3)),
                "bound_ms": b_ms,
                "library_device_ms": device_ms(torch, lib, 5),
                "bwd_device_ms": device_ms(torch, bwd, 5),
                "bwd_ms": min(cuda_ms(bwd, 200) for _ in range(3))}
        plan_fn = getattr(ln, "layer_norm_fwd_plan", None)
        if plan_fn is not None:
            lib_ = ln._lib()
            case["plan"] = plan_fn(n, h, 2, True, lambda k, t, warps:
                                   ln._max_ctas(lib_.layer_norm_fwd_max_ctas,
                                                "layer_norm", 1, 1, 1, k, t,
                                                warps))
        if variants and plan_fn is not None:
            case["variants"] = {}
            for k, p in ln_fwd_variants(ln, n, h, 2).items():
                launch = ln._fwd_launch(x, w, b, p)
                check_close(f"{name}/{k}/y", ln._fwd_run(
                    launch, x, w, b, 1e-5)[0], ref[0], "bfloat16")
                case["variants"][k] = [device_ms(
                    torch, lambda: ln._fwd_run(launch, x, w, b, 1e-5), 5),
                    p["ctas"], p["cap"]]
        emit(case)
        for k in total:
            if isinstance(case[k], float):
                total[k] += calls * case[k]
        del x, w, b, gy, ref, mean, rstd
    emit({"phase": "ln_fwd_sweep_step",
          "calls": sum(UNET_LN_SHAPES.values()),
          **{f"{k}_per_step": v for k, v in total.items()}})
    return seed


def rms_autograd_check(torch, dev, seed):
    """The repaired fault: a loss.backward() through rms_norm on the card
    reaches x and the weight, and the gradients equal those of the plain
    forward differentiated by torch autograd."""
    from paddle_tpu_torch.ops.rms_norm import rms_norm, rms_norm_plain

    g = torch.Generator(device="cpu").manual_seed(seed)
    x0 = torch.randn(8192, 4096, generator=g).to(torch.bfloat16).to(dev)
    w0 = (1.0 + 0.1 * torch.randn(4096, generator=g)).to(torch.bfloat16) \
        .to(dev)
    gy = torch.randn(8192, 4096, generator=g).to(torch.bfloat16).to(dev)
    grads = []
    for fn in (rms_norm, rms_norm_plain):
        x = x0.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        (fn(x, w, 1e-6).float() * gy.float()).sum().backward()
        if x.grad is None or w.grad is None:
            raise AssertionError(f"{fn.__name__}: no gradient reached x or w")
        grads.append((x.grad, w.grad))
    torch.cuda.synchronize()
    err = [check_close(f"rms_norm autograd/{n}", a, b, "bfloat16")
           for n, a, b in zip(("dx", "dw"), *grads)]
    emit({"phase": "rms_norm_autograd", "x": [8192, 4096],
          "dtype": "bfloat16", "max_abs_err_dx": err[0],
          "max_abs_err_dw": err[1],
          "reference": "rms_norm_plain under torch autograd"})


def unsupported_check(torch, dev):
    """On the card a shape, dtype or head dim that no kernel takes raises
    through the functionals the models call, and a pool geometry the
    paged kernel cannot take raises when the serving engine is built:
    nothing falls back to plain torch, a plain twin or a library call."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.serving import Engine, EngineConfig

    bf, f64 = torch.bfloat16, torch.float64
    tiny = lambda heads: GPTForCausalLM(GPTConfig(
        vocab_size=128, hidden_size=128, intermediate_size=256,
        num_hidden_layers=1, num_attention_heads=heads), device=dev, dtype=bf)
    engine = lambda heads, **kw: Engine(tiny(heads), EngineConfig(
        num_slots=2, max_seq_len=64, **kw), device=dev)
    rand = lambda *shape, dtype=bf: torch.randn(*shape, dtype=dtype,
                                                device=dev)
    w = torch.ones(16, dtype=bf, device=dev)
    cases = {
        "group_norm/2d_nc": lambda: F.group_norm(rand(4, 16), 4, 1e-5, w, w),
        "group_norm/float64": lambda: F.group_norm(
            rand(4, 16, 8, 8, dtype=f64), 4, 1e-5, w.double(), w.double()),
        "layer_norm/float64": lambda: F.layer_norm(
            rand(8, 16, dtype=f64), 16, w.double(), w.double()),
        "sdpa/head_dim_192": lambda: F.scaled_dot_product_attention(
            rand(1, 8, 2, 192), rand(1, 8, 2, 192), rand(1, 8, 2, 192)),
        "sdpa/float16": lambda: F.scaled_dot_product_attention(
            *(rand(1, 8, 2, 64, dtype=torch.float16) for _ in range(3))),
        # the serving engine checks the paged kernel's geometry when it
        # is built: block 16, head dim 64 or 128
        "engine/prefix_block_size_8": lambda: engine(2, prefix_block_size=8),
        "engine/head_dim_32": lambda: engine(4),
    }
    raised = {}
    for name, fn in cases.items():
        try:
            fn()
        except (TypeError, ValueError) as e:
            raised[name] = f"{type(e).__name__}: {e}"[:160]
        else:
            raise AssertionError(f"unsupported {name} ran on the card; "
                                 "want a raise")
    emit({"phase": "unsupported_raises", "raised": raised})


# ------------------------------------------------------------ phase 3/4
def engine_phase(torch, dev):
    from paddle_tpu_torch.models.llama import LLAMA2_7B, LlamaForCausalLM
    from paddle_tpu_torch.serving import (
        Engine, EngineConfig, SamplingParams, kernel_launches,
        reset_kernel_launches,
    )

    cfg = LLAMA2_7B
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    eng = Engine(model, EngineConfig(num_slots=8, max_seq_len=2048),
                 device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    eng.generate([1, 2, 3, 4], SamplingParams(max_new_tokens=4))  # warm-up

    g = torch.Generator(device="cpu").manual_seed(1234)
    lengths = [16, 40, 100, 200, 350, 500, 750, 1024]
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()
               for n in lengths]
    params = [SamplingParams(max_new_tokens=32) if i % 2 == 0 else
              SamplingParams(max_new_tokens=32, temperature=0.8, top_k=50,
                             top_p=0.95, seed=100 + i)
              for i in range(len(prompts))]
    before = eng.stats()
    reset_kernel_launches()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, sp) for p, sp in zip(prompts, params)]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    after = eng.stats()
    delta = {k: after[k] - before[k] for k in (
        "prefill_calls", "decode_steps", "prompt_tokens", "prefill_seconds",
        "decode_tokens", "decode_seconds")}

    for r in reqs:
        if len(r.output_ids) != 32 or r.finish_reason != "length":
            raise AssertionError(f"request {r.request_id}: "
                                 f"{len(r.output_ids)} tokens, "
                                 f"{r.finish_reason}")
        if not all(0 <= t < cfg.vocab_size for t in r.output_ids):
            raise AssertionError(f"request {r.request_id}: id out of range")
    check_drained(eng)
    layers = cfg.num_hidden_layers
    check_serving_launches(launches, layers, delta["prefill_calls"],
                           delta["decode_steps"])
    ttft = [r.ttft for r in reqs]
    figures = {"phase": "engine", "model": "LLAMA2_7B", "layers": layers,
          "dtype": "bfloat16", "num_slots": 8, "max_seq_len": 2048,
          "requests": len(reqs), "prompt_lengths": lengths,
          "new_tokens_each": 32, "setup_s": setup_s, "wall_s": wall,
          "prefill_dispatches": delta["prefill_calls"],
          "decode_steps": delta["decode_steps"],
          "prefill_tokens_per_s":
              delta["prompt_tokens"] / delta["prefill_seconds"],
          "decode_tokens_per_s":
              delta["decode_tokens"] / delta["decode_seconds"],
          "ttft_mean_s": sum(ttft) / len(ttft), "ttft_max_s": max(ttft),
          "kernel_launches": launches,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(figures)

    profile_phase(torch, eng, prompts, params)

    # ---- phase 4: parity of one request against the uncached forward
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prompt = torch.randint(0, cfg.vocab_size, (200,), generator=g).tolist()
    with logit_tap(eng) as rows:
        req = eng.submit(prompt, SamplingParams(max_new_tokens=9))
        eng.run()
    steps = rows[req.request_id]
    if len(steps) != 9:
        raise AssertionError(f"captured {len(steps)} logit rows, want 9")
    full = torch.tensor([prompt + req.output_ids[:8]], device=dev)
    rows = slice(len(prompt) - 1, len(prompt) + 8)
    with torch.no_grad():
        ref16 = model(full)[0, rows].float()        # [9, vocab]
    del eng
    model32 = copy.deepcopy(model).float()
    with torch.no_grad():
        ref32 = model32(full)[0, rows]
    del model32
    report = []
    for k, got in enumerate(steps):
        scale = ref32[k].abs().max().item()
        e_ref = (ref16[k] - ref32[k]).abs().max().item()
        e_eng = (got - ref32[k]).abs().max().item()
        e_pair = (got - ref16[k]).abs().max().item()
        tol = PARITY_FACTOR * e_ref + PARITY_FLOOR * scale
        report.append({"step": k, "max_abs_logit": scale,
                       "bf16_ref_vs_f32": e_ref, "engine_vs_f32": e_eng,
                       "engine_vs_bf16_ref": e_pair, "tol_vs_f32": tol})
        if not (math.isfinite(e_eng) and e_eng <= tol
                and e_pair <= tol + e_ref):
            raise AssertionError(f"parity step {k}: {report[-1]}")
        top2 = torch.topk(ref32[k], 2).values
        if (top2[0] - top2[1]).item() > 2 * tol and \
                req.output_ids[k] != int(ref32[k].argmax()):
            raise AssertionError(f"parity step {k}: greedy token "
                                 f"{req.output_ids[k]} != reference "
                                 f"argmax {int(ref32[k].argmax())}")
    emit({"phase": "parity", "prompt_len": len(prompt), "steps": report,
          "reference": "uncached full-sequence forward (flash-attention "
                       "and RMSNorm kernels) in bf16 and in an f32 copy of "
                       "the same weights: the paged and the flash kernel, "
                       "both held against the f32 forward"})
    return launches, model, figures


def check_drained(eng):
    """The block-leak invariant after a drain: no table entry is leased
    and the prefix store's blocks are the only ones in use."""
    held = eng.prefix.stats()["used_blocks"]
    if eng.cache.leased_blocks or eng.pool.blocks_in_use != held:
        raise AssertionError(
            f"after the drain: {eng.pool.blocks_in_use} blocks in use, "
            f"{eng.cache.leased_blocks} leased, the prefix store holds "
            f"{held}")


def check_serving_launches(launches, layers, prefill_calls, decode_steps,
                           attn="paged_attention"):
    """Each serving forward (a prefill, a chunk or a decode step, a spec
    verify window included) launches the paged-attention kernel once a
    layer (``attn``: its int8-pool variant under
    ``kv_cache_dtype="int8"``) and the RMSNorm kernel twice a layer plus
    the final norm, and nothing else of the port."""
    forwards = prefill_calls + decode_steps
    want = {attn: layers * forwards,
            "rms_norm": (2 * layers + 1) * forwards}
    for name, n in launches.items():
        if n != want.get(name, 0):
            raise AssertionError(f"{name} launches {n} != "
                                 f"{want.get(name, 0)} for {forwards} "
                                 f"forwards of {layers} layers")
    if not forwards:
        raise AssertionError("the drive ran no forward")


@contextlib.contextmanager
def logit_tap(eng):
    """Record, on the card, each request's logits rows in the order its
    tokens were sampled: the row its (final) prefill took the first
    token from, then one a decode step while it is active.  Yields
    {request_id: [rows]}.  Nothing is synchronized or copied to the
    host, so the engine's timing is unchanged but for the copies."""
    rows, lanes = {}, [None]
    fwd, dispatch = eng._forward, eng._dispatch_prefill

    def tapped_dispatch(entries, bucket, n_lanes):
        lanes[0] = [e["req"] if e["final"] else None for e in entries]
        try:
            return dispatch(entries, bucket, n_lanes)
        finally:
            lanes[0] = None

    def tapped_forward(ids, tables, pos, last=None):
        out = fwd(ids, tables, pos, last)
        pairs = (enumerate(lanes[0]) if lanes[0] is not None else
                 ((s, r) for s, r in eng.scheduler.running.items()
                  if eng._active[s]))
        for i, r in pairs:
            if r is not None:
                # a decode step's one-position window: [1, vocab]
                row = out[i] if last is not None else out[i, 0]
                rows.setdefault(r.request_id, []).append(
                    row.detach().float().clone())
        return out

    own = {n for n in ("_forward", "_dispatch_prefill") if n in vars(eng)}
    eng._forward, eng._dispatch_prefill = tapped_forward, tapped_dispatch
    try:
        yield rows
    finally:
        # deleted again rather than set to the bound methods, which
        # would keep the engine in a reference cycle
        for n, orig in (("_forward", fwd), ("_dispatch_prefill", dispatch)):
            if n in own:
                setattr(eng, n, orig)
            else:
                delattr(eng, n)


# the serve_prefix drives (LLaMA-2-7B at full width, block 16, so a
# block holds 8 MiB of KV): A, prefix reuse behind a shared system
# prompt; B, one long prompt chunked into a running batch; C, a pool too
# small for its rows.  serve_rows runs between B and C.
SERVE_SLOTS, SERVE_MAX_SEQ = 8, 2048
PREFIX_DRIVE = dict(sys_len=1000, suffixes=(16, 24, 40, 64, 100, 150, 200,
                                            256),
                    new_tokens=32, cache_bytes=2 << 30)
CHUNK_DRIVE = dict(short=(64, 200), n_short=7, short_new=96, long=1536,
                   long_new=48, chunk=256)
PREEMPT_DRIVE = dict(pool_blocks=97, prompts=(100, 400), n=8, new_tokens=256)
ROWS_DRIVE = dict(prompt=300, decode_prompts=100, decode_new=64)


def serve_params(i, new_tokens):
    """Even requests greedy, odd ones sampled (T 0.8, top-k 50, top-p
    0.95), as the engine phase."""
    from paddle_tpu_torch.serving import SamplingParams

    if i % 2 == 0:
        return SamplingParams(max_new_tokens=new_tokens)
    return SamplingParams(max_new_tokens=new_tokens, temperature=0.8,
                          top_k=50, top_p=0.95, seed=100 + i)


def drive_a(torch, cfg, rand, g):
    """PREFIX_DRIVE's requests: a shared system prompt and suffixes with
    distinct first tokens.  Returns (prompts, params, submit), where
    ``submit`` (for :func:`run_drive`) runs request 0 alone (cold), then
    queues 1-7 together."""
    pa = PREFIX_DRIVE
    system = rand(pa["sys_len"])
    firsts = torch.randperm(cfg.vocab_size, generator=g)[:len(
        pa["suffixes"])].tolist()
    prompts = [system + [f] + rand(n - 1)
               for f, n in zip(firsts, pa["suffixes"])]
    params = [serve_params(i, pa["new_tokens"]) for i in range(len(prompts))]

    def submit(eng, step):
        reqs = [eng.submit(prompts[0], params[0])]
        while eng.scheduler.has_work:
            step()
        return reqs + [eng.submit(p, sp) for p, sp in
                       zip(prompts[1:], params[1:])]

    return prompts, params, submit


def run_drive(torch, eng, submit, stop_ok=False):
    """Drive the engine: ``submit(eng)`` queues the requests (and may
    step it); then drain.  The launch counts are reset just before and
    read just after, and checked against the forwards the drive ran.
    Every request must run to its budget (``stop_ok``: or end at its
    EOS).  Returns (requests, stats delta, launches, wall seconds,
    steps) where steps lists (chunk dispatches, decode steps) each
    ``step()`` added."""
    from paddle_tpu_torch.serving import kernel_launches, reset_kernel_launches

    keys = ("prefill_calls", "prefill_requests", "prefill_chunk_dispatches",
            "prefill_chunked_requests", "prompt_tokens", "prefix_hit_tokens",
            "prefill_seconds", "decode_steps", "decode_tokens",
            "decode_seconds", "cow_copies", "preemptions")
    before = eng.stats()
    steps = []

    def step():
        a = eng.stats()
        eng.step()
        b = eng.stats()
        steps.append((b["prefill_chunk_dispatches"]
                      - a["prefill_chunk_dispatches"],
                      b["decode_steps"] - a["decode_steps"]))

    torch.cuda.synchronize()
    reset_kernel_launches()
    t0 = time.perf_counter()
    reqs = submit(eng, step)
    while eng.scheduler.has_work:
        step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    after = eng.stats()
    delta = {k: after[k] - before[k] for k in keys}
    check_serving_launches(
        launches, eng.model.config.num_hidden_layers, delta["prefill_calls"],
        delta["decode_steps"], "paged_attention_int8"
        if eng.pool.quant_dtype else "paged_attention")
    for r in reqs:
        full = (r.finish_reason == "length"
                and len(r.output_ids) == r.sampling.max_new_tokens)
        stopped = (stop_ok and r.finish_reason == "eos"
                   and r.output_ids[-1] == r.sampling.eos_token_id)
        if (not (full or stopped)
                or not all(0 <= t < eng.model.config.vocab_size
                           for t in r.output_ids)):
            raise AssertionError(f"request {r.request_id}: "
                                 f"{len(r.output_ids)} tokens, "
                                 f"{r.finish_reason}")
    check_drained(eng)
    return reqs, delta, launches, wall, steps


def drive_summary(reqs, delta, wall):
    ttft = [r.ttft for r in reqs]
    return {"wall_s": wall, "prefill_s": delta["prefill_seconds"],
            "prefill_calls": delta["prefill_calls"],
            "prompt_tokens": delta["prompt_tokens"],
            "prefix_hit_tokens": delta["prefix_hit_tokens"],
            "computed_tokens": delta["prompt_tokens"]
            - delta["prefix_hit_tokens"],
            "decode_steps": delta["decode_steps"],
            "decode_tokens_per_s":
                delta["decode_tokens"] / delta["decode_seconds"],
            "ttft_mean_s": sum(ttft) / len(ttft), "ttft_max_s": max(ttft)}


@contextlib.contextmanager
def host_timers(obj, names):
    """Sum the wall seconds and count the calls of ``obj``'s methods
    ``names`` while the block runs; yields {name: [seconds, calls]}."""
    spent = {n: [0.0, 0] for n in names}
    orig = {n: getattr(obj, n) for n in names}
    own = {n for n in names if n in vars(obj)}

    def timed(name):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return orig[name](*a, **kw)
            finally:
                spent[name][0] += time.perf_counter() - t0
                spent[name][1] += 1
        return call

    for n in names:
        setattr(obj, n, timed(n))
    try:
        yield spent
    finally:
        # a method wrapped on an instance is deleted again, not set to
        # the bound method (which would keep the instance in a cycle)
        for n in names:
            if n in own:
                setattr(obj, n, orig[n])
            else:
                delattr(obj, n)


@contextlib.contextmanager
def call_timer(obj, name, sync=None, keep=lambda result: True, tag=None):
    """Record the wall seconds of each call of ``obj.name`` while the
    block runs (with ``sync``, called on both sides, so device work the
    call queued is included; ``keep`` filters by the call's result;
    with ``tag``, each entry is ``(seconds, tag(*args))``); yields the
    list.  The instance attribute is removed afterwards, so no
    reference cycle keeps ``obj`` alive."""
    orig, spent = getattr(obj, name), []

    def call(*a, **kw):
        if sync:
            sync()
        t = time.perf_counter()
        r = orig(*a, **kw)
        if sync:
            sync()
        if keep(r):
            dt = time.perf_counter() - t
            spent.append((dt, tag(*a, **kw)) if tag else dt)
        return r

    setattr(obj, name, call)
    try:
        yield spent
    finally:
        delattr(obj, name)


def free_device_memory(torch):
    """Hand the memory of dropped engines back now: collect what a
    reference cycle still holds, then empty the allocator's cache."""
    gc.collect()
    torch.cuda.empty_cache()


def reference_rows(torch, model, model32, prompt, outputs, n):
    """The uncached forward's logits rows that sampled ``outputs[:n]``
    after ``prompt``, in bf16 and on the f32 copy, and each row's parity
    tolerance (the parity phase's rule)."""
    full = torch.tensor([list(prompt) + list(outputs[:n - 1])],
                        device=model.device)
    rows = slice(len(prompt) - 1, len(prompt) - 1 + n)
    with torch.no_grad():
        r16 = model(full)[0, rows].float()
        r32 = model32(full)[0, rows]
    tol = [PARITY_FACTOR * (a - b).abs().max().item()
           + PARITY_FLOOR * b.abs().max().item() for a, b in zip(r16, r32)]
    return r16, r32, tol


def stream_parity(name, got, ref, got_toks, ref_toks, refs, greedy):
    """Hold ``got``'s logits rows against the f32 reference of ``ref``'s
    stream: every row up to the first token where the two streams part
    within its tolerance, and the streams may part only where the
    reference's top-2 gap is within 2 x tol (sampled streams: the first
    row only).  Returns the report."""
    r16, r32, tol = refs
    n = len(r32) if greedy else 1
    worst, parted = 0.0, None
    for k in range(n):
        for rows in (got, ref):
            e = (rows[k] - r32[k]).abs().max().item()
            if not (math.isfinite(e) and e <= tol[k]):
                raise AssertionError(f"{name}: row {k} {e} > tol {tol[k]}")
            worst = max(worst, e / tol[k])
        if greedy and got_toks[k] != ref_toks[k]:
            top = r32[k].topk(2).values
            top2 = (top[0] - top[1]).item()
            if top2 > 2 * tol[k]:
                raise AssertionError(f"{name}: greedy token {k} "
                                     f"{got_toks[k]} != {ref_toks[k]} at a "
                                     f"top-2 gap {top2} > 2 x tol {tol[k]}")
            parted = k
            break
    return {"rows_checked": k + 1, "worst_err_over_tol": worst,
            "parted_at": parted, "first_row_bitwise":
                bool((got[0] == ref[0]).all()),
            "first_row_logits_differing": int((got[0] != ref[0]).sum()),
            "stream_bitwise": list(got_toks) == list(ref_toks)}


def serve_prefix_phase(torch, dev, model):
    """Drives A (prefix reuse), B (chunked prefill) and C (preemption) on
    the engine phase's model, with ``serve_rows`` between B and C; the
    f32 references for A's and B's parity checks come from one f32 copy
    of the weights, made after A and B free their pools."""
    from paddle_tpu_torch.serving import Engine, EngineConfig

    cfg = model.config
    layers = cfg.num_hidden_layers
    g = torch.Generator(device="cpu").manual_seed(4321)
    rand = lambda n: torch.randint(0, cfg.vocab_size, (n,),
                                   generator=g).tolist()
    torch.backends.cuda.matmul.allow_tf32 = False
    engine = lambda **kw: Engine(model, EngineConfig(
        num_slots=SERVE_SLOTS, max_seq_len=SERVE_MAX_SEQ, **kw), device=dev)
    launches = {}

    # ---- A: a shared system prompt, eight suffixes with distinct first
    # tokens; request 0 alone (cold), then 1-7 together
    pa = PREFIX_DRIVE
    prompts_a, _, submit_a = drive_a(torch, cfg, rand, g)
    runs_a = {}
    for mode, budget in (("cache_on", pa["cache_bytes"]), ("cache_off", 0)):
        eng = engine(prefix_cache_bytes=budget)
        eng.generate([1, 2, 3, 4], serve_params(0, 4))      # warm-up
        # the host's admission work: the radix walks (every queued
        # request's lookup at every pop_batch, the acquires, the
        # adoptions) within admit(), whose time includes the prefills
        with logit_tap(eng) as rows, \
                host_timers(eng.prefix, ("lookup", "acquire", "adopt")) \
                as radix, host_timers(eng, ("admit",)) as admit:
            reqs, delta, launches[f"A_{mode}"], wall, _ = run_drive(
                torch, eng, submit_a)
        hits = [r.prefix_hit_tokens for r in reqs]
        bs = eng.cache.block_size
        if mode == "cache_on":
            tail = pa["sys_len"] % bs
            want = [0] + [pa["sys_len"]] * (len(reqs) - 1)
            if (hits != want or delta["prefix_hit_tokens"] != sum(want)
                    or delta["cow_copies"] != (len(reqs) - 1 if tail else 0)):
                raise AssertionError(f"drive A hits {hits}, engine "
                                     f"{delta['prefix_hit_tokens']}, COW "
                                     f"{delta['cow_copies']}: want {want}")
        elif any(hits) or delta["cow_copies"]:
            raise AssertionError(f"drive A cache off hit {hits}")
        runs_a[mode] = dict(reqs=reqs, rows=rows, summary=dict(
            drive_summary(reqs, delta, wall),
            cow_copies=delta["cow_copies"], hits=hits,
            admit_s=admit["admit"][0],
            radix_host_s={k: v[0] for k, v in radix.items()},
            radix_calls={k: v[1] for k, v in radix.items()},
            prefix_store=eng.prefix.stats()))
        del eng
        torch.cuda.empty_cache()

    # ---- B: seven short requests decoding; after the first step one
    # long prompt joins, prefilled in chunks between decode horizons
    pb = CHUNK_DRIVE
    lo, hi = pb["short"]
    prompts_b = [rand(int(n)) for n in torch.randint(
        lo, hi + 1, (pb["n_short"],), generator=g)]
    params_b = [serve_params(i, pb["short_new"])
                for i in range(pb["n_short"])]
    long_prompt = rand(pb["long"])

    def submit_b(eng, step):
        reqs = [eng.submit(p, sp) for p, sp in zip(prompts_b, params_b)]
        step()
        return reqs + [eng.submit(long_prompt,
                                  serve_params(0, pb["long_new"]))]

    drive_b = {}
    for mode, chunk in (("chunked", pb["chunk"]), ("whole", 0)):
        eng = engine(prefill_chunk_tokens=chunk)
        with logit_tap(eng) as rows:
            reqs, delta, launches[f"B_{mode}"], wall, steps = run_drive(
                torch, eng, submit_b)
        want_chunks = -(-pb["long"] // pb["chunk"]) - 1 if chunk else 0
        if (delta["prefill_chunked_requests"] != (1 if chunk else 0)
                or delta["prefill_chunk_dispatches"] != want_chunks):
            raise AssertionError(
                f"drive B {mode}: {delta['prefill_chunked_requests']} "
                f"chunked requests, {delta['prefill_chunk_dispatches']} "
                f"chunk dispatches; want {want_chunks}")
        chunk_steps = [i for i, (c, _) in enumerate(steps) if c]
        if chunk and any(steps[i][1] < 1 for i in chunk_steps[:-1]):
            raise AssertionError(f"drive B: a chunk without a decode step "
                                 f"before the next: {steps}")
        drive_b[mode] = dict(reqs=reqs, rows=rows, summary=dict(
            drive_summary(reqs, delta, wall),
            chunk_dispatches=delta["prefill_chunk_dispatches"],
            chunk_steps=chunk_steps,
            decode_steps_after_each_chunk=[steps[i][1]
                                           for i in chunk_steps],
            interference_s=eng.stats()["prefill"]["interference_seconds"]))
        del eng
        torch.cuda.empty_cache()

    # ---- parity of A and B against the f32 copy
    model32 = copy.deepcopy(model).float()
    report_a = []
    on, off = runs_a["cache_on"], runs_a["cache_off"]
    for i, (r_on, r_off) in enumerate(zip(on["reqs"], off["reqs"])):
        refs = reference_rows(torch, model, model32, prompts_a[i],
                              r_off.output_ids, pa["new_tokens"])
        report_a.append(dict(request=i, **stream_parity(
            f"drive A request {i}", on["rows"][r_on.request_id],
            off["rows"][r_off.request_id], r_on.output_ids,
            r_off.output_ids, refs, greedy=i % 2 == 0)))
    ch, wh = drive_b["chunked"], drive_b["whole"]
    r_ch, r_wh = ch["reqs"][-1], wh["reqs"][-1]
    refs = reference_rows(torch, model, model32, long_prompt,
                          r_wh.output_ids, 1)
    report_b = stream_parity("drive B long request",
                             ch["rows"][r_ch.request_id],
                             wh["rows"][r_wh.request_id], r_ch.output_ids,
                             r_wh.output_ids, refs, greedy=False)
    del model32, refs
    torch.cuda.empty_cache()
    emit({"phase": "serve_prefix", "drive": "A", "model": "LLAMA2_7B",
          "layers": layers, "system_prompt": pa["sys_len"],
          "suffixes": list(pa["suffixes"]),
          "new_tokens_each": pa["new_tokens"],
          "prefix_cache_bytes": pa["cache_bytes"],
          "cache_on": on["summary"], "cache_off": off["summary"],
          "streams_bitwise": all(r["stream_bitwise"] for r in report_a),
          "first_rows_logits_differing": sum(
              r["first_row_logits_differing"] for r in report_a),
          "parity": report_a})
    emit({"phase": "serve_prefix", "drive": "B", "short_requests":
          [len(p) for p in prompts_b], "long_prompt": pb["long"],
          "chunk_tokens": pb["chunk"], "chunked": ch["summary"],
          "whole": wh["summary"], "long_request_parity": report_b,
          "bitwise": report_b["first_row_bitwise"],
          "logits_differing": report_b["first_row_logits_differing"]})

    serve_rows_phase(torch, dev, model, engine, rand)

    # ---- C: eight requests whose rows need ~2.6x the pool's blocks
    pc = PREEMPT_DRIVE
    lo, hi = pc["prompts"]
    prompts_c = [rand(int(n)) for n in torch.randint(
        lo, hi + 1, (pc["n"],), generator=g)]
    eng = engine(kv_pool_blocks=pc["pool_blocks"], prefix_cache_bytes=0)
    reqs, delta, launches["C"], wall, _ = run_drive(
        torch, eng, lambda e, step: [
            e.submit(p, serve_params(i, pc["new_tokens"]))
            for i, p in enumerate(prompts_c)])
    if delta["preemptions"] < 1 or eng.pool.blocks_in_use:
        raise AssertionError(f"drive C: {delta['preemptions']} preemptions, "
                             f"{eng.pool.blocks_in_use} blocks in use")
    bs = eng.cache.block_size
    emit({"phase": "serve_prefix", "drive": "C",
          "kv_pool_blocks": pc["pool_blocks"],
          "degradation": eng.stats()["degradation"],
          "pool_gib": eng.pool.capacity * eng.pool.bytes_per_block / 2 ** 30,
          "prompt_lengths": [len(p) for p in prompts_c],
          "blocks_for_all_rows": sum(-(-(len(p) + pc["new_tokens"]) // bs)
                                     for p in prompts_c),
          "preemptions": delta["preemptions"],
          "resumed_without_divergence": True,
          **drive_summary(reqs, delta, wall)})
    del eng
    torch.cuda.empty_cache()
    return {k: sum(run[k] for run in launches.values())
            for k in launches["C"]}


def serve_rows_phase(torch, dev, model, engine, rand):
    """Does a row's result depend on how many rows its products have?
    The logits of one request's last prompt row two ways, (i) sampled
    by a decode step at 8 lanes after a prefill of the rest, (ii) from a
    prefill window over the whole prompt, and layer 0's q projection of
    that row at M = 8 and at M = the window; each with the serving
    path's row-tiled products (``row_linear``, as shipped) and with one
    ``F.linear`` over the whole window (``ROW_TILE = 0``).  Then the
    decode rate of the same 8 requests both ways, in turns."""
    from paddle_tpu_torch.models import gpt

    pr = ROWS_DRIVE
    prompt = rand(pr["prompt"])
    eng = engine()
    slot = eng.cache.alloc()
    eng.cache.ensure_blocks(slot, len(prompt))
    n = eng.config.num_slots
    tab = lambda w: torch.from_numpy(eng.cache.tables[[slot], :w]).to(dev)
    nb = eng._table_width(len(prompt))
    zero = torch.zeros(1, dtype=torch.long, device=dev)
    decode_tables = torch.zeros(n, nb, dtype=torch.int32, device=dev)
    decode_tables[0] = tab(nb)[0]
    out, tile = {}, gpt.ROW_TILE
    try:
        for mode, rows in (("row_tiled", tile), ("one_linear", 0)):
            gpt.ROW_TILE = rows
            window = eng._forward(
                torch.tensor([prompt], device=dev), tab(nb),
                torch.zeros(1, dtype=torch.int32, device=dev),
                torch.tensor([len(prompt) - 1], device=dev))[0].float()
            eng._forward(torch.tensor([prompt[:-1]], device=dev), tab(nb),
                         torch.zeros(1, dtype=torch.int32, device=dev),
                         zero)
            ids = torch.zeros(n, 1, dtype=torch.long, device=dev)
            ids[0, 0] = prompt[-1]
            pos = torch.zeros(n, dtype=torch.int32, device=dev)
            pos[0] = len(prompt) - 1
            decode = eng._forward(ids, decode_tables, pos,
                                  torch.zeros(n, dtype=torch.long,
                                              device=dev))[0].float()
            with torch.no_grad():
                layer0 = model.model.layers[0]
                x = layer0.input_layernorm(model.model.embed_tokens(
                    torch.tensor([prompt], device=dev)))[0]
                w = layer0.self_attn.q_proj.weight
                q_window = gpt.row_linear(x, w)[-1]
                q_m8 = gpt.row_linear(
                    torch.cat([x[-1:], x[:n - 1]]), w)[0]
            out[mode] = {
                "logits_differing": int((window != decode).sum()),
                "logits_max_abs_diff": (window - decode).abs().max().item(),
                "greedy_equal": int(window.argmax()) == int(decode.argmax()),
                "q_proj_differing": int((q_window != q_m8).sum()),
                "q_proj_max_abs_diff":
                    (q_window.float() - q_m8.float()).abs().max().item()}
        eng.cache.release_slot_blocks(slot)
        eng.cache.free(slot)
        # decode rate, in turns: row-tiled, one linear, one linear, row-tiled
        prompts = [rand(pr["decode_prompts"]) for _ in range(n)]
        rates = {"row_tiled": [], "one_linear": []}
        for mode in ("row_tiled", "one_linear", "one_linear", "row_tiled"):
            gpt.ROW_TILE = tile if mode == "row_tiled" else 0
            before = eng.stats()
            eng.generate(prompts, serve_params(0, pr["decode_new"]))
            torch.cuda.synchronize()
            after = eng.stats()
            rates[mode].append(
                (after["decode_tokens"] - before["decode_tokens"])
                / (after["decode_seconds"] - before["decode_seconds"]))
    finally:
        gpt.ROW_TILE = tile
    emit({"phase": "serve_rows", "prompt": len(prompt), "decode_lanes": n,
          "window_rows": len(prompt), "row_tile": tile, **out,
          "decode_tokens_per_s": rates,
          "note": "row_tiled is the serving path as shipped"})
    if out["row_tiled"]["logits_differing"] or \
            out["row_tiled"]["q_proj_differing"]:
        raise AssertionError(f"serve_rows: the row-tiled serving path is not "
                             f"row invariant: {out['row_tiled']}")
    del eng
    torch.cuda.empty_cache()


# serve_spec and serve_quant: the serve workload's model and engine
# geometry (SERVE_SLOTS, SERVE_MAX_SEQ); 8 requests, half greedy, half
# sampled; four prompts repeat one 48-token span (the edit / summarize
# pattern, where the output copies the input and the drafter finds
# matches), four are random
SPEC_DRIVE = dict(n=8, new_tokens=64, span=48, repeat_len=(256, 512),
                  random_len=(64, 512), k=4, seed=2024)


def spec_workload(torch, cfg):
    """SPEC_DRIVE's prompts and sampling params (serve_params)."""
    sd = SPEC_DRIVE
    g = torch.Generator(device="cpu").manual_seed(sd["seed"])
    length = lambda lo_hi: int(torch.randint(lo_hi[0], lo_hi[1] + 1, (1,),
                                             generator=g))
    rand = lambda n: torch.randint(0, cfg.vocab_size, (n,),
                                   generator=g).tolist()
    prompts = []
    for i in range(sd["n"]):
        if i < sd["n"] // 2:
            n = length(sd["repeat_len"])
            prompts.append((rand(sd["span"]) * (n // sd["span"] + 1))[:n])
        else:
            prompts.append(rand(length(sd["random_len"])))
    return prompts, [serve_params(i, sd["new_tokens"])
                     for i in range(sd["n"])]


@contextlib.contextmanager
def oracle_drafter(torch, eng, streams):
    """Replace the engine's n-gram drafter, while the block runs, by one
    that proposes each running request's known K = 0 continuation
    (``streams``: prompt tuple -> its K = 0 output ids): on random
    weights the n-gram drafter's guesses never land, and this is what
    makes verify windows accept drafts, emit up to K + 1 tokens a step
    and still have to equal the K = 0 stream bit for bit."""
    from paddle_tpu_torch.serving import engine as engine_mod

    orig = engine_mod.draft_tokens

    def draft(hist, lengths, k, ngram):
        truth = torch.zeros(hist.shape[0], hist.shape[1] + k,
                            dtype=torch.long)
        for slot, req in eng.scheduler.running.items():
            seq = req.prompt_ids + streams[tuple(req.prompt_ids)]
            truth[slot, :len(seq)] = torch.tensor(seq)
        idx = lengths.long()[:, None] + torch.arange(k, device=hist.device)
        return torch.gather(truth.to(hist.device), 1, idx)

    engine_mod.draft_tokens = draft
    try:
        yield
    finally:
        engine_mod.draft_tokens = orig


def workload_run(torch, dev, model, prompts, params, oracle=None, **kw):
    """The workload through a fresh engine of the serve geometry (one
    warm-up request first), launch counts checked (run_drive); with
    ``oracle`` (prompt tuple -> K = 0 stream) under
    :func:`oracle_drafter`.  Returns (streams, summary, launches); the
    summary holds the drive's rates, the spec counters of the run, and
    the host time and count of the horizons' uniform draws (sampled
    lanes)."""
    from paddle_tpu_torch.serving import Engine, EngineConfig
    from paddle_tpu_torch.serving import engine as engine_mod

    eng = Engine(model, EngineConfig(num_slots=SERVE_SLOTS,
                                     max_seq_len=SERVE_MAX_SEQ, **kw),
                 device=dev)
    eng.generate([1, 2, 3, 4], serve_params(0, 4))          # warm-up
    before = eng.stats()["spec"]
    with host_timers(engine_mod, ("draw_uniforms",)) as drawn, (
            oracle_drafter(torch, eng, oracle) if oracle
            else contextlib.nullcontext()):
        reqs, delta, launches, wall, _ = run_drive(
            torch, eng, lambda e, step: [e.submit(p, sp)
                                         for p, sp in zip(prompts, params)])
    st = eng.stats()
    spec = st["spec"]
    hist = {n: c - before["accept_len_hist"].get(n, 0)
            for n, c in spec["accept_len_hist"].items()}
    hist = {n: c for n, c in hist.items() if c}
    drafted = spec["draft_tokens"] - before["draft_tokens"]
    accepted = spec["accepted_tokens"] - before["accepted_tokens"]
    windows = sum(hist.values())
    summary = dict(
        drive_summary(reqs, delta, wall), decode_tokens=delta["decode_tokens"],
        decode_seconds=delta["decode_seconds"], draft_tokens=drafted,
        accepted_tokens=accepted,
        accept_rate=accepted / drafted if drafted else 0.0,
        accept_len_hist=hist,
        mean_accept_len=(sum(n * c for n, c in hist.items()) / windows
                         if windows else 0.0),
        uniform_draw_s=drawn["draw_uniforms"][0],
        uniform_draw_calls=drawn["draw_uniforms"][1],
        weight_bytes=st["quant"]["weight_bytes"],
        bytes_per_block=st["kv_pool"]["bytes_per_block"],
        kv_dtype=st["kv_pool"]["dtype"])
    streams = [list(r.output_ids) for r in reqs]
    del eng
    torch.cuda.empty_cache()
    return streams, summary, launches


def streams_equal(name, got, ref):
    """Raise unless ``got`` equals ``ref`` lane by lane."""
    bad = [i for i, (a, b) in enumerate(zip(got, ref)) if a != b]
    if bad or len(got) != len(ref):
        raise AssertionError(f"{name}: lanes {bad} differ")


def serve_spec_phase(torch, dev, model):
    """spec K = 0, K = 4, K = 4 adaptive and K = 4 with the oracle
    drafter over SPEC_DRIVE: all streams bitwise equal lane by lane; the
    decode rates of K = 0 and K = 4 in turns (0, 4, 4a, 4 oracle, 4,
    0)."""
    prompts, params = spec_workload(torch, model.config)
    k = SPEC_DRIVE["k"]
    runs, launches, ref = [], {}, None
    for i, (name, kk, adaptive) in enumerate((
            ("K0", 0, False), ("K4", k, False), ("K4_adaptive", k, True),
            ("K4_oracle", k, False), ("K4", k, False), ("K0", 0, False))):
        oracle = ({tuple(p): s for p, s in zip(prompts, ref)}
                  if name == "K4_oracle" else None)
        got, summary, launches[i] = workload_run(
            torch, dev, model, prompts, params, oracle=oracle, spec_k=kk,
            spec_adaptive=adaptive)
        ref = ref or got
        streams_equal(f"serve_spec {name} (run {i}) vs K0", got, ref)
        runs.append(dict(run=name, **summary))
    emit({"phase": "serve_spec", "model": "LLAMA2_7B",
          "layers": model.config.num_hidden_layers,
          "prompt_lengths": [len(p) for p in prompts],
          "repeated_span": SPEC_DRIVE["span"],
          "new_tokens_each": SPEC_DRIVE["new_tokens"], "k": k,
          "streams_bitwise": True, "runs": runs,
          "decode_tokens_per_s_in_turns": {
              n: [r["decode_tokens_per_s"] for r in runs if r["run"] == n]
              for n in ("K0", "K4", "K4_oracle")}})
    return {name: sum(run[name] for run in launches.values())
            for name in launches[0]}


def serve_quant_phase(torch, dev, model):
    """SPEC_DRIVE's requests through weight_dtype = kv_cache_dtype =
    "int8": K = 4 (n-gram and oracle drafter) equals K = 0 bitwise;
    decode rates against bf16 in turns (bf16, int8, int8 K = 4, int8
    K = 4 oracle, int8, bf16); drive A's shared prompt
    with the prefix cache on equals off; drive C's undersized pool
    preempts and every resume re-samples its token.  Records the greedy
    streams' mean LCP fraction against bf16, the weight bytes a forward
    reads and the pool's bytes a block."""
    from paddle_tpu_torch.serving import Engine, EngineConfig

    cfg = model.config
    prompts, params = spec_workload(torch, cfg)
    q8 = dict(weight_dtype="int8", kv_cache_dtype="int8")
    runs, launches, streams = [], {}, {}
    k4 = dict(q8, spec_k=SPEC_DRIVE["k"], spec_adaptive=False)
    for i, (name, kw) in enumerate((
            ("bf16_K0", {}), ("int8_K0", q8), ("int8_K4", k4),
            ("int8_K4_oracle", k4), ("int8_K0", q8), ("bf16_K0", {}))):
        oracle = ({tuple(p): s for p, s in zip(prompts, streams["int8_K0"])}
                  if name == "int8_K4_oracle" else None)
        got, summary, launches[f"run{i}"] = workload_run(
            torch, dev, model, prompts, params, oracle=oracle, **kw)
        ref = streams.setdefault(name, got)
        streams_equal(f"serve_quant {name} (run {i})", got, ref)
        runs.append(dict(run=name, **summary))
    for name in ("int8_K4", "int8_K4_oracle"):
        streams_equal(f"serve_quant {name} vs int8_K0", streams[name],
                      streams["int8_K0"])

    def lcp(a, b):
        n = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        return n / max(1, len(a))

    greedy = [i for i, sp in enumerate(params) if sp.temperature <= 0]
    lcp_frac = sum(lcp(streams["bf16_K0"][i], streams["int8_K0"][i])
                   for i in greedy) / len(greedy)

    # drive A under int8: a 1000-token shared prompt, cache on vs off
    pa = PREFIX_DRIVE
    g = torch.Generator(device="cpu").manual_seed(4242)
    rand = lambda n: torch.randint(0, cfg.vocab_size, (n,),
                                   generator=g).tolist()
    _, _, submit_a = drive_a(torch, cfg, rand, g)
    runs_a = {}
    for mode, budget in (("cache_on", pa["cache_bytes"]), ("cache_off", 0)):
        eng = Engine(model, EngineConfig(
            num_slots=SERVE_SLOTS, max_seq_len=SERVE_MAX_SEQ,
            prefix_cache_bytes=budget, **q8), device=dev)
        reqs, delta, launches[f"A_{mode}"], wall, _ = run_drive(
            torch, eng, submit_a)
        hits = [r.prefix_hit_tokens for r in reqs]
        want = ([0] + [pa["sys_len"]] * (len(reqs) - 1)
                if mode == "cache_on" else [0] * len(reqs))
        if hits != want:
            raise AssertionError(f"serve_quant drive A {mode}: hits {hits}, "
                                 f"want {want}")
        runs_a[mode] = dict(streams=[list(r.output_ids) for r in reqs],
                             summary=dict(drive_summary(reqs, delta, wall),
                                          hits=hits))
        del eng
        torch.cuda.empty_cache()
    streams_equal("serve_quant drive A cache on vs off",
                  runs_a["cache_on"]["streams"],
                  runs_a["cache_off"]["streams"])

    # drive C under int8: the undersized pool; the engine raises if a
    # resume re-samples another token
    pc = PREEMPT_DRIVE
    lo, hi = pc["prompts"]
    prompts_c = [rand(int(n)) for n in torch.randint(
        lo, hi + 1, (pc["n"],), generator=g)]
    eng = Engine(model, EngineConfig(
        num_slots=SERVE_SLOTS, max_seq_len=SERVE_MAX_SEQ,
        kv_pool_blocks=pc["pool_blocks"], prefix_cache_bytes=0, **q8),
        device=dev)
    reqs, delta, launches["C"], wall, _ = run_drive(
        torch, eng, lambda e, step: [
            e.submit(p, serve_params(i, pc["new_tokens"]))
            for i, p in enumerate(prompts_c)])
    if delta["preemptions"] < 1 or eng.pool.blocks_in_use:
        raise AssertionError(f"serve_quant drive C: {delta['preemptions']} "
                             f"preemptions, {eng.pool.blocks_in_use} blocks "
                             "in use")
    pool_gib = eng.pool.capacity * eng.pool.bytes_per_block / 2 ** 30
    degradation = eng.stats()["degradation"]
    del eng
    torch.cuda.empty_cache()
    emit({"phase": "serve_quant", "model": "LLAMA2_7B",
          "layers": cfg.num_hidden_layers, "weight_dtype": "int8",
          "kv_cache_dtype": "int8", "k4_equals_k0": True,
          "greedy_mean_lcp_vs_bf16": lcp_frac,
          "weight_bytes": {"bf16": runs[0]["weight_bytes"],
                           "int8": runs[1]["weight_bytes"]},
          "bytes_per_block": {"bf16": runs[0]["bytes_per_block"],
                              "int8": runs[1]["bytes_per_block"]},
          "runs": runs,
          "decode_tokens_per_s_in_turns": {
              n: [r["decode_tokens_per_s"] for r in runs if r["run"] == n]
              for n in ("bf16_K0", "int8_K0")},
          "drive_A": {"prefix_on_equals_off": True,
                      **{m: d["summary"] for m, d in runs_a.items()}},
          "drive_C": {"kv_pool_blocks": pc["pool_blocks"],
                      "pool_gib": pool_gib, "degradation": degradation,
                      "preemptions": delta["preemptions"],
                      "resumed_without_divergence": True,
                      **drive_summary(reqs, delta, wall)}})
    return {name: sum(run[name] for run in launches.values())
            for name in launches["C"]}


# the serve_gateway phase: the engine phase's requests through the HTTP
# gateway over two replicas that share the engine phase's model, then a
# crash failover of a 1000-token-prompt stream (greedy, then seeded, each
# on a fresh pair of replicas)
GATEWAY_DRIVE = dict(fail_prompt=1000, fail_new=32, quota=(30, 1.0),
                     capped_prompt=16, capped_new=8)


def sse_stream(port, payload, timeout=600):
    """POST a streaming completion; returns (tokens, finish_reason,
    [(seconds since the send, tokens of the chunk)], the send's
    perf_counter time)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/v1/completions",
                     json.dumps(dict(payload, stream=True)),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        if r.status != 200:
            raise AssertionError(f"stream answered {r.status}: {r.read()}")
        toks, chunks, reason = [], [], None
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            if line == "data: [DONE]":
                break
            choice = json.loads(line[6:])["choices"][0]
            if choice["token_ids"]:
                chunks.append((time.perf_counter() - t0,
                               len(choice["token_ids"])))
                toks += choice["token_ids"]
            reason = choice["finish_reason"] or reason
        return toks, reason, chunks, t0
    finally:
        conn.close()


def http_json(port, method, path, payload=None, timeout=600):
    """(status, headers, body) of one request."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path,
                     None if payload is None else json.dumps(payload),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


def wire_params(sp):
    """A SamplingParams as /v1/completions fields."""
    return {"max_tokens": sp.max_new_tokens, "temperature": sp.temperature,
            "top_k": sp.top_k, "top_p": sp.top_p, "seed": sp.seed}


def gateway_streams(port, prompts, params, model_id):
    """Every request as an SSE stream from a client thread of its own,
    all started together; returns ([(tokens, finish_reason, chunks,
    send time)], wall seconds).  Raises what a client raised."""
    results = [None] * len(prompts)

    def client(i):
        try:
            results[i] = sse_stream(port, dict(
                wire_params(params[i]), prompt=prompts[i], model=model_id))
        except Exception as e:               # raised below
            results[i] = e

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError("an SSE client did not finish")
    for res in results:
        if isinstance(res, Exception):
            raise res
    return results, wall


def http_figures(results, wall):
    """TTFT (client send to first chunk) mean and max, and the decode
    rate of :func:`decode_rate`, of a batch of streams."""
    ttft = [r[2][0][0] for r in results]
    return {"wall_s": wall, "ttft_mean_s": sum(ttft) / len(ttft),
            "ttft_max_s": max(ttft),
            "decode_tokens_per_s": decode_rate(
                [len(r[0]) for r in results],
                [r[3] + r[2][0][0] for r in results],
                max(r[3] + r[2][-1][0] for r in results))}


def check_streams(results, refs):
    for i, res in enumerate(results):
        if res[0] != refs[i] or res[1] != "length":
            raise AssertionError(f"stream {i} ({res[1]}) differs from its "
                                 "in-process run")


def gateway_forwards(engines, before):
    """(prefill calls, decode steps) the engines ran since ``before``
    (their counters() then), summed over the replicas."""
    now = [e.counters() for e in engines]
    return (sum(a["prefill_calls"] - b["prefill_calls"]
                for a, b in zip(now, before)),
            sum(a["decode_steps"] - b["decode_steps"]
                for a, b in zip(now, before)))


def decode_rate(tokens, firsts, end):
    """Aggregate decode tokens/s of a batch of streams: the tokens after
    each stream's first, over the wall from the earliest first token to
    the end of the last stream."""
    return sum(n - 1 for n in tokens) / (end - min(firsts))


def failover_run(torch, model, cfg, prompt, sp, ref, ref_wall):
    """One crash failover: a fresh gateway over two replicas, a crash
    armed at the third dispatch of the replica the prompt routes to, the
    stream through SSE.  Checks the stream against ``ref`` bit for bit,
    one failover with the seam in the adopting engine's flight record,
    nothing leaked after the drain, and the launch totals over both
    replicas.  Returns the seam figures."""
    from paddle_tpu_torch.observability import tracing
    from paddle_tpu_torch.serving import (
        Engine, kernel_launches, reset_kernel_launches,
    )
    from paddle_tpu_torch.serving.faults import (
        FAULT_CRASH, SITE_WORKER_DISPATCH, FaultInjector, FaultPlan,
        FaultSpec,
    )
    from paddle_tpu_torch.serving.gateway import Gateway

    engines = [Engine(model, cfg, device=model.device) for _ in range(2)]
    gw = Gateway(engines).start()
    try:
        target, how = gw.router.route(prompt)
        inj = FaultInjector(FaultPlan([
            FaultSpec(SITE_WORKER_DISPATCH, FAULT_CRASH, at=2)]))
        target.set_faults(inj)
        before = [e.counters() for e in engines]
        torch.cuda.synchronize()
        reset_kernel_launches()
        toks, reason, chunks, _ = sse_stream(gw.port,
                                          dict(wire_params(sp),
                                               prompt=prompt))
        torch.cuda.synchronize()
        launches = kernel_launches()
        check_serving_launches(launches, model.config.num_hidden_layers,
                               *gateway_forwards(engines, before))
        if toks != ref or reason != "length":
            raise AssertionError(f"failover stream diverged ({reason}): "
                                 f"{toks} != {ref}")
        sup = gw.supervisor.stats()
        if (sup["failovers"] != 1 or sup["failover_failures"]
                or sup["condemned"] != [(target.name, "crash")]
                or inj.counts() != {FAULT_CRASH: 1}):
            raise AssertionError(f"failover: {sup}, fired {inj.counts()}")
        survivor = next(w for w in gw.workers if w is not target)
        seam = [t for t in survivor.engine.recorder.recent()
                if any(k == tracing.FAILOVER for k, _, _ in t.events)]
        if len(seam) != 1:
            raise AssertionError(f"{len(seam)} adopted traces")
        counts = seam[0].counts()
        resumed = counts["resumed_tokens"]
        if not (counts["failovers"] == 1 and 0 < resumed < len(ref)
                and resumed + counts["tokens_emitted"] == len(ref)):
            raise AssertionError(f"failover trace counts {counts}")
        target._thread.join(60)
        if not target.crashed or target.engine.pool.blocks_in_use:
            raise AssertionError("the crashed replica kept pool blocks")
        survivor.drain()
        if survivor.engine.pool.blocks_in_use:
            raise AssertionError("the survivor kept pool blocks")
    finally:
        gw.shutdown()
    # the chunk holding token `resumed` arrived from the adopting replica
    ends = list(itertools.accumulate(n for _, n in chunks))
    k = next(i for i, e in enumerate(ends) if e > resumed)
    gaps = [b[0] - a[0] for a, b in zip(chunks, chunks[1:])]
    return {"prompt_len": len(prompt), "routed": how,
            "resumed_tokens": resumed, "stream_wall_s": chunks[-1][0],
            "uninterrupted_wall_s": ref_wall,
            "seam_gap_s": chunks[k][0] - chunks[k - 1][0],
            "median_other_gap_s": statistics.median(
                g for i, g in enumerate(gaps) if i != k - 1),
            "launches": launches}


def serve_gateway_phase(torch, dev, model, engine_figures):
    """The engine phase's 8 requests as concurrent SSE streams through a
    ``Gateway`` over two replicas (``Engine(num_slots=8,
    max_seq_len=2048)`` each, both on ``model``): every stream equal bit
    for bit to the same request's in-process run, the launch totals over
    both replicas equal to the forwards they ran; a capped tenant's
    second request answers 429 with Retry-After and a request whose
    deadline passed in the queue finishes "abort"; ``/metrics`` passes
    validate_exposition; drain() leaves no pool block in use on either
    replica.  The 8 streams run once more under torch.profiler (the
    device's idle share behind the gateway) and once through a gateway
    over one replica (the HTTP and thread cost without a second engine).
    Then a crash failover (GATEWAY_DRIVE) greedy and seeded.  Prints TTFT
    and decode tokens/s through HTTP beside the in-process run's and the
    engine phase's, and the failover seams.  Returns the launches of the
    8-stream drive."""
    from paddle_tpu_torch.models.llama import LLAMA2_7B
    from paddle_tpu_torch.observability.metrics import validate_exposition
    from paddle_tpu_torch.serving import (
        Engine, EngineConfig, SamplingParams, kernel_launches,
        reset_kernel_launches,
    )
    from paddle_tpu_torch.serving.gateway import (
        Gateway, GatewayConfig, TenantQuotas,
    )

    cfg = EngineConfig(num_slots=8, max_seq_len=2048)
    g = torch.Generator(device="cpu").manual_seed(1234)
    lengths = [16, 40, 100, 200, 350, 500, 750, 1024]
    prompts = [torch.randint(0, LLAMA2_7B.vocab_size, (n,),
                             generator=g).tolist() for n in lengths]
    params = [serve_params(i, 32) for i in range(len(prompts))]
    gd = GATEWAY_DRIVE
    fail_prompt = torch.randint(
        0, LLAMA2_7B.vocab_size, (gd["fail_prompt"],),
        generator=torch.Generator(device="cpu").manual_seed(4321)).tolist()
    fail_params = [SamplingParams(max_new_tokens=gd["fail_new"]),
                   SamplingParams(max_new_tokens=gd["fail_new"],
                                  temperature=0.8, top_k=50, top_p=0.95,
                                  seed=7)]

    # the in-process references (submit + run, Engine.generate's path)
    ref_eng = Engine(model, cfg, device=dev, register_profiler=False)
    torch.cuda.synchronize()
    t0, t0_wall = time.perf_counter(), time.time()
    reqs = [ref_eng.submit(p, sp) for p, sp in zip(prompts, params)]
    ref_eng.run()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    refs = [list(r.output_ids) for r in reqs]
    in_process = {
        "wall_s": t_end - t0,
        "ttft_mean_s": sum(r.ttft for r in reqs) / len(reqs),
        "ttft_max_s": max(r.ttft for r in reqs),
        "decode_tokens_per_s": decode_rate(
            [len(o) for o in refs],
            [r.first_token_time - t0_wall for r in reqs], t_end - t0)}
    fail_refs, fail_walls = [], []
    for sp in fail_params:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fail_refs.append(ref_eng.generate(fail_prompt, sp))
        torch.cuda.synchronize()
        fail_walls.append(time.perf_counter() - t1)
    del ref_eng, reqs
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 1-6: one gateway over two replicas
    quotas = TenantQuotas()
    quotas.set_quota("capped", *gd["quota"])
    engines = [Engine(model, cfg, device=dev) for _ in range(2)]
    gw = Gateway(engines, GatewayConfig(model_id="llama-2-7b"),
                 quotas=quotas).start()
    try:
        before = [e.counters() for e in engines]
        torch.cuda.synchronize()
        reset_kernel_launches()
        results, wall = gateway_streams(gw.port, prompts, params,
                                        "llama-2-7b")
        torch.cuda.synchronize()
        launches = kernel_launches()
        forwards = gateway_forwards(engines, before)
        check_serving_launches(launches, model.config.num_hidden_layers,
                               *forwards)
        check_streams(results, refs)
        sup = gw.supervisor.stats()
        if sup["condemned"] or any(w.crashed for w in gw.workers):
            raise AssertionError(f"a replica failed: {sup}")
        http = dict(http_figures(results, wall), prefill_calls=forwards[0],
                    decode_steps=forwards[1],
                    requests_per_replica=[e.counters()["prefill_requests"]
                                          for e in engines])
        # the same streams under torch.profiler: the device's idle share
        # behind the gateway
        profile = profiled(torch, lambda: check_streams(gateway_streams(
            gw.port, prompts, params, "llama-2-7b")[0], refs))

        # ---- 3: admission
        capped = {"prompt": prompts[0][:gd["capped_prompt"]],
                  "max_tokens": gd["capped_new"], "tenant": "capped"}
        ok = http_json(gw.port, "POST", "/v1/completions", capped)
        denied = http_json(gw.port, "POST", "/v1/completions", capped)
        err = json.loads(denied[2])["error"]
        if (ok[0] != 200 or denied[0] != 429
                or err["code"] != "quota_exhausted"
                or int(denied[1].get("Retry-After", 0)) < 1):
            raise AssertionError(f"quota: {ok[0]}, {denied[0]} {err} "
                                 f"{denied[1]}")
        late = http_json(gw.port, "POST", "/v1/completions",
                         {"prompt": prompts[1], "max_tokens": 4,
                          "deadline_s": 1e-6})
        reason = json.loads(late[2])["choices"][0]["finish_reason"]
        if late[0] != 200 or reason != "abort":
            raise AssertionError(f"expired deadline: {late[0]} {reason}")
        expired = sum(e.counters()["deadline_expired"] for e in engines)

        # ---- 4: metrics
        status, _, body = http_json(gw.port, "GET", "/metrics")
        text = body.decode()
        if status != 200:
            raise AssertionError(f"/metrics answered {status}")
        samples = validate_exposition(text)
        for fam in ("gateway_requests", "gateway_streams",
                    "gateway_ttft_seconds", "gateway_rejections",
                    "serving_tokens_generated", "serving_ttft_seconds"):
            if fam not in text:
                raise AssertionError(f"/metrics lacks {fam}")

        # ---- 5: drain both replicas
        for w in gw.workers:
            w.drain()
            if w.engine.pool.blocks_in_use:
                raise AssertionError(f"{w.name} kept "
                                     f"{w.engine.pool.blocks_in_use} blocks")
    finally:
        gw.shutdown()
    del gw, engines
    gc.collect()
    torch.cuda.empty_cache()

    # the same streams through a gateway over ONE replica: the HTTP and
    # thread cost alone, without a second engine on the GIL and stream
    gw = Gateway([Engine(model, cfg, device=dev)]).start()
    try:
        results, wall = gateway_streams(gw.port, prompts, params,
                                        "paddle-tpu")
        check_streams(results, refs)
        one_replica = http_figures(results, wall)
    finally:
        gw.shutdown()
    del gw
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 2: crash failover, greedy then seeded
    failovers = []
    for sp, ref, ref_wall in zip(fail_params, fail_refs, fail_walls):
        failovers.append(dict(failover_run(torch, model, cfg, fail_prompt,
                                           sp, ref, ref_wall),
                              greedy=sp.temperature == 0))
        gc.collect()
        torch.cuda.empty_cache()

    emit({"phase": "serve_gateway", "model": "LLAMA2_7B",
          "replicas": 2, "num_slots": 8, "max_seq_len": 2048,
          "requests": len(prompts), "prompt_lengths": lengths,
          "new_tokens_each": 32, "streams_bitwise": True,
          "http": http, "http_one_replica": one_replica,
          "in_process": in_process,
          "engine_phase": {k: engine_figures[k] for k in (
              "wall_s", "ttft_mean_s", "ttft_max_s", "decode_tokens_per_s")},
          "quota_429_retry_after": denied[1].get("Retry-After"),
          "deadline_expired": expired, "metrics_samples": samples,
          "failover": failovers, "kernel_launches": launches,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    emit(dict(profile, phase="serve_gateway_profile"))
    return launches


# the serve_structured phase: grammar-constrained decoding over a seeded
# 32,000-token vocabulary, EOS at LLaMA's id 2
STRUCT_DRIVE = dict(n=8, prompt=(50, 200), new_tokens=64, k=4, eos=2,
                    vocab_seed=13, seed=77)
STRUCT_SCHEMA = {"type": "object",
                 "properties": {"name": {"enum": ["alpha", "beta",
                                                  "gamma"]},
                                "ok": {"type": "boolean"},
                                "level": {"enum": [1, 2, 3]}},
                 "required": ["name", "ok", "level"]}
# tests/test_structured.py's multi-character JSON and word pieces
JSON_PIECES = ['{"', '":', '",', '"}', 'true', 'false', 'null', '": "',
               '", "', 'ab', 'abc', '0', '12']


def struct_vocab(size, seed):
    """A 32,000-token vocabulary as strings: ids 0 and 1 empty (never
    legal), EOS "</s>" at 2, the 95 printable ASCII characters, the JSON
    pieces, then random lowercase pieces of 2-6 letters from ``seed``."""
    import random

    rng = random.Random(seed)
    vocab = ["", "", "</s>"] + [chr(32 + i) for i in range(95)]
    vocab += JSON_PIECES
    letters = "abcdefghijklmnopqrstuvwxyz"
    while len(vocab) < size:
        vocab.append("".join(rng.choice(letters)
                             for _ in range(rng.randint(2, 6))))
    return vocab


def check_schema_output(req, vocab, eos):
    """A constrained output: ends at EOS, and its text parses as JSON
    that holds STRUCT_SCHEMA's keys with legal values."""
    if req.finish_reason != "eos" or req.output_ids[-1] != eos:
        raise AssertionError(f"request {req.request_id} did not end at "
                             f"EOS: {req.finish_reason}")
    text = "".join(vocab[t] for t in req.output_ids[:-1])
    obj = json.loads(text)
    props = STRUCT_SCHEMA["properties"]
    if (set(obj) != set(props) or obj["name"] not in props["name"]["enum"]
            or not isinstance(obj["ok"], bool)
            or obj["level"] not in props["level"]["enum"]):
        raise AssertionError(f"request {req.request_id}: {text!r} breaks "
                             "the schema")
    return text


def serve_structured_phase(torch, dev, model):
    """STRUCT_DRIVE on the engine phase's model: 8 constrained requests
    (half greedy, half sampled) at K = 0, at K = 4 with forced drafting,
    then unconstrained at K = 0 (the mask's cost), then the constrained
    and the free runs once more (rates in turns); 4 constrained and 4
    free requests in one batch against their separate runs; one
    constrained request through a one-replica Gateway against its
    in-process run.  Every constrained output parses and keeps the
    schema and ends at EOS; K = 4 = K = 0, mixed = separate and HTTP =
    in-process bit for bit; every forced draft a window could emit is
    accepted.  Launch counts checked per drive (run_drive).  Prints the
    grammar's compile seconds cold and on a cache hit, the slab's device
    bytes, the decode rates and the spec counters."""
    from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams
    from paddle_tpu_torch.serving.gateway import Gateway, GatewayConfig
    from paddle_tpu_torch.serving.structured import compile_grammar

    free_device_memory(torch)
    cfg = model.config
    sd = STRUCT_DRIVE
    t0 = time.perf_counter()
    vocab = struct_vocab(cfg.vocab_size, sd["vocab_seed"])
    vocab_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dfa = compile_grammar(STRUCT_SCHEMA, vocab, sd["eos"],
                          vocab_size=cfg.vocab_size)
    compile_cold_s = time.perf_counter() - t0
    g = torch.Generator(device="cpu").manual_seed(sd["seed"])
    lo, hi = sd["prompt"]
    prompts = [torch.randint(3, cfg.vocab_size, (int(n),),
                             generator=g).tolist()
               for n in torch.randint(lo, hi + 1, (sd["n"],), generator=g)]
    params = [SamplingParams(max_new_tokens=sd["new_tokens"],
                             eos_token_id=sd["eos"]) if i % 2 == 0 else
              SamplingParams(max_new_tokens=sd["new_tokens"],
                             eos_token_id=sd["eos"], temperature=0.8,
                             top_k=50, top_p=0.95, seed=300 + i)
              for i in range(sd["n"])]

    def drive(grammars, k=0, which=None):
        """The requests ``which`` (all by default) through a fresh
        engine; ``grammars[i]`` constrains request i or not.  With no
        grammar at all the engine has the knobs off, so the free runs
        pay nothing of the mask."""
        which = range(sd["n"]) if which is None else which
        knobs = {} if all(grammars[i] is None for i in which) else dict(
            grammar_max_states=256, grammar_vocab=vocab)
        eng = Engine(model, EngineConfig(
            num_slots=SERVE_SLOTS, max_seq_len=SERVE_MAX_SEQ, spec_k=k,
            spec_adaptive=False, **knobs), device=dev)
        eng.generate([5, 6, 7, 8], SamplingParams(max_new_tokens=4))
        with call_timer(eng, "_norm_grammar") as hits:
            reqs, delta, launches, wall, _ = run_drive(
                torch, eng, lambda e, step: [
                    e.submit(prompts[i], params[i], grammar=grammars[i])
                    for i in which], stop_ok=True)
        st = eng.stats()
        out = dict(drive_summary(reqs, delta, wall),
                   decode_tokens=delta["decode_tokens"],
                   spec_k=k, structured=st["structured"],
                   spec={key: st["spec"][key] for key in (
                       "draft_tokens", "accepted_tokens", "accept_rate",
                       "mean_accept_len")},
                   spec_forced_tokens=st["spec_forced_tokens"],
                   grammar_masked_fraction=st["grammar_masked_fraction"],
                   norm_grammar_s=hits)
        streams = [list(r.output_ids) for r in reqs]
        del eng
        free_device_memory(torch)
        return reqs, streams, out, launches

    constrained = [STRUCT_SCHEMA] * sd["n"]
    free = [None] * sd["n"]
    runs, launches, streams = [], {}, {}
    for i, (name, grammars, k) in enumerate((
            ("constrained_K0", constrained, 0),
            ("constrained_K4", constrained, sd["k"]),
            ("free_K0", free, 0), ("constrained_K0", constrained, 0),
            ("free_K0", free, 0))):
        reqs, got, summary, launches[f"run{i}"] = drive(grammars, k)
        if grammars is constrained:
            for r in reqs:
                check_schema_output(r, vocab, sd["eos"])
            st = summary["structured"]
            if st["forced_tokens"] != st["forced_drafted"]:
                raise AssertionError(f"serve_structured {name}: "
                                     f"{st['forced_tokens']} of "
                                     f"{st['forced_drafted']} forced drafts "
                                     "accepted")
            if k and not st["forced_tokens"]:
                raise AssertionError("serve_structured: K = 4 accepted no "
                                     "forced draft")
        streams_equal(f"serve_structured {name} (run {i})", got,
                      streams.setdefault(name, got))
        runs.append(dict(run=name, **summary))
    streams_equal("serve_structured constrained K4 vs K0",
                  streams["constrained_K4"], streams["constrained_K0"])

    # 4 constrained + 4 free in one batch against their separate runs
    mixed_g = [STRUCT_SCHEMA if i < sd["n"] // 2 else None
               for i in range(sd["n"])]
    _, mixed, mixed_summary, launches["mixed"] = drive(mixed_g)
    half = sd["n"] // 2
    _, sep_c, _, launches["sep_c"] = drive(mixed_g, which=range(half))
    _, sep_f, _, launches["sep_f"] = drive(mixed_g,
                                           which=range(half, sd["n"]))
    streams_equal("serve_structured mixed vs separate", mixed,
                  sep_c + sep_f)
    streams_equal("serve_structured mixed constrained vs K0",
                  mixed[:half], streams["constrained_K0"][:half])

    # one constrained request through a one-replica gateway
    eng = Engine(model, EngineConfig(
        num_slots=SERVE_SLOTS, max_seq_len=SERVE_MAX_SEQ,
        grammar_max_states=256, grammar_vocab=vocab), device=dev)
    ref = eng.submit(prompts[0], params[0], grammar=STRUCT_SCHEMA)
    eng.run()
    gw = Gateway([eng], GatewayConfig(model_id="llama-2-7b")).start()
    try:
        toks, reason, chunks, _ = sse_stream(gw.port, dict(
            wire_params(params[0]), prompt=prompts[0], model="llama-2-7b",
            eos_token_id=sd["eos"], response_format={
                "type": "json_schema",
                "json_schema": {"schema": STRUCT_SCHEMA}}))
        status, _, body = http_json(gw.port, "POST", "/v1/completions", {
            "prompt": prompts[0], "eos_token_id": sd["eos"],
            "grammar": "(a"})
    finally:
        gw.shutdown()
    if toks != ref.output_ids or reason != "stop":
        raise AssertionError(f"serve_structured HTTP stream {toks} "
                             f"({reason}) != in-process {ref.output_ids}")
    if status != 400 or json.loads(body)["error"]["code"] != \
            "invalid_grammar":
        raise AssertionError(f"malformed grammar answered {status} {body}")
    slab_bytes = eng.stats()["structured"]["table_bytes"]
    del eng
    free_device_memory(torch)
    by = {n: [r for r in runs if r["run"] == n]
          for n in ("constrained_K0", "constrained_K4", "free_K0")}
    emit({"phase": "serve_structured", "model": "LLAMA2_7B",
          "layers": cfg.num_hidden_layers, "vocab_size": cfg.vocab_size,
          "schema": STRUCT_SCHEMA, "dfa_states": dfa.n_states,
          "prompt_lengths": [len(p) for p in prompts],
          "new_tokens_max": sd["new_tokens"], "k": sd["k"],
          "vocab_build_s": vocab_s, "compile_cold_s": compile_cold_s,
          "engine_norm_grammar_s": {
              "first": by["constrained_K0"][0]["norm_grammar_s"][0],
              "cache_hits_max": max(by["constrained_K0"][0][
                  "norm_grammar_s"][1:])},
          "slab_device_bytes": slab_bytes,
          "outputs": ["".join(vocab[t] for t in o[:-1])
                      for o in streams["constrained_K0"]],
          "k4_equals_k0": True, "mixed_equals_separate": True,
          "http_equals_in_process": True,
          "forced_accept": {r["run"]: [r["structured"]["forced_tokens"],
                                       r["structured"]["forced_drafted"]]
                            for r in runs if r["spec_k"]},
          "decode_tokens_per_s_in_turns": {
              n: [r["decode_tokens_per_s"] for r in rs]
              for n, rs in by.items()},
          "runs": runs, "mixed": mixed_summary})
    return {name: sum(run.get(name, 0) for run in launches.values())
            for name in set().union(*launches.values())}


# the serve_tier phase: drive C's geometry with the host KV tier (a
# swap-in lands as a prefix hit, so drive C gets a radix store of
# c_store_blocks, with and without the arena alike), new tokens cut from
# 256 to 128 to fit the whole script in its limit; drive A's store of
# a_store_blocks is smaller than the 1000-token prompt's 63 blocks
TIER_DRIVE = dict(host_bytes=2 << 30, new_tokens=128, seed=8642,
                  c_store_blocks=48, a_store_blocks=40, churn=700)


def resume_times(req):
    """(queue wait, first token) seconds of each preemption of ``req``
    from its flight record: PREEMPT to the RESUME re-admission, and the
    RESUME to the first DECODE event after it (the resumed lane's time
    to its next token, re-prefill or swap-in included)."""
    from paddle_tpu_torch.observability import tracing

    out, preempt, resume = [], None, None
    for kind, t, _ in req.trace.events:
        if kind == tracing.PREEMPT:
            preempt, resume = t, None
        elif kind == tracing.RESUME and preempt is not None:
            resume = t
        elif (kind == tracing.DECODE and resume is not None):
            out.append((resume - preempt, t - resume))
            preempt = resume = None
    return out


def serve_tier_phase(torch, dev, model):
    """The host KV tier on the engine phase's model: drive C (8 requests
    of 100-400 tokens, TIER_DRIVE's new tokens, a 96-block pool) with a
    2 GiB arena under the "auto" policy and with none, in turns: the
    streams bitwise equal, swap-outs and swap-ins above 0, the arena
    pinned, no host block after drain.  Drive A with a 40-block device
    store: request 0 alone, a 700-token request that evicts the system
    prompt's blocks (demoted to the arena), then 1-7 together, whose
    admission promotes them back; against the same drive without the
    arena (computed prompt tokens and prefill seconds).  Drive C under
    kv_cache_dtype="int8" with the arena against its recompute run,
    bitwise.  Prints the host->device GB/s, the swaps' bytes and
    seconds (synchronized), the resumed lanes' prefill seconds, TTFT,
    and the memory ledger against torch.cuda.memory_allocated with the
    leak delta across the phase."""
    from paddle_tpu_torch.observability.memory import (
        host_device_bandwidth_gbs,
    )
    from paddle_tpu_torch.serving import Engine, EngineConfig
    from paddle_tpu_torch.serving.kv_cache import token_bytes

    free_device_memory(torch)
    cfg = model.config
    td, pc, pa = TIER_DRIVE, PREEMPT_DRIVE, PREFIX_DRIVE
    bw = host_device_bandwidth_gbs(dev)
    g = torch.Generator(device="cpu").manual_seed(td["seed"])
    rand = lambda n: torch.randint(0, cfg.vocab_size, (n,),
                                   generator=g).tolist()
    lo, hi = pc["prompts"]
    prompts_c = [rand(int(n)) for n in torch.randint(
        lo, hi + 1, (pc["n"],), generator=g)]
    engine = lambda **kw: Engine(model, EngineConfig(
        num_slots=SERVE_SLOTS, max_seq_len=SERVE_MAX_SEQ, **kw), device=dev)
    launches, streams, summaries, ledger = {}, {}, {}, None
    bpb = 2 * cfg.num_hidden_layers * 16 * token_bytes(
        cfg.kv_heads, cfg.head_dim, torch.bfloat16)    # a 16-token block

    def drive_c(name, **kw):
        nonlocal ledger
        eng = engine(kv_pool_blocks=pc["pool_blocks"],
                     prefix_cache_bytes=td["c_store_blocks"] * bpb, **kw)
        tier = eng.host_tier
        if tier is not None and not tier.is_pinned():
            raise AssertionError("serve_tier: the host arena is not pinned")
        first = eng.stats()["memory"] if tier is not None else None
        sync = torch.cuda.synchronize
        # the tokens a prefill re-computes for resumed lanes
        resumed = lambda entries, *_: sum(
            e["take"] for e in entries
            if e["final"] and e["req"].output_ids)
        with call_timer(eng, "_swap_out_lane", sync, bool) as out_s, \
                call_timer(eng, "_swap_in", sync,
                           lambda r: r is True) as in_s, \
                call_timer(eng, "_dispatch_prefill", tag=resumed) as pre:
            reqs, delta, launches[name], wall, _ = run_drive(
                torch, eng, lambda e, step: [
                    e.submit(p, serve_params(i, td["new_tokens"]))
                    for i, p in enumerate(prompts_c)])
        pre = [(t, n) for t, n in pre if n]
        eng.drain()
        st = eng.stats()
        kv = st["kv_pool"]
        if delta["preemptions"] < 1:
            raise AssertionError(f"serve_tier {name}: no preemption")
        if tier is not None:
            if not (kv["kv_swap_outs"] > 0 and kv["kv_swap_ins"] > 0):
                raise AssertionError(f"serve_tier {name}: swaps out "
                                     f"{kv['kv_swap_outs']}, in "
                                     f"{kv['kv_swap_ins']}")
            if kv["host_blocks_in_use"] or tier.blocks_in_use:
                raise AssertionError(f"serve_tier {name}: drain left "
                                     f"{tier.blocks_in_use} host blocks")
            mem = st["memory"]
            if ledger is None:
                ledger = {"first": first, "last": mem,
                          "memory_allocated": torch.cuda.memory_allocated(
                              dev)}
        streams[name] = [list(r.output_ids) for r in reqs]
        summaries[name] = dict(
            drive_summary(reqs, delta, wall),
            preemptions=delta["preemptions"],
            swap_decisions=kv["swap_decisions"],
            kv_swap_outs=kv["kv_swap_outs"], kv_swap_ins=kv["kv_swap_ins"],
            kv_swap_out_bytes=kv["kv_swap_out_bytes"],
            kv_swap_in_bytes=kv["kv_swap_in_bytes"],
            kv_swaps_averted_tokens=kv["kv_swaps_averted_tokens"],
            swap_uploads=kv["swap_uploads"],
            swap_out_s=out_s, swap_in_s=in_s,
            resume_prefill_s=[t for t, _ in pre],
            resume_prefill_tokens=[n for _, n in pre],
            resume_wait_and_first_token_s=[
                x for r in reqs for x in resume_times(r)],
            host_tier=kv.get("host_tier"))
        del eng, tier
        free_device_memory(torch)

    arena = dict(kv_host_bytes=td["host_bytes"], kv_swap_policy="auto")
    drive_c("tier", **arena)
    drive_c("recompute")
    streams_equal("serve_tier drive C tier vs recompute",
                  streams["tier"], streams["recompute"])
    q8 = dict(kv_cache_dtype="int8")
    drive_c("int8_tier", **arena, **q8)
    drive_c("int8_recompute", **q8)
    streams_equal("serve_tier int8 drive C tier vs recompute",
                  streams["int8_tier"], streams["int8_recompute"])

    # drive A: the system prompt's blocks demoted by a churn request and
    # promoted back from the arena
    system = rand(pa["sys_len"])
    firsts = torch.randperm(cfg.vocab_size, generator=g)[:len(
        pa["suffixes"])].tolist()
    prompts_a = [system + [f] + rand(n - 1)
                 for f, n in zip(firsts, pa["suffixes"])]
    churn = rand(td["churn"])
    runs_a = {}
    for mode, kw in (("arena", dict(kv_host_bytes=td["host_bytes"],
                                    kv_swap_policy="always")),
                     ("drop", {})):
        eng = engine(prefix_cache_bytes=td["a_store_blocks"] * bpb, **kw)

        def submit(e, step, prompts=prompts_a):
            params = [serve_params(i, pa["new_tokens"])
                      for i in range(len(prompts))]
            for p, sp in ((prompts[0], params[0]),
                          (churn, serve_params(0, 8))):
                e.submit(p, sp)
                while e.scheduler.has_work:
                    step()
            return [e.submit(p, sp) for p, sp in zip(prompts[1:],
                                                     params[1:])]

        reqs, delta, launches[f"A_{mode}"], wall, _ = run_drive(
            torch, eng, submit)
        st = eng.stats()
        runs_a[mode] = dict(
            streams=[list(r.output_ids) for r in reqs],
            summary=dict(drive_summary(reqs, delta, wall),
                         hits=[r.prefix_hit_tokens for r in reqs],
                         prefix=st["prefix"],
                         host_tier=st["kv_pool"].get("host_tier"),
                         kv_swap_ins=st["kv_pool"]["kv_swap_ins"],
                         kv_swap_in_bytes=st["kv_pool"][
                             "kv_swap_in_bytes"]))
        eng.drain()
        del eng
        free_device_memory(torch)
    streams_equal("serve_tier drive A arena vs drop",
                  runs_a["arena"]["streams"], runs_a["drop"]["streams"])
    sa = runs_a["arena"]["summary"]
    if not (sa["prefix"]["evictions_demoted"] > 0
            and sa["host_tier"]["promotions"] > 0
            and sum(sa["hits"]) > sum(runs_a["drop"]["summary"]["hits"])):
        raise AssertionError(f"serve_tier drive A: no promotion {sa}")
    mem = ledger["last"]
    emit({"phase": "serve_tier", "model": "LLAMA2_7B",
          "layers": cfg.num_hidden_layers,
          "host_device_gbs": bw, "kv_host_bytes": td["host_bytes"],
          "kv_pool_blocks": pc["pool_blocks"],
          "new_tokens_each": td["new_tokens"],
          "prompt_lengths": [len(p) for p in prompts_c],
          "streams_bitwise": True, "int8_bitwise": True,
          "drive_C": summaries,
          "drive_A": {"store_blocks": td["a_store_blocks"],
                      "churn_prompt": td["churn"],
                      **{m: d["summary"] for m, d in runs_a.items()}},
          "memory": {"components": mem["components"],
                     "accounted_total_bytes": mem["accounted_total_bytes"],
                     "memory_allocated": ledger["memory_allocated"],
                     "unaccounted_bytes": mem["unaccounted_bytes"],
                     "leak_delta_bytes": mem["leak_delta_bytes"],
                     "host_components": mem.get("host_components"),
                     "first_snapshot": ledger["first"]}})
    return {name: sum(run.get(name, 0) for run in launches.values())
            for name in set().union(*launches.values())}


def profile_phase(torch, eng, prompts, params):
    """The engine workload once more under torch.profiler (see
    :func:`profiled`)."""
    def run():
        for p, sp in zip(prompts, params):
            eng.submit(p, sp)
        eng.run()

    emit(dict(profiled(torch, run), phase="profile"))


# the port's kernels by their function names (CUDA templates, Triton
# functions); every other kernel is a library's (cuBLAS, cuDNN, PyTorch)
PORT_KERNELS = (
    ("flash", ("flash_fwd", "flash_bwd", "FlashProblem")),
    ("paged_attention", ("paged_attn", "PagedProblem", "PagedInt8Problem")),
    ("group_norm", ("gn_fwd_kernel", "gn_bwd_kernel")),
    ("layer_norm", ("ln_fwd_warp_kernel", "ln_fwd_row_kernel",
                    "ln_bwd_warp_kernel", "ln_bwd_row_kernel")),
    ("rms_norm", ("_rms_fwd", "_rms_bwd")),
)


def profiled(torch, run):
    """``run()`` under torch.profiler: the device's busy share of the
    wall time (union of kernel intervals) and the kernel time by name.
    The profiler slows the host, so the idle share is an upper bound of
    the unprofiled run's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # the serving engine's spans (torch.profiler.record_function) also
    # appear on the device timeline, as user annotations spanning whole
    # steps: only kernels count as busy
    events = prof.events()
    annotations = {e.name for e in events
                   if getattr(e, "is_user_annotation", False)}
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name not in annotations]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    by_kind = {}
    for n, t in by_name.items():
        kind = next((k for k, keys in PORT_KERNELS if any(
            key in n for key in keys)), "library")
        by_kind[kind] = by_kind.get(kind, 0.0) + t / 1e3
    return {"wall_ms": wall_us / 1e3,
            "device_busy_ms": busy / 1e3 if kernels else "not measured",
            "device_idle_share": 1 - busy / wall_us if kernels
            else "not measured",
            "kernel_events": len(kernels),
            "device_ms_by_kind": by_kind,
            "top_kernels_ms": [[n[:80], t / 1e3] for n, t in top]}


# ------------------------------------------------------------ phase 5/6
def train_config(layers):
    from paddle_tpu_torch.models.llama import LLAMA2_7B

    return dataclasses.replace(LLAMA2_7B, num_hidden_layers=layers,
                               fused_lm_loss=True)


def loss_fn(net, ids, labels):
    loss, _ = net(ids, labels=labels)
    return loss


def train_phase(torch, dev):
    """A few optimizer steps of the LLaMA-2-7B-width decoder (see the
    module docstring), launch counts asserted per step."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import (
        CosineAnnealingDecay, LinearWarmup,
    )

    cfg = train_config(TRAIN_LAYERS)
    layers = cfg.num_hidden_layers
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    model.train()
    # LLaMA-2 (Touvron et al. 2023, sec. 2.2): peak 3e-4, cosine to 10 %,
    # AdamW(0.9, 0.95, eps 1e-5), decay 0.1, clip 1.0; the warm-up and
    # the cosine span this run's own steps
    sched = LinearWarmup(CosineAnnealingDecay(3e-4, T_max=TRAIN_TIMED,
                                              eta_min=3e-5),
                         TRAIN_WARMUP, 0.0, 3e-4)
    opt = AdamW(learning_rate=sched, beta1=0.9, beta2=0.95, epsilon=1e-5,
                parameters=model.named_parameters(), weight_decay=0.1,
                grad_clip=ClipGradByGlobalNorm(1.0), multi_precision=True,
                device=dev)
    step = TrainStep(model, loss_fn, opt, device=dev)
    g = torch.Generator(device="cpu").manual_seed(4321)
    ids = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                        generator=g).to(dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    losses, lrs = [], []
    for _ in range(TRAIN_WARMUP):
        lrs.append(opt.get_lr())
        losses.append(step(ids, ids).item())
        sched.step()
    per_step = {"flash_fwd": layers, "flash_bwd_dq": layers,
                "flash_bwd_dkv": layers, "rms_norm": 2 * layers + 1,
                "rms_norm_bwd": 2 * layers + 1, "paged_attention": 0}
    step_s = []
    reset_kernel_launches()
    for _ in range(TRAIN_TIMED):
        lrs.append(opt.get_lr())
        t1 = time.perf_counter()
        losses.append(step(ids, ids).item())      # .item() synchronises
        step_s.append(time.perf_counter() - t1)
        sched.step()
    launches = kernel_launches()
    for name, n in per_step.items():
        if launches[name] != n * TRAIN_TIMED:
            raise AssertionError(f"train: {name} launched {launches[name]} "
                                 f"times in {TRAIN_TIMED} steps, want "
                                 f"{n} a step")
    timed = losses[TRAIN_WARMUP:]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: non-finite loss {losses}")
    if not all(a > b for a, b in zip(timed, timed[1:])):
        raise AssertionError(f"train: loss not strictly decreasing {timed}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_params = sum(p.numel() for p in model.parameters())
    n_matmul = n_params - sum(
        p.numel() for n, p in model.named_parameters()
        if n.endswith("norm.weight") or n == "model.embed_tokens.weight")
    heads, d = cfg.num_attention_heads, cfg.head_dim
    pairs = visible_pairs(TRAIN_SEQ, TRAIN_SEQ, True) * TRAIN_BATCH * heads
    # 6 flops a matmul weight per token (forward + backward), plus the
    # attention products: 4 D forward and 8 D backward per visible pair
    flops = 6 * n_matmul * tokens + 12 * d * pairs * layers
    mean_s = sum(step_s) / len(step_s)
    emit({"phase": "train", "model": "LLAMA2_7B widths", "layers": layers,
          "dtype": "bfloat16", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "params": n_params, "setup_s": setup_s, "lr": lrs,
          "losses": losses, "step_s": step_s, "step_s_mean": mean_s,
          "tokens_per_s": tokens / mean_s, "model_flops_per_step": flops,
          "model_tflops_per_s": flops / mean_s / 1e12,
          "mfu_of_989": flops / mean_s / 989e12,
          "peak_memory_gb": peak_gb, "kernel_launches": launches,
          "launches_per_step": per_step})
    prof = profiled(torch, lambda: step(ids, ids).item())
    emit(dict(prof, phase="train_profile", steps=1))
    del step, opt, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def grad_parity(tag, kern, plain, f32, loss_floor=0.0, zero_truth=()):
    """Each ``(loss, {name: f32 grad})`` of the kernel path and the plain
    path in bf16 against the f32 plain truth: every gradient's relative
    error within GRAD_PARITY_FACTOR times the plain bf16 path's own plus
    GRAD_PARITY_FLOOR, the loss within GRAD_PARITY_FACTOR times the plain
    path's loss error plus GRAD_PARITY_FLOOR of the loss and
    ``loss_floor``.  A gradient that is 0 in exact arithmetic (names
    ending in one of ``zero_truth``) is rounding noise on every path, so
    its error is taken relative to the global norm of the f32 gradients
    instead of its own.  Returns (the worst error over its tolerance,
    {name: [kernel err, plain err]})."""
    (loss_k, g_k), (loss_p, g_p), (loss_32, g_32) = kern, plain, f32
    worst, report, failed = 0.0, {}, []
    total = math.sqrt(sum(g.norm().item() ** 2 for g in g_32.values()))
    for n, ref in g_32.items():
        norm = total if n.endswith(zero_truth) else ref.norm().item()
        e_k = (g_k[n] - ref).norm().item() / norm
        e_p = (g_p[n] - ref).norm().item() / norm
        tol = GRAD_PARITY_FACTOR * e_p + GRAD_PARITY_FLOOR
        report[n] = [e_k, e_p]
        worst = max(worst, e_k / tol)
        if not (math.isfinite(e_k) and e_k <= tol):
            failed.append(f"{n}: kernel grad rel err {e_k:.3e} > {tol:.3e} "
                          f"(plain bf16 {e_p:.3e})")
    if failed:
        raise AssertionError(f"{tag}: {len(failed)} of {len(report)} "
                             f"gradients out of tolerance: {failed[:12]}")
    l_tol = (GRAD_PARITY_FACTOR * abs(loss_p - loss_32)
             + GRAD_PARITY_FLOOR * abs(loss_32) + loss_floor)
    if not abs(loss_k - loss_32) <= l_tol:
        raise AssertionError(f"{tag} loss: kernel {loss_k} plain bf16 "
                             f"{loss_p} f32 {loss_32}")
    return worst, report


@contextlib.contextmanager
def plain_path(torch):
    """The model's attention and norms through the plain twins (torch
    autograd over the plain forwards), for the reference passes."""
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops.flash_attention import flash_attention_plain
    from paddle_tpu_torch.ops.rms_norm import rms_norm_plain

    saved = gpt.flash_attention, gpt.rms_norm
    gpt.flash_attention, gpt.rms_norm = flash_attention_plain, rms_norm_plain
    try:
        yield
    finally:
        gpt.flash_attention, gpt.rms_norm = saved


def train_parity_phase(torch, dev):
    """One step's loss and gradients: kernels in bf16 vs plain in bf16
    vs plain on an f32 copy (the truth), per parameter."""
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.ops import kernel_launches, reset_kernel_launches

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = train_config(2)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=7)
    g = torch.Generator(device="cpu").manual_seed(99)
    ids = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, 2048),
                        generator=g).to(dev)

    def grads_of(m):
        m.zero_grad(set_to_none=True)
        loss = loss_fn(m, ids, ids)
        loss.backward()
        out = {n: p.grad.float() for n, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
        return loss.item(), out

    reset_kernel_launches()
    loss_k, g_k = grads_of(model)
    launches = kernel_launches()
    if min(launches[k] for k in ("flash_fwd", "flash_bwd_dq",
                                 "flash_bwd_dkv", "rms_norm",
                                 "rms_norm_bwd")) == 0:
        raise AssertionError(f"train parity: a kernel did not run "
                             f"{launches}")
    with plain_path(torch):
        loss_p, g_p = grads_of(model)
        model32 = copy.deepcopy(model).float()
        loss_32, g_32 = grads_of(model32)
    del model32, model
    worst, report = grad_parity("train parity", (loss_k, g_k),
                                (loss_p, g_p), (loss_32, g_32))
    emit({"phase": "train_parity", "layers": 2, "batch": TRAIN_BATCH,
          "seq": 2048,
          "loss_kernel_bf16": loss_k, "loss_plain_bf16": loss_p,
          "loss_plain_f32": loss_32, "worst_err_over_tol": worst,
          "grad_rel_err_kernel_vs_plain_bf16": report,
          "launches": launches})


# ------------------------------------------------------------ phase 7/8
UNET_PER_STEP = {"group_norm": 61, "group_norm_bwd": 61, "layer_norm": 48,
                 "layer_norm_bwd": 48, "flash_fwd": 32, "flash_bwd_dq": 32,
                 "flash_bwd_dkv": 32, "rms_norm": 0, "rms_norm_bwd": 0,
                 "paged_attention": 0}


def unet_batch(torch, cfg, b, hw, dev, seed):
    """Seeded latents [b, 4, hw, hw] (also the target, as bench_unet),
    timesteps in [0, 1000) and a [b, 77, 768] context, bf16 on the card."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    lat = torch.randn(b, cfg.in_channels, hw, hw, generator=g)
    t = torch.randint(0, 1000, (b,), generator=g)
    ctx = torch.randn(b, UNET_CONTEXT, cfg.cross_attention_dim, generator=g)
    lat, ctx = (x.to(torch.bfloat16).to(dev) for x in (lat, ctx))
    return lat, t.to(dev), ctx, lat


def unet_forward_flops(torch, model, batch):
    """Forward FLOPs of one call, counted by hooks from the shapes each
    layer sees: a conv 2 (Cin k^2) Cout Hout Wout per sample; a Linear
    module 2 in out per row; an attention's projections through its
    concatenated weights (2 D 3D per token self, 2 Ctx 2D per context
    token cross) and 4 D per (query, key) pair per head.  A train step
    is 3x (the backward does two products per forward product)."""
    from torch import nn

    from paddle_tpu_torch.models.unet import CrossAttention

    total = [0]

    def conv(m, inp, out):
        total[0] += 2 * m.weight[0].numel() * out.numel()

    def linear(m, inp, out):
        total[0] += 2 * m.weight.numel() * (out.numel() // out.shape[-1])

    def attn(m, inp, out):
        x = inp[0]
        b, sq, dim = x.shape
        ctx = inp[1] if len(inp) > 1 else None
        sk = sq if ctx is None else ctx.shape[1]
        proj = (2 * dim * 3 * dim * b * sq if ctx is None else
                2 * ctx.shape[2] * 2 * dim * b * sk)
        total[0] += proj + 4 * dim * sq * sk * b

    hooks = []
    for m in model.modules():
        fn = (conv if isinstance(m, nn.Conv2d) else
              linear if isinstance(m, nn.Linear) else
              attn if isinstance(m, CrossAttention) else None)
        if fn is not None:
            hooks.append(m.register_forward_hook(fn))
    try:
        with torch.no_grad():
            model(*batch[:3])
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def unet_train_phase(torch, dev):
    """A few AdamW steps of the SD-1.x UNet at full width (see the
    module docstring), the seven kernels' launch counts asserted per
    step; then one step under torch.profiler."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.unet import (
        UNet2DConditionModel, UNetConfig, unet_loss,
    )
    from paddle_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from paddle_tpu_torch.optimizer import AdamW

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = UNetConfig(channels_last=False)
    t0 = time.perf_counter()
    model = UNet2DConditionModel(cfg, device=dev, dtype=torch.bfloat16,
                                 seed=0)
    model.train()
    # bench_unet (benchmarks/bench_models.py:190-224): AdamW(1e-4,
    # multi_precision), mse_loss against the latents
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                multi_precision=True, device=dev)
    step = TrainStep(model, unet_loss, opt, device=dev)
    batch = unet_batch(torch, cfg, UNET_BATCH, UNET_LATENT, dev, 2024)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    flops = 3 * unet_forward_flops(torch, model, batch)
    losses = [step(*batch).item() for _ in range(TRAIN_WARMUP)]
    step_s = []
    reset_kernel_launches()
    for _ in range(TRAIN_TIMED):
        t1 = time.perf_counter()
        losses.append(step(*batch).item())        # .item() synchronises
        step_s.append(time.perf_counter() - t1)
    launches = kernel_launches()
    for name, n in UNET_PER_STEP.items():
        if launches[name] != n * TRAIN_TIMED:
            raise AssertionError(f"unet_train: {name} launched "
                                 f"{launches[name]} times in {TRAIN_TIMED} "
                                 f"steps, want {n} a step")
    timed = losses[TRAIN_WARMUP:]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"unet_train: non-finite loss {losses}")
    if not timed[-1] < timed[0]:
        raise AssertionError(f"unet_train: loss did not fall {timed}")
    mean_s = sum(step_s) / len(step_s)
    # one more step, as TrainStep runs it, split where its wall time goes
    # (host clock, each part ending in a synchronize)
    split, t1 = {}, time.perf_counter()
    opt.clear_grad()
    loss = unet_loss(model, *batch)
    for part, run in (("forward_s", lambda: None), ("backward_s",
                                                    loss.backward),
                      ("optimizer_s", opt.step)):
        run()
        torch.cuda.synchronize()
        split[part] = time.perf_counter() - t1
        t1 = time.perf_counter()
    opt.clear_grad()
    del loss
    emit({"phase": "unet_train", "model": "SD-1.x UNet (UNetConfig())",
          "channels_last": False, "dtype": "bfloat16", "batch": UNET_BATCH,
          "latent": [UNET_LATENT, UNET_LATENT], "context": UNET_CONTEXT,
          "params": sum(p.numel() for p in model.parameters()),
          "setup_s": setup_s, "losses": losses, "step_s": step_s,
          "step_s_mean": mean_s, "iters_per_s": 1 / mean_s,
          "samples_per_s": UNET_BATCH / mean_s, "step_split_s": split,
          "model_flops_per_step": flops,
          "model_flops_formula": "3 x forward: conv 2 Cin k^2 Cout Hout "
                                 "Wout, linear 2 in out per row, attention "
                                 "projections + 4 D per pair per head",
          "model_tflops_per_s": flops / mean_s / 1e12,
          "mfu_of_989": flops / mean_s / 989e12,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "kernel_launches": launches, "launches_per_step": UNET_PER_STEP})
    prof = profiled(torch, lambda: step(*batch).item())
    emit(dict(prof, phase="unet_train_profile", steps=1))
    del step, opt, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def functional_plain_path(torch):
    """``nn.functional``'s norms and attention (the UNet's and BERT's)
    through the plain twins (torch autograd over the plain forwards),
    for the reference passes."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.flash_attention import flash_attention_plain
    from paddle_tpu_torch.ops.group_norm import group_norm_plain
    from paddle_tpu_torch.ops.layer_norm import layer_norm_plain

    saved = F._layer_norm_op, F._group_norm_op, F.flash_attention
    F._layer_norm_op, F._group_norm_op, F.flash_attention = (
        layer_norm_plain, group_norm_plain, flash_attention_plain)
    try:
        yield
    finally:
        F._layer_norm_op, F._group_norm_op, F.flash_attention = saved


def unet_train_parity_phase(torch, dev):
    """One step's loss and gradients of a reduced UNet (three levels,
    one layer each: head dims 40, 80 and 160 and a concat GroupNorm all
    occur), b=2, 32x32 latents: kernels in bf16 vs plain in bf16 vs
    plain on an f32 copy (the truth), per parameter."""
    from paddle_tpu_torch.models.unet import (
        UNet2DConditionModel, UNetConfig, unet_loss,
    )
    from paddle_tpu_torch.ops import kernel_launches, reset_kernel_launches

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = UNetConfig(block_out_channels=(320, 640, 1280), layers_per_block=1,
                     channels_last=False)
    model = UNet2DConditionModel(cfg, device=dev, dtype=torch.bfloat16,
                                 seed=7)
    batch = unet_batch(torch, cfg, 2, 32, dev, 99)

    def grads_of(m, dtype):
        m.zero_grad(set_to_none=True)
        loss = unet_loss(m, *(x.to(dtype) if x.is_floating_point() else x
                              for x in batch))
        loss.backward()
        out = {n: p.grad.float() for n, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
        return loss.item(), out

    reset_kernel_launches()
    loss_k, g_k = grads_of(model, torch.bfloat16)
    launches = kernel_launches()
    if min(launches[k] for k in ("flash_fwd", "flash_bwd_dq",
                                 "flash_bwd_dkv", "layer_norm",
                                 "layer_norm_bwd", "group_norm",
                                 "group_norm_bwd")) == 0:
        raise AssertionError(f"unet parity: a kernel did not run {launches}")
    with functional_plain_path(torch):
        loss_p, g_p = grads_of(model, torch.bfloat16)
        model32 = copy.deepcopy(model).float()
        loss_32, g_32 = grads_of(model32, torch.float32)
    del model32, model
    worst, report = grad_parity("unet parity", (loss_k, g_k), (loss_p, g_p),
                                (loss_32, g_32))
    top = sorted(report.items(), key=lambda kv: -kv[1][0])[:8]
    emit({"phase": "unet_train_parity", "block_out_channels": [320, 640,
                                                               1280],
          "layers_per_block": 1, "batch": 2, "latent": [32, 32],
          "loss_kernel_bf16": loss_k, "loss_plain_bf16": loss_p,
          "loss_plain_f32": loss_32, "worst_err_over_tol": worst,
          "params_checked": len(report),
          "largest_grad_rel_err_kernel_vs_plain_bf16": top,
          "launches": launches})


# ---------------------------------------------------------- phases 9-13
#: the kernel launches of one BertForMaskedLM step: LayerNorm forward and
#: backward 26 each (the embeddings', 2 a layer, the MLM head's); flash
#: 12 each (one a layer) only where attention takes no dropout
BERT_PER_STEP = {"layer_norm": 26, "layer_norm_bwd": 26, "flash_fwd": 0,
                 "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
BERT_FLASH_PER_STEP = dict(BERT_PER_STEP, flash_fwd=12, flash_bwd_dq=12,
                           flash_bwd_dkv=12)
BERT_MASK_ID = 103      # [MASK] in BERT-base's uncased WordPiece vocabulary


def bert_batch(torch, cfg, b, s, dev, seed):
    """One seeded MLM batch: random ids, sentence B from a random split
    on (token type 1), BERT_MLM_RATE of the positions picked and scored
    (labels -100 elsewhere), the picked inputs 80 % [MASK], 10 % a random
    id, 10 % unchanged (Devlin et al. 2019, sec. 3.1)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (b, s), generator=g)
    split = torch.randint(s // 4, 3 * s // 4, (b, 1), generator=g)
    types = (torch.arange(s)[None, :] >= split).long()
    pick = torch.rand(b, s, generator=g) < BERT_MLM_RATE
    labels = torch.where(pick, ids, -100)
    r = torch.rand(b, s, generator=g)
    rnd = torch.randint(0, cfg.vocab_size, (b, s), generator=g)
    inputs = torch.where(pick & (r < 0.8), BERT_MASK_ID, ids)
    inputs = torch.where(pick & (r >= 0.8) & (r < 0.9), rnd, inputs)
    return inputs.to(dev), types.to(dev), labels.to(dev)


def bert_loss(net, ids, types, labels):
    loss, _ = net(ids, types, labels=labels)
    return loss


def bert_flops(cfg, model, b, s):
    """Model FLOPs of one step: 6 a matmul weight per token (forward and
    backward; the MLM decoder multiplies every position by the tied
    [vocab, hidden] embedding) plus attention's 4 D forward and 8 D
    backward a (query, key) pair and head, in every layer."""
    n_matmul = sum(p.numel() for n, p in model.named_parameters()
                   if p.dim() == 2 and "embeddings" not in n)
    n_matmul += cfg.vocab_size * cfg.hidden_size
    d = cfg.hidden_size // cfg.num_attention_heads
    pairs = s * s * b * cfg.num_attention_heads
    return 6 * n_matmul * b * s + 12 * d * pairs * cfg.num_hidden_layers


def bert_train_run(torch, dev, phase, cfg, per_step, keys_per_step,
                   turns=False):
    """BERT-base MLM pretraining steps through jit.TrainStep (see the
    module docstring), launch counts and the counter stream's keys
    asserted per step; then one step under torch.profiler.  With
    ``turns``, then the same model's steps with attention dropout 0.1
    (the plain path) and 0 (flash) in turns, 4 steps a turn, the order
    0.1, 0, 0, 0.1, 0.1, 0 (the schedule has decayed to 0 by then, so
    the weights stay; the step's work is the same): host-clock step
    times swing by tens of percent between steps, so the two are only
    compared in one process, in turns."""
    from paddle_tpu_torch import random as prandom
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.bert import BertForMaskedLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import LinearWarmup, PolynomialDecay

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prandom.seed(2019)
    model = BertForMaskedLM(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    model.train()
    # BERT's recipe (Devlin et al. 2019, appendix A.2): AdamW(1e-4, 0.9,
    # 0.999), decay 0.01 off biases and LayerNorms, warm-up then linear
    # decay to 0 (both over this run's own steps), clip 1.0
    sched = LinearWarmup(PolynomialDecay(BERT_LR, BERT_TIMED, end_lr=0.0,
                                         power=1.0), BERT_WARMUP, 0.0,
                         BERT_LR)
    opt = AdamW(learning_rate=sched, beta1=0.9, beta2=0.999, epsilon=1e-8,
                parameters=model.named_parameters(), weight_decay=0.01,
                apply_decay_param_fun=lambda n: not (
                    n.endswith("bias") or "norm" in n),
                grad_clip=ClipGradByGlobalNorm(1.0), multi_precision=True,
                device=dev)
    step = TrainStep(model, bert_loss, opt, device=dev)
    batch = bert_batch(torch, cfg, BERT_BATCH, BERT_SEQ, dev, 1234)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    losses, lrs = [], []
    for _ in range(BERT_WARMUP):
        lrs.append(opt.get_lr())
        losses.append(step(*batch).item())
        sched.step()
    step_s = []
    reset_kernel_launches()
    key0 = prandom.get_rng_state()[1]
    for _ in range(BERT_TIMED):
        lrs.append(opt.get_lr())
        t1 = time.perf_counter()
        losses.append(step(*batch).item())        # .item() synchronises
        step_s.append(time.perf_counter() - t1)
        sched.step()
    launches = kernel_launches()
    keys = (prandom.get_rng_state()[1] - key0) / BERT_TIMED
    for name, n in per_step.items():
        if launches[name] != n * BERT_TIMED:
            raise AssertionError(f"{phase}: {name} launched {launches[name]}"
                                 f" times in {BERT_TIMED} steps, want {n} a "
                                 "step")
    if keys != keys_per_step:
        raise AssertionError(f"{phase}: {keys} dropout keys a step, want "
                             f"{keys_per_step}")
    timed = losses[BERT_WARMUP:]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{phase}: non-finite loss {losses}")
    # the loss is one bf16 value (spacing 0.0625 near 10), so a step whose
    # learning rate has decayed can leave it where it was: held to fall
    # over the timed steps, as unet_train's
    if not timed[-1] < timed[0]:
        raise AssertionError(f"{phase}: loss did not fall {timed}")
    mean_s = sum(step_s) / len(step_s)
    flops = bert_flops(cfg, model, BERT_BATCH, BERT_SEQ)
    # host time of the generators the step makes (one a dropout call)
    t1 = time.perf_counter()
    for _ in range(keys_per_step):
        prandom.next_generator(dev)
    gen_s = time.perf_counter() - t1
    out = {"phase": phase, "model": "BERT_BASE", "dtype": "bfloat16",
           "hidden_dropout": cfg.hidden_dropout_prob,
           "attention_dropout": cfg.attention_probs_dropout_prob,
           "batch": BERT_BATCH, "seq": BERT_SEQ,
           "params": sum(p.numel() for p in model.parameters()),
           "scored_tokens": int((batch[2] != -100).sum().item()),
           "setup_s": setup_s, "lr": lrs, "losses": losses,
           "step_s": step_s, "step_s_mean": mean_s,
           "seqs_per_s": BERT_BATCH / mean_s,
           "tokens_per_s": BERT_BATCH * BERT_SEQ / mean_s,
           "model_flops_per_step": flops,
           "model_tflops_per_s": flops / mean_s / 1e12,
           "mfu_of_989": flops / mean_s / 989e12,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "dropout_keys_per_step": keys,
           "generator_host_ms_per_step": gen_s * 1e3,
           "kernel_launches": launches, "launches_per_step": per_step}
    emit(out)
    prof = profiled(torch, lambda: step(*batch).item())
    emit(dict(prof, phase=phase + "_profile", steps=1))
    if turns:
        times = {0.1: [], 0.0: []}
        for p in (0.1, 0.0, 0.0, 0.1, 0.1, 0.0):
            for layer in model.bert.encoder.layers:
                layer.self_attn.dropout = p
            for _ in range(4):
                t1 = time.perf_counter()
                step(*batch).item()
                times[p].append(time.perf_counter() - t1)
        out["turns_step_s"] = {"attention_dropout_0.1": times[0.1],
                               "attention_dropout_0": times[0.0]}
        out["turns_median_ratio"] = (statistics.median(times[0.1])
                                     / statistics.median(times[0.0]))
        emit({"phase": phase + "_turns", "step_s": out["turns_step_s"],
              "median_ratio_dropout_over_flash": out["turns_median_ratio"]})
    del step, opt, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return launches, out


def bert_train_phase(torch, dev):
    """BASELINE config 2: BERT-base MLM at its default dropout 0.1, so
    attention drops and runs the plain f32 path; 49 keys a step (the
    embeddings' dropout, and 4 a layer)."""
    from paddle_tpu_torch.models.bert import BERT_BASE

    return bert_train_run(torch, dev, "bert_train", BERT_BASE,
                          BERT_PER_STEP, 1 + 4 * BERT_BASE.num_hidden_layers)


def bert_train_flash_phase(torch, dev):
    """The same with attention_probs_dropout_prob = 0: attention runs the
    flash kernels, 12 launches a step each; 37 keys a step."""
    from paddle_tpu_torch.models.bert import BERT_BASE

    cfg = dataclasses.replace(BERT_BASE, attention_probs_dropout_prob=0.0)
    return bert_train_run(torch, dev, "bert_train_flash", cfg,
                          BERT_FLASH_PER_STEP,
                          1 + 3 * cfg.num_hidden_layers, turns=True)


def bf16_ulp(x):
    """The spacing of bfloat16 values at ``x``."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


@contextlib.contextmanager
def twin_path(torch):
    """Every kernel of BERT's path replaced by its plain twin on CUDA
    tensors: the LayerNorm pair, and attention through the flash
    autograd function with ``flash_fwd_plain`` and ``flash_bwd_plain``,
    the kernels' own recompute form (``delta`` from the bf16 output, as
    the JAX kernel's ``paddle_tpu/ops/pallas/flash.py:251-253``)."""
    import importlib

    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.layer_norm import layer_norm_plain

    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    saved = fa.flash_fwd, fa.flash_bwd, F._layer_norm_op
    fa.flash_fwd, fa.flash_bwd = fa.flash_fwd_plain, fa.flash_bwd_plain
    F._layer_norm_op = layer_norm_plain
    try:
        yield
    finally:
        fa.flash_fwd, fa.flash_bwd, F._layer_norm_op = saved


def bert_parity_phase(torch, dev):
    """BERT-base, bf16, dropout 0: (1) one step's loss and every
    parameter's gradient through the kernels against their plain twins
    in bf16 (twin_path) and the plain functions on an f32 copy
    (grad_parity; the bf16 loss is one bf16 value, as JAX's, so its
    tolerance adds a bf16 step of it).  The yardstick is the twins, not
    torch autograd over the dense forward (train_parity's): at BERT's
    initial weights the attention is near uniform and the keys share a
    large common component, so the q and k gradients are a small
    difference that ``delta``'s rounding (from the bf16 output, as in
    JAX's kernel) swamps; the dense path's q/k errors are printed
    beside (PERF.md, findings); (2) an
    eval forward at s = 512 with a ragged padding mask, the logits of the
    unpadded positions likewise; (3) bert_train's first step (dropout
    0.1) twice from the same seeds: loss and gradients bit for bit."""
    from paddle_tpu_torch import random as prandom
    from paddle_tpu_torch.models.bert import BERT_BASE, BertForMaskedLM
    from paddle_tpu_torch.ops import kernel_launches, reset_kernel_launches

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(BERT_BASE, hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    model = BertForMaskedLM(cfg, device=dev, dtype=torch.bfloat16, seed=7)
    model.train()
    batch = bert_batch(torch, cfg, BERT_BATCH, BERT_SEQ, dev, 99)

    def grads_of(m):
        m.zero_grad(set_to_none=True)
        loss = bert_loss(m, *batch)
        loss.backward()
        out = {n: p.grad.float() for n, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
        return loss.item(), out

    reset_kernel_launches()
    kern = grads_of(model)
    launches = kernel_launches()
    if {k: launches[k] for k in BERT_FLASH_PER_STEP} != BERT_FLASH_PER_STEP:
        raise AssertionError(f"bert parity: launches {launches}, want "
                             f"{BERT_FLASH_PER_STEP}")
    model32 = copy.deepcopy(model).float()
    with twin_path(torch):
        plain = grads_of(model)
    with functional_plain_path(torch):
        dense = grads_of(model)
        f32 = grads_of(model32)
    # the key bias's gradient is 0: softmax is invariant to adding q.b_k
    # to a whole row of scores
    worst, report = grad_parity("bert parity", kern, plain, f32,
                                loss_floor=bf16_ulp(f32[0]),
                                zero_truth=("self_attn.k_proj.bias",))
    dense_err = {n: ((dense[1][n] - ref).norm() / ref.norm()).item()
                 for n, ref in f32[1].items()
                 if n.endswith(("q_proj.weight", "k_proj.weight"))}
    del kern, plain, dense, f32
    # (2) eval at s = 512, ragged padding: 8 sequences of 512 positions,
    # the first `lengths[i]` visible
    model.eval()
    model32.eval()
    g = torch.Generator(device="cpu").manual_seed(512)
    lengths = [512, 497, 384, 300, 257, 128, 65, 1]
    ids = torch.randint(0, cfg.vocab_size, (len(lengths), 512),
                        generator=g).to(dev)
    mask = (torch.arange(512)[None, :] < torch.tensor(lengths)[:, None]) \
        .long().to(dev)
    visible = mask.bool()
    with torch.no_grad():
        reset_kernel_launches()
        lk = model(ids, attention_mask=mask)[visible].float()
        eval_launches = kernel_launches()
        with functional_plain_path(torch):
            lp = model(ids, attention_mask=mask)[visible].float()
            l32 = model32(ids, attention_mask=mask)[visible]
    if eval_launches["layer_norm"] != BERT_PER_STEP["layer_norm"] or \
            eval_launches["flash_fwd"]:
        raise AssertionError(f"bert parity eval: launches {eval_launches}")
    e_k = ((lk - l32).norm() / l32.norm()).item()
    e_p = ((lp - l32).norm() / l32.norm()).item()
    tol = GRAD_PARITY_FACTOR * e_p + GRAD_PARITY_FLOOR
    if not e_k <= tol:
        raise AssertionError(f"bert parity eval s512: kernel logits rel err "
                             f"{e_k:.3e} > {tol:.3e} (plain bf16 {e_p:.3e})")
    del lk, lp, l32, model32, model
    gc.collect()
    torch.cuda.empty_cache()
    # (3) the same first step twice: same seeds, same masks, same bits
    runs = []
    for _ in range(2):
        prandom.seed(2019)
        m = BertForMaskedLM(BERT_BASE, device=dev, dtype=torch.bfloat16,
                            seed=0)
        m.train()
        b = bert_batch(torch, BERT_BASE, BERT_BATCH, BERT_SEQ, dev, 1234)
        loss = bert_loss(m, *b)
        loss.backward()
        runs.append((loss.detach(), {n: p.grad for n, p in
                                     m.named_parameters()}))
        del m, b, loss
    (la, ga), (lb, gb) = runs
    differ = [n for n in ga if not torch.equal(ga[n], gb[n])]
    if not torch.equal(la, lb) or differ:
        raise AssertionError(f"bert parity: the same seed gave another step "
                             f"(loss {la.item()} / {lb.item()}, gradients "
                             f"that differ: {differ[:5]})")
    del runs, ga, gb
    gc.collect()
    torch.cuda.empty_cache()
    top = sorted(report.items(), key=lambda kv: -kv[1][0])[:8]
    emit({"phase": "bert_parity", "batch": BERT_BATCH, "seq": BERT_SEQ,
          "dropout": 0.0, "worst_err_over_tol": worst,
          "params_checked": len(report),
          "largest_grad_rel_err_kernel_vs_plain_bf16": top,
          "q_k_weight_grad_rel_err_dense_plain_bf16": dense_err,
          "launches": launches,
          "eval_s512": {"lengths": lengths, "logit_rel_err_kernel": e_k,
                        "logit_rel_err_plain_bf16": e_p,
                        "launches": eval_launches},
          "same_seed_step": "loss and every gradient bitwise equal",
          "loss_bf16": la.item()})


def train_recompute_phase(torch, dev):
    """The train phase's model (TRAIN_LAYERS of LLaMA-2-7B, bf16, fused
    LM loss, AdamW multi_precision) with hidden_dropout_prob 0.1: two
    steps with use_recompute against the same two steps without, from
    the same weights and stream: losses, every gradient and the updated
    parameters bit for bit.  Measured on both: each step's forward and
    backward (host clock, synchronized) and its peak of allocated memory
    above what was allocated before it (activations, the gradients and
    what autograd keeps), and the optimizer step's time."""
    from paddle_tpu_torch import random as prandom
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from paddle_tpu_torch.optimizer import AdamW

    g = torch.Generator(device="cpu").manual_seed(4321)
    base = train_config(TRAIN_LAYERS)
    ids = torch.randint(0, base.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                        generator=g).to(dev)
    runs = {}
    for remat in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(base, hidden_dropout_prob=0.1,
                                  use_recompute=remat)
        model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                                 seed=0)
        model.train()
        opt = AdamW(learning_rate=3e-4, beta1=0.9, beta2=0.95, epsilon=1e-5,
                    parameters=model.named_parameters(), weight_decay=0.1,
                    multi_precision=True, device=dev)
        prandom.seed(77)
        reset_kernel_launches()
        losses, grads, fb_s, opt_s, fb_gb = [], [], [], [], []
        for _ in range(2):
            opt.clear_grad()
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            loss = loss_fn(model, ids, ids)
            loss.backward()
            torch.cuda.synchronize()
            fb_s.append(time.perf_counter() - t1)
            fb_gb.append((torch.cuda.max_memory_allocated() - before) / 1e9)
            grads.append({n: p.grad.clone() for n, p in
                          model.named_parameters()})
            t1 = time.perf_counter()
            opt.step()
            torch.cuda.synchronize()
            opt_s.append(time.perf_counter() - t1)
            losses.append(loss.detach())
        opt.clear_grad()
        runs[remat] = {
            "losses": losses, "grads": grads,
            "params": {n: p.detach() for n, p in model.named_parameters()},
            "fwd_bwd_s": fb_s, "opt_s": opt_s, "fwd_bwd_peak_gb": fb_gb,
            "keys": prandom.get_rng_state(), "launches": kernel_launches()}
        del opt, model, loss
    a, b = runs[False], runs[True]
    differ = [f"step {i} {n}" for i in range(2) for n in a["grads"][i]
              if not torch.equal(a["grads"][i][n], b["grads"][i][n])]
    differ += [n for n in a["params"]
               if not torch.equal(a["params"][n], b["params"][n])]
    if not all(torch.equal(x, y) for x, y in zip(a["losses"], b["losses"])) \
            or differ or a["keys"] != b["keys"]:
        raise AssertionError(f"train_recompute: recompute changed the step: "
                             f"losses {[x.item() for x in a['losses']]} / "
                             f"{[x.item() for x in b['losses']]}, keys "
                             f"{a['keys']} / {b['keys']}, differ "
                             f"{differ[:5]}")
    emit({"phase": "train_recompute", "model": "LLAMA2_7B widths",
          "layers": TRAIN_LAYERS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "hidden_dropout": 0.1,
          "losses": [x.item() for x in a["losses"]],
          "bitwise": "losses, every gradient of both steps, the updated "
                     "parameters",
          "fwd_bwd_peak_gb_above_resident": {
              "plain": a["fwd_bwd_peak_gb"],
              "recompute": b["fwd_bwd_peak_gb"]},
          "fwd_bwd_s": {"plain": a["fwd_bwd_s"], "recompute": b["fwd_bwd_s"]},
          "optimizer_s": {"plain": a["opt_s"], "recompute": b["opt_s"]},
          "step2_memory_ratio": b["fwd_bwd_peak_gb"][1]
          / a["fwd_bwd_peak_gb"][1],
          "step2_time_ratio": (b["fwd_bwd_s"][1] + b["opt_s"][1])
          / (a["fwd_bwd_s"][1] + a["opt_s"][1]),
          "launches": {"plain": a["launches"], "recompute": b["launches"]}})
    del runs, a, b
    gc.collect()
    torch.cuda.empty_cache()


#: the optimizers phase's parameters: BERT-base's word embedding, an FFN
#: matrix and a LayerNorm vector
OPTIMIZER_SHAPES = {"word_embeddings": (30522, 768), "linear1": (768, 3072),
                    "norm": (768,)}
#: the optimizers phase: each with coupled L2 where it takes one
OPTIMIZER_CASES = {
    "SGD": dict(weight_decay=0.01), "Momentum": dict(weight_decay=0.01),
    "Adagrad": dict(weight_decay=0.01), "Adadelta": dict(weight_decay=0.01),
    "RMSProp": dict(weight_decay=0.01), "Adam": dict(weight_decay=0.01),
    "AdamW": dict(weight_decay=0.01), "Adamax": dict(weight_decay=0.01),
    "Lamb": dict(lamb_weight_decay=0.01), "Rprop": dict(),
    "ASGD": dict(batch_num=2, weight_decay=0.01),
    "NAdam": dict(weight_decay=0.01), "RAdam": dict(weight_decay=0.01)}


def optimizers_phase(torch, dev):
    """Each of the 13 optimizers takes 3 steps on BERT-base-shaped f32
    parameters ([30522, 768], [768, 3072], [768]) on the card and the
    same steps on the CPU, from the same seeded values and gradients.
    Tolerance: every parameter and accumulator within 1e-5 of its
    largest magnitude (f32 elementwise ops round alike on both; the
    norms of Lamb and NAdam's powers may differ by ulps).  Also the
    card's step time (host clock, synchronized)."""
    from paddle_tpu_torch import optimizer as popt

    shapes = OPTIMIZER_SHAPES
    g = torch.Generator(device="cpu").manual_seed(13)
    init = {n: torch.randn(*s, generator=g) * 0.02 for n, s in
            shapes.items()}
    grads = [{n: torch.randn(*s, generator=g) * 1e-3 for n, s in
              shapes.items()} for _ in range(3)]
    report = {}
    for name, kw in OPTIMIZER_CASES.items():
        sides = {}
        for where in ("cpu", dev):
            params = {n: torch.nn.Parameter(t.clone().to(where))
                      for n, t in init.items()}
            opt = getattr(popt, name)(learning_rate=1e-3,
                                      parameters=list(params.items()),
                                      device=where, **kw)
            times = []
            for step_grads in grads:
                for n, p in params.items():
                    p.grad = step_grads[n].to(where)
                t1 = time.perf_counter()
                opt.step()
                if where != "cpu":
                    torch.cuda.synchronize()
                times.append(time.perf_counter() - t1)
                opt.clear_grad()
            sides[str(where)] = (params, opt, times)
        (cp, copt, _), (dp, dopt, dtimes) = sides["cpu"], sides[str(dev)]
        worst = 0.0
        for n in shapes:
            pairs = [(f"{n}", dp[n].detach(), cp[n].detach())] + [
                (f"{n}.{k}", v, copt._accumulators[id(cp[n])][k])
                for k, v in dopt._accumulators[id(dp[n])].items()]
            for label, got, want in pairs:
                got, want = got.cpu().float(), want.float()
                scale = want.abs().max().item()
                err = (got - want).abs().max().item()
                if not (math.isfinite(err) and err <= 1e-5 * scale + 1e-30):
                    raise AssertionError(f"optimizers {name} {label}: card "
                                         f"vs CPU max err {err:.3e}, scale "
                                         f"{scale:.3e}")
                worst = max(worst, err / max(scale, 1e-30))
            if torch.equal(dp[n].detach().cpu(), init[n]):
                raise AssertionError(f"optimizers {name}: {n} did not move")
        report[name] = {"worst_rel_err": worst, "card_step_ms": [
            t * 1e3 for t in dtimes]}
        del sides, cp, dp, copt, dopt
    emit({"phase": "optimizers", "steps": 3, "shapes": shapes,
          "tolerance": "1e-5 of each tensor's largest magnitude",
          "optimizers": report})


def sweep_main(torch, args):
    """``--gn-fwd-sweep`` or ``--ln-fwd-sweep``, ``[--variants] [--tree
    DIR]``: the GroupNorm or LayerNorm forward sweep alone
    (:func:`gn_fwd_sweep`, :func:`ln_fwd_sweep`), or with
    ``--paged-sweep`` the paged-attention cases and the row-invariance
    checks of the kernel phase (:func:`paged_cases`,
    :func:`paged_invariance_check`), of the ``paddle_tpu_torch`` under DIR
    (another checkout, e.g. a parent commit's) if given.  Builds the
    kernels first (the ptxas report's spills printed)."""
    if "--tree" in args:
        sys.path.insert(0, os.path.abspath(args[args.index("--tree") + 1]))
    import paddle_tpu_torch
    from paddle_tpu_torch import _build

    smi = nvidia_smi()
    built = _build.build_all(verbose=True)
    ptxas = [ln.strip() for info in built.values()
             for ln in info["log"].splitlines()
             if "Function properties for" in ln or "registers" in ln
             or "spill" in ln]
    emit({"phase": "environment", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "package": os.path.dirname(paddle_tpu_torch.__file__),
          "built": sorted(built), "ptxas": ptxas,
          "ptxas_spills": ptxas_spills(ptxas)})
    dev = torch.device("cuda")
    if "--paged-sweep" in args:
        paged_cases(torch, dev, {}, 0)
        paged_invariance_check(torch, dev)
    else:
        sweep = gn_fwd_sweep if "--gn-fwd-sweep" in args else ln_fwd_sweep
        sweep(torch, dev, 0, "--variants" in args)
    print(smi)
    return 0


def serve_phases_main(torch, args):
    """``--serve-phases NAME[,NAME...]``: build the kernels, make the
    engine phase's LLaMA-2-7B model and run only the named serve phases
    (``serve_structured``, ``serve_tier``), each with its own checks;
    for iterating on a phase without the whole script."""
    from paddle_tpu_torch import _build, resolve_device
    from paddle_tpu_torch.models.llama import LLAMA2_7B, LlamaForCausalLM

    names = args[args.index("--serve-phases") + 1].split(",")
    smi = nvidia_smi()
    built = _build.build_all(verbose=False)
    emit({"phase": "environment", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "built": sorted(built)})
    dev = resolve_device()
    model = LlamaForCausalLM(LLAMA2_7B, device=dev, dtype=torch.bfloat16,
                             seed=0)
    phases = {"serve_structured": serve_structured_phase,
              "serve_tier": serve_tier_phase}
    for name in names:
        t0 = time.perf_counter()
        launches = phases[name](torch, dev, model)
        emit({"phase": name, "seconds": time.perf_counter() - t0,
              "launches": launches})
    print(smi)
    return 0


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's "
              "kernels need a CUDA device", file=sys.stderr)
        return 1
    if {"--gn-fwd-sweep", "--ln-fwd-sweep",
            "--paged-sweep"} & set(sys.argv[1:]):
        return sweep_main(torch, sys.argv[1:])
    if "--serve-phases" in sys.argv[1:]:
        return serve_phases_main(torch, sys.argv[1:])
    from paddle_tpu_torch import _build, resolve_device

    dev = resolve_device()
    smi = nvidia_smi()
    t0 = time.perf_counter()
    built = _build.build_all(verbose=True)
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for info in built.values()
             for ln in info["log"].splitlines()
             if "Function properties for" in ln or "registers" in ln
             or "spill" in ln]
    emit({"phase": "environment", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0),
          "build_s": build_s, "built": sorted(built), "ptxas": ptxas,
          "ptxas_spills": ptxas_spills(ptxas)})

    summary = kernel_phase(torch, dev)
    serve, model, engine_figures = engine_phase(torch, dev)
    serve_prefix = serve_prefix_phase(torch, dev, model)
    serve_spec = serve_spec_phase(torch, dev, model)
    serve_quant = serve_quant_phase(torch, dev, model)
    serve_gateway = serve_gateway_phase(torch, dev, model, engine_figures)
    serve_structured = serve_structured_phase(torch, dev, model)
    serve_tier = serve_tier_phase(torch, dev, model)
    del model
    torch.cuda.empty_cache()
    train = train_phase(torch, dev)
    train_parity_phase(torch, dev)
    unet = unet_train_phase(torch, dev)
    unet_train_parity_phase(torch, dev)
    t_bert = time.perf_counter()
    bert, bert_figures = bert_train_phase(torch, dev)
    bert_flash, flash_figures = bert_train_flash_phase(torch, dev)
    emit({"phase": "bert_attention_dropout_cost",
          "step_s_mean": {"bert_train": bert_figures["step_s_mean"],
                          "bert_train_flash": flash_figures["step_s_mean"]},
          "turns_step_s": flash_figures["turns_step_s"],
          "turns_median_ratio": flash_figures["turns_median_ratio"],
          "peak_memory_gb": {
              "bert_train": bert_figures["peak_memory_gb"],
              "bert_train_flash": flash_figures["peak_memory_gb"]}})
    bert_parity_phase(torch, dev)
    train_recompute_phase(torch, dev)
    optimizers_phase(torch, dev)
    emit({"phase": "bert_recompute_optimizers_seconds",
          "seconds": time.perf_counter() - t_bert})

    # the first source is the kernel's; the int8 pool's loader and
    # conversion hooks live in both files
    sources = {
        "paged_attention": ("cuda", "paddle_tpu_torch/csrc/attention_sm90.cuh",
                            "paddle_tpu/serving/paged_attention.py:284",
                            "serve_gateway"),
        "paged_attention_int8": ("cuda",
                                 ("paddle_tpu_torch/csrc/attention_sm90.cuh",
                                  "paddle_tpu_torch/csrc/paged_attention.cu"),
                                 "paddle_tpu/serving/paged_attention.py:284",
                                 "serve_quant"),
        "rms_norm": ("triton", "paddle_tpu_torch/ops/rms_norm.py",
                     "paddle_tpu/ops/pallas/norms.py:220", "serve_gateway"),
        "rms_norm_bwd": ("triton", "paddle_tpu_torch/ops/rms_norm.py",
                         "paddle_tpu/ops/pallas/norms.py:257", "train"),
        "flash_fwd": ("cuda", "paddle_tpu_torch/csrc/attention_sm90.cuh",
                      "paddle_tpu/ops/pallas/flash.py:132", "train"),
        "flash_bwd_dq": ("cuda", "paddle_tpu_torch/csrc/flash_bwd_sm90.cuh",
                         "paddle_tpu/ops/pallas/flash.py:255", "train"),
        "flash_bwd_dkv": ("cuda",
                          "paddle_tpu_torch/csrc/flash_bwd_sm90.cuh",
                          "paddle_tpu/ops/pallas/flash.py:277", "train"),
        "layer_norm": ("cuda", "paddle_tpu_torch/csrc/norms.cu",
                       "paddle_tpu/ops/pallas/norms.py:79", "unet_train"),
        "layer_norm_bwd": ("cuda", "paddle_tpu_torch/csrc/norms.cu",
                           "paddle_tpu/ops/pallas/norms.py:141",
                           "unet_train"),
        "group_norm": ("cuda", "paddle_tpu_torch/csrc/norms.cu",
                       "paddle_tpu/ops/pallas/norms.py:366", "unet_train"),
        "group_norm_bwd": ("cuda", "paddle_tpu_torch/csrc/norms.cu",
                           "paddle_tpu/ops/pallas/norms.py:424",
                           "unet_train"),
    }
    runs = {"serve": serve, "serve_prefix": serve_prefix,
            "serve_spec": serve_spec, "serve_quant": serve_quant,
            "serve_gateway": serve_gateway,
            "serve_structured": serve_structured, "serve_tier": serve_tier,
            "train": train, "unet_train": unet, "bert_train": bert,
            "bert_train_flash": bert_flash}
    kernels = []
    for name, (route, source, replaces, path) in sources.items():
        c = summary[name]
        files = (source,) if isinstance(source, str) else source
        entry = {"name": name, "route": route, "source": files[0],
                 "source_files": list(files), "replaces": replaces,
                 "launches": runs[path][name],
                 "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                 "device_ms": c.get("device_ms"), "plain_ms": c["plain_ms"],
                 "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                 "library_ms": c["library_ms"], "case": c["name"],
                 "path": path,
                 "launches_by_path": {p: r.get(name, 0)
                                      for p, r in runs.items()}}
        bc = summary.get("bert/" + name)
        if bc is not None:          # the same kernel at BERT's shape
            entry["bert_case"] = {k: bc.get(k) for k in (
                "name", "max_abs_err", "ms", "device_ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms", "library_device_ms")}
        kernels.append(entry)
    print(smi)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
