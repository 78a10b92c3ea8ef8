#!/usr/bin/env python3
"""Build and run the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU
and check it: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises, so the script
exits nonzero and prints no result:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, and the build of every CUDA kernel from csrc/ (nvcc,
   with the ptxas register / spill report).
2. kernels: each kernel against its plain PyTorch twin on the same card
   inputs — ragged paged attention at the LLaMA-2-7B (32/32/128) and
   LLaMA-3-8B GQA (32/8/128) head layouts, decode (s=1, 8 lanes, ragged
   pos 0..2000) and prefill windows (s=128, s=512), bf16, f32 and an int8
   pool with per-token scales; RMSNorm at [8,4096] and [4096,4096].
   Tolerances are stated with the comparison (see TOLERANCES).  Prints
   each case's kernel, plain and library times and its bound.
3. engine: LlamaForCausalLM(LLAMA2_7B) in bf16, all 32 layers, random
   weights from a seeded generator on the card, served by
   Engine(num_slots=8, max_seq_len=2048) for 8 requests (prompts 16..1024
   tokens, half greedy, half sampled, 32 new tokens each), with the
   kernels' launch counts checked against the forwards the engine ran.
   The same workload then runs once more under torch.profiler for the
   device's idle share and the kernel time by name.
4. parity: one request through the engine (prefill + 8 greedy decode
   steps) against the uncached full-sequence forward of the same model
   (plain masked-softmax attention in f32, RMSNorm through the kernel),
   in bf16 and over an f32 copy of the weights (see PARITY_FACTOR).

The last three lines are the card's nvidia-smi line, the per-kernel JSON
summary and {"ok": true, "device": {...}}.  Exits 1 without a CUDA device.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}   # dense, no TF32

# (rtol, atol) of kernel vs plain on identical inputs.  Both compute in
# f32 and differ only in summation order (and the exp/rsqrt ulps): f32
# outputs agree to ~1e-6, so 1e-4 leaves two orders of margin over 2048
# keys; a bf16 output rounds the same f32 value, so a flip to the
# neighbouring bf16 value (relative step <= 2**-7) is the most it may move.
TOLERANCES = {"float32": (1e-4, 1e-4), "bfloat16": (2.0 ** -7, 1e-3)}
# engine vs the uncached forward: both run in bf16 and round at different
# points through 32 layers of GEMMs whose cuBLAS algorithms differ with M,
# so neither is the truth; the truth is the same forward over an f32 copy
# of the weights.  The engine's logits must be no further from it than
# PARITY_FACTOR times the bf16 uncached forward's own distance, plus
# PARITY_FLOOR of the largest |logit|; a wrong mask, rope position or cache
# write moves them far more than that
PARITY_FACTOR = 2.0
PARITY_FLOOR = 1e-3


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


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


def bound(nbytes, ops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, out, ref, dtype_name):
    import torch

    rtol, atol = TOLERANCES[dtype_name]
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (out.float() - ref.float()).abs()
    limit = atol + rtol * ref.float().abs()
    if not (err <= limit).all():
        raise AssertionError(f"{name}: max |kernel - plain| "
                             f"{err.max().item():.3e} beyond rtol {rtol} "
                             f"atol {atol}")
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


def paged_library_fn(torch, q, k, v, tables, pos):
    """SDPA over K/V gathered to contiguous memory with the same
    visibility mask: the library yardstick (set-up not timed)."""
    import torch.nn.functional as F

    b, s, qh, d = q.shape
    kh = k.shape[2]
    length = int(pos.max().item()) + s
    nbl = -(-length // k.shape[1])
    kg = k[tables[:, :nbl].long()].reshape(b, -1, kh, d)[:, :length]
    vg = v[tables[:, :nbl].long()].reshape(b, -1, kh, d)[:, :length]
    kg = kg.repeat_interleave(qh // kh, dim=2).transpose(1, 2).contiguous()
    vg = vg.repeat_interleave(qh // kh, dim=2).transpose(1, 2).contiguous()
    qt = q.transpose(1, 2).contiguous()
    q_pos = pos.long()[:, None] + torch.arange(s, device=q.device)
    mask = (torch.arange(length, device=q.device)[None, None, :]
            <= q_pos[:, :, None])[:, None]                  # [B,1,s,L]
    return lambda: F.scaled_dot_product_attention(qt, kg, vg,
                                                  attn_mask=mask)


def kernel_phase(torch, dev):
    from paddle_tpu_torch.ops.rms_norm import rms_norm, rms_norm_plain
    from paddle_tpu_torch.serving.paged_attention import (
        paged_attention, paged_attention_plain,
    )

    summary = {}
    decode_pos = [0, 17, 130, 511, 777, 1024, 1500, 2000]
    windows = [("decode", 1, decode_pos), ("prefill128", 128, [0, 700]),
               ("prefill512", 512, [0, 700])]
    layouts = [("llama2_7b", 32, 32), ("llama3_8b_gqa", 32, 8)]
    variants = [("bfloat16", False), ("float32", False), ("bfloat16", True)]
    seed = 0
    for lname, qh, kh in layouts:
        for wname, s, pos_list in windows:
            for dname, quant in variants:
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
                kern_ms = cuda_ms(
                    lambda: paged_attention(q, k, v, tables, pos, ks, vs), 20)
                plain_ms = cuda_ms(
                    lambda: paged_attention_plain(q, k, v, tables, pos,
                                                  ks, vs), 3)
                lib_ms = None
                if not quant:
                    lib = paged_library_fn(torch, q, k, v, tables, pos)
                    lib_ms = cuda_ms(lib, 10)
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
                case = {"phase": "kernel", "name": name,
                        "q": list(q.shape), "pos": pos_list,
                        "max_abs_err": err, "ms": kern_ms,
                        "plain_ms": plain_ms, "library_ms": lib_ms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "bytes": nbytes, "ops": ops}
                emit(case)
                if (lname, wname, dname, quant) == (
                        "llama2_7b", "decode", "bfloat16", False):
                    summary["paged_attention"] = case
    for shape in ((8, 4096), (4096, 4096)):
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
            kern_ms = cuda_ms(lambda: rms_norm(x, w, 1e-6), 50)
            plain_ms = cuda_ms(lambda: rms_norm_plain(x, w, 1e-6), 10)
            lib = getattr(torch.nn.functional, "rms_norm", None)
            lib_ms = None if lib is None else cuda_ms(
                lambda: lib(x, (shape[-1],), w, 1e-6), 50)
            nbytes = (2 * x.numel() + w.numel()) * x.element_size()
            b_ms, b_by = bound(nbytes, 4 * x.numel(), dname)
            case = {"phase": "kernel", "name": name, "x": list(shape),
                    "max_abs_err": err, "ms": kern_ms,
                    "plain_ms": plain_ms, "library_ms": lib_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}
            emit(case)
            if (shape, dname) == ((8, 4096), "bfloat16"):
                summary["rms_norm"] = case
    return summary


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
    if eng.pool.blocks_in_use != 0:
        raise AssertionError(f"{eng.pool.blocks_in_use} blocks in use "
                             "after the drain")
    forwards = delta["prefill_calls"] + delta["decode_steps"]
    layers = cfg.num_hidden_layers
    if launches["paged_attention"] != layers * forwards:
        raise AssertionError(f"paged_attention launches "
                             f"{launches['paged_attention']} != {layers} x "
                             f"{forwards} forwards")
    if launches["rms_norm"] != (2 * layers + 1) * forwards:
        raise AssertionError(f"rms_norm launches {launches['rms_norm']} != "
                             f"{2 * layers + 1} x {forwards} forwards")
    ttft = [r.ttft for r in reqs]
    emit({"phase": "engine", "model": "LLAMA2_7B", "layers": layers,
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
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})

    profile_phase(torch, eng, prompts, params)

    # ---- phase 4: parity of one request against the uncached forward
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    captured = []
    hook = model.lm_head.register_forward_hook(
        lambda mod, inp, out: captured.append(out.detach().float()))
    prompt = torch.randint(0, cfg.vocab_size, (200,), generator=g).tolist()
    try:
        req = eng.submit(prompt, SamplingParams(max_new_tokens=9))
        eng.run()
    finally:
        hook.remove()
    steps = [captured[0][0]] + [c[req.slot] for c in captured[1:]]
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
          "reference": "uncached full-sequence forward (plain f32 causal "
                       "softmax attention, RMSNorm kernel) in bf16 and in "
                       "an f32 copy of the same weights"})
    return launches


def profile_phase(torch, eng, prompts, params):
    """The engine workload once more under torch.profiler: the device's
    busy share of the wall time (union of kernel intervals) and the
    kernel time by name.  The profiler slows the host, so the idle share
    here is an upper bound of the unprofiled run's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for p, sp in zip(prompts, params):
            eng.submit(p, sp)
        eng.run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
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
    emit({"phase": "profile", "wall_ms": wall_us / 1e3,
          "device_busy_ms": busy / 1e3 if kernels else "not measured",
          "device_idle_share": 1 - busy / wall_us if kernels
          else "not measured",
          "kernel_events": len(kernels),
          "top_kernels_ms": [[n[:80], t / 1e3] for n, t in top]})


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's "
              "kernels need a CUDA device", file=sys.stderr)
        return 1
    from paddle_tpu_torch import _build, resolve_device

    dev = resolve_device()
    smi = nvidia_smi()
    t0 = time.perf_counter()
    built = _build.build_all(verbose=True)
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for info in built.values()
             for ln in info["log"].splitlines() if "registers" in ln
             or "spill" in ln]
    emit({"phase": "environment", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0),
          "build_s": build_s, "built": sorted(built), "ptxas": ptxas})

    summary = kernel_phase(torch, dev)
    launches = engine_phase(torch, dev)

    sources = {
        "paged_attention": ("cuda", "paddle_tpu_torch/csrc/paged_attention.cu",
                            "paddle_tpu/serving/paged_attention.py:284"),
        "rms_norm": ("triton", "paddle_tpu_torch/ops/rms_norm.py",
                     "paddle_tpu/ops/pallas/norms.py:220"),
    }
    kernels = []
    for name, (route, source, replaces) in sources.items():
        c = summary[name]
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                        "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                        "bound_by": c["bound_by"],
                        "library_ms": c["library_ms"], "case": c["name"]})
    print(smi)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
