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
   pos 0..2000) and prefill windows (s=128, s=512), bf16, f32 and an int8
   pool with per-token scales, and the engine's own prefill geometry (8
   lanes x 1024 at pos 0, bf16); then the bf16 paged kernel's row
   invariance, bit for bit (tables widened by scratch columns; one
   s=512 window against 8 windows of 64 and 512 one-row decode lanes);
   RMSNorm forward at [8,4096], [4096,4096]
   and [8192,4096]; RMSNorm backward at [8192,4096] (bf16, f32) and
   [8,4096]; flash attention forward, dQ and dK/dV at the train phase's
   batch of 2 sequences: 7B MHA s=4096 causal (bf16, f32), 8B GQA s=4096,
   s=1000 (ragged edge), s=1024 not causal, a 256-query block over 1024
   keys and 1024 queries over 256 keys (causal: the first 768 rows see no
   key, so their dQ must be exactly 0 and the visible rows alone must
   give the same dK/dV); and at the SD UNet's attention calls (batch 4, 8
   heads, self over 4096/1024/256/64 tokens and cross over 77, head dims
   40/80/160/160), each case with the dK/dV kernel's query split
   (dkv_splits); then the bf16 backward's determinism, dQ, dK and dV bit
   for bit over two calls at the LM shape (one query range) and the
   UNet's level-0 cross-attention (16 ranges summed by a second kernel); LayerNorm forward and backward at [16384,320],
   [4096,640], [1024,1280] (bf16) and [4096,640] (f32); GroupNorm
   forward and backward at [4,320,64,64], [4,960,64,64], [4,2560,8,8]
   (bf16, 32 groups) and [4,320,64,64] (f32).  Tolerances are stated
   with the comparisons (TOLERANCES).  Each case
   prints its kernel, plain and library times and its bound; the
   attention and norm cases (RMSNorm too) also the kernel's and the
   library's device time under torch.profiler (device_ms), which leaves
   out the host launch path, and the attention cases the achieved TFLOP/s and share of
   the bound from it.  Then the
   RMSNorm autograd repair: gradients through the kernel path's
   rms_norm must equal those of the plain forward under torch autograd;
   and a shape, dtype or head dim that no kernel takes (2-D GroupNorm,
   float64 norms, head dim 192, float16 attention) must raise through
   nn.functional on the card.
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

The last three lines are the card's nvidia-smi line, the per-kernel JSON
summary and {"ok": true, "device": {...}}.  Exits 1 without a CUDA device.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}   # dense, no TF32

# (rtol, fraction of max |plain|) of every kernel vs its plain twin on
# identical inputs: elementwise |kernel - plain| <= rtol |plain| + frac
# max|plain|.  Both sides compute in f32 and differ in summation order
# (and the exp/log/rsqrt ulps).  A bf16 output rounds an f32 value that
# moved by ~1e-6, so it may flip to the neighbouring bf16 value (at most
# 2**-7 of itself); values near 0 are held to 1e-3 of the tensor's
# largest.  f32 outputs agree to ~1e-6 relative over 4096 keys: 1e-4
# leaves two orders of margin, and 1e-5 of the largest value covers
# elements that cancel to near 0.
TOLERANCES = {"bfloat16": (2.0 ** -7, 1e-3), "float32": (1e-4, 1e-5)}
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
    is profiled once more."""
    import statistics

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    by_name = {}
    for _ in range(2):         # once more when no kernel event arrived
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


def rates(case, ops):
    """Achieved TFLOP/s and share of the bound from a case's device time."""
    dev_ms = case.get("device_ms")
    if isinstance(dev_ms, float) and dev_ms > 0:
        case["tflops"] = ops / dev_ms / 1e9
        case["bound_share"] = case["bound_ms"] / dev_ms
    return case


def paged_invariance_check(torch, dev):
    """Row invariance of the bf16 paged kernel, bit for bit on the card,
    for both layouts: (a) nb: the decode and prefill512 inputs with 7
    scratch columns appended to every table give equal outputs; (b) the
    window: the rows of one s = 512 window at pos 0 equal the same rows
    computed as 8 windows of 64 at pos 0, 64, ... and as 512 one-row
    decode lanes (lane r at pos r), over the same pool."""
    from paddle_tpu_torch.serving.paged_attention import paged_attention

    report = {}
    for lname, qh, kh in (("llama2_7b", 32, 32), ("llama3_8b_gqa", 32, 8)):
        for wname, s, pos_list in (("decode", 1, [0, 17, 130, 511, 777,
                                                  1024, 1500, 2000]),
                                   ("prefill512", 512, [0, 700])):
            (q, k, v, tables, pos, _, _), _ = paged_case(
                torch, qh, kh, s, pos_list, torch.bfloat16, False, 77, dev)
            wide = torch.cat([tables, torch.zeros_like(tables[:, :7])], 1)
            a = paged_attention(q, k, v, tables, pos)
            b = paged_attention(q, k, v, wide.contiguous(), pos)
            if not torch.equal(a, b):
                raise AssertionError(f"paged nb invariance {lname}/{wname}: "
                                     f"{(a != b).sum().item()} elements differ")
            report[f"{lname}/{wname}/nb+7"] = "equal"
        (q, k, v, tables, pos, _, _), _ = paged_case(
            torch, qh, kh, 512, [0], torch.bfloat16, False, 78, dev)
        whole = paged_attention(q, k, v, tables, pos)[0]
        pos64 = torch.arange(0, 512, 64, dtype=torch.int32, device=dev)
        win = torch.cat([paged_attention(q[:, w:w + 64].contiguous(), k, v,
                                         tables, pos64[i:i + 1])[0]
                         for i, w in enumerate(range(0, 512, 64))])
        rows = paged_attention(
            q[0][:, None].contiguous(), k, v,
            tables.expand(512, -1).contiguous(),
            torch.arange(512, dtype=torch.int32, device=dev))[:, 0]
        for form, got in (("8 windows of 64", win), ("512 decode rows", rows)):
            if not torch.equal(whole, got):
                raise AssertionError(
                    f"paged window invariance {lname}: {form} differ from "
                    f"one s=512 window in {(whole != got).sum().item()} "
                    "elements")
            report[f"{lname}/s512 vs {form}"] = "equal"
    emit({"phase": "paged_invariance", "dtype": "bfloat16",
          "checks": report})


def kernel_phase(torch, dev):
    from paddle_tpu_torch.ops.rms_norm import rms_norm, rms_norm_plain
    from paddle_tpu_torch.serving.paged_attention import (
        paged_attention, paged_attention_plain,
    )

    summary = {}
    decode_pos = [0, 17, 130, 511, 777, 1024, 1500, 2000]
    windows = [("decode", 1, decode_pos), ("prefill128", 128, [0, 700]),
               ("prefill512", 512, [0, 700]),
               ("prefill8x1024", 1024, [0] * 8)]   # the engine's prefill
    layouts = [("llama2_7b", 32, 32), ("llama3_8b_gqa", 32, 8)]
    variants = [("bfloat16", False), ("float32", False), ("bfloat16", True)]
    seed = 0
    for lname, qh, kh in layouts:
        for wname, s, pos_list in windows:
            for dname, quant in variants:
                if wname == "prefill8x1024" and (dname, quant) != (
                        "bfloat16", False):
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
                lib_ms = lib_dev = None
                if not quant:
                    lib = paged_library_fn(torch, q, k, v, tables, pos)
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
                if (lname, wname, dname, quant) == (
                        "llama2_7b", "decode", "bfloat16", False):
                    summary["paged_attention"] = case
                del q, k, v, tables, pos, ks, vs
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
    cases = [c + (b, d) for c in cases] + unet_flash_shapes()
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


def norm_cases(torch, dev, summary, seed):
    """LayerNorm and GroupNorm forward and backward kernels vs their
    plain twins on the same card inputs (the backward from the plain
    forward's statistics, so each kernel is held alone), at the UNet
    train step's shapes: LayerNorm over [4 * HW, C] rows, GroupNorm over
    [4, C, H, W] with 32 groups (960 channels at 64x64 is the longest
    row, 30 x 4096 elements).  Library yardstick: F.layer_norm and
    F.group_norm, forward and backward (graph built once, not timed).
    Bounds: bytes (x, y or x, g, dx once each, the affine vectors, the
    f32 statistics) over 3.35 TB/s, or 7 (forward) and 12 (backward)
    operations per element, whichever is larger."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.group_norm import (
        group_norm_bwd_kernel, group_norm_bwd_plain, group_norm_fwd_plain,
        group_norm_kernel,
    )
    from paddle_tpu_torch.ops.layer_norm import (
        layer_norm_bwd_kernel, layer_norm_bwd_plain, layer_norm_fwd_plain,
        layer_norm_kernel,
    )

    ln = [((16384, 320), "bfloat16"), ((4096, 640), "bfloat16"),
          ((1024, 1280), "bfloat16"), ((4096, 640), "float32")]
    gn = [((4, 320, 64, 64), "bfloat16"), ((4, 960, 64, 64), "bfloat16"),
          ((4, 2560, 8, 8), "bfloat16"), ((4, 320, 64, 64), "float32")]
    for kind, shapes in (("layer_norm", ln), ("group_norm", gn)):
        for shape, dname in shapes:
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
                args, eps = (32,), 1e-5
                fwd_k, fwd_p = group_norm_kernel, group_norm_fwd_plain
                bwd_k, bwd_p = group_norm_bwd_kernel, group_norm_bwd_plain
                lib = lambda x_, w_, b_: F.group_norm(x_, 32, w_, b_, eps)
                rows = shape[0] * 32
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
                emit(case)
                if dname == "bfloat16" and shape in ((4096, 640),
                                                     (4, 960, 64, 64)):
                    summary[kname] = case
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
    through the functionals the models call: nothing falls back to plain
    torch, a plain twin or a library call."""
    from paddle_tpu_torch.nn import functional as F

    bf, f64 = torch.bfloat16, torch.float64
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
          "reference": "uncached full-sequence forward (flash-attention "
                       "and RMSNorm kernels) in bf16 and in an f32 copy of "
                       "the same weights: the paged and the flash kernel, "
                       "both held against the f32 forward"})
    return launches


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
    ("paged_attention", ("paged_attn", "PagedProblem")),
    ("group_norm", ("_gn_fwd", "_gn_bwd")),
    ("layer_norm", ("_ln_fwd", "_ln_bwd")),
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
    worst, report = 0.0, {}
    for n, ref in g_32.items():
        norm = ref.norm().item()
        e_k = (g_k[n] - ref).norm().item() / norm
        e_p = (g_p[n] - ref).norm().item() / norm
        tol = GRAD_PARITY_FACTOR * e_p + GRAD_PARITY_FLOOR
        report[n] = [e_k, e_p]
        worst = max(worst, e_k / tol)
        if not (math.isfinite(e_k) and e_k <= tol):
            raise AssertionError(f"train parity {n}: kernel grad rel err "
                                 f"{e_k:.3e} > {tol:.3e} (plain bf16 "
                                 f"{e_p:.3e})")
    l_tol = (GRAD_PARITY_FACTOR * abs(loss_p - loss_32)
             + GRAD_PARITY_FLOOR * abs(loss_32))
    if not abs(loss_k - loss_32) <= l_tol:
        raise AssertionError(f"train parity loss: kernel {loss_k} plain "
                             f"bf16 {loss_p} f32 {loss_32}")
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
def unet_plain_path(torch):
    """The UNet's norms and attention through the plain twins (torch
    autograd over the plain forwards), for the reference passes."""
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
    with unet_plain_path(torch):
        loss_p, g_p = grads_of(model, torch.bfloat16)
        model32 = copy.deepcopy(model).float()
        loss_32, g_32 = grads_of(model32, torch.float32)
    del model32, model
    worst, report = 0.0, {}
    for n, ref in g_32.items():
        norm = ref.norm().item()
        e_k = (g_k[n] - ref).norm().item() / norm
        e_p = (g_p[n] - ref).norm().item() / norm
        tol = GRAD_PARITY_FACTOR * e_p + GRAD_PARITY_FLOOR
        report[n] = [e_k, e_p]
        worst = max(worst, e_k / tol)
        if not (math.isfinite(e_k) and e_k <= tol):
            raise AssertionError(f"unet parity {n}: kernel grad rel err "
                                 f"{e_k:.3e} > {tol:.3e} (plain bf16 "
                                 f"{e_p:.3e})")
    l_tol = (GRAD_PARITY_FACTOR * abs(loss_p - loss_32)
             + GRAD_PARITY_FLOOR * abs(loss_32))
    if not abs(loss_k - loss_32) <= l_tol:
        raise AssertionError(f"unet parity loss: kernel {loss_k} plain "
                             f"bf16 {loss_p} f32 {loss_32}")
    top = sorted(report.items(), key=lambda kv: -kv[1][0])[:8]
    emit({"phase": "unet_train_parity", "block_out_channels": [320, 640,
                                                               1280],
          "layers_per_block": 1, "batch": 2, "latent": [32, 32],
          "loss_kernel_bf16": loss_k, "loss_plain_bf16": loss_p,
          "loss_plain_f32": loss_32, "worst_err_over_tol": worst,
          "params_checked": len(report),
          "largest_grad_rel_err_kernel_vs_plain_bf16": top,
          "launches": launches})


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
    serve = engine_phase(torch, dev)
    train = train_phase(torch, dev)
    train_parity_phase(torch, dev)
    unet = unet_train_phase(torch, dev)
    unet_train_parity_phase(torch, dev)

    sources = {
        "paged_attention": ("cuda", "paddle_tpu_torch/csrc/attention_sm90.cuh",
                            "paddle_tpu/serving/paged_attention.py:284",
                            "serve"),
        "rms_norm": ("triton", "paddle_tpu_torch/ops/rms_norm.py",
                     "paddle_tpu/ops/pallas/norms.py:220", "serve"),
        "rms_norm_bwd": ("triton", "paddle_tpu_torch/ops/rms_norm.py",
                         "paddle_tpu/ops/pallas/norms.py:257", "train"),
        "flash_fwd": ("cuda", "paddle_tpu_torch/csrc/attention_sm90.cuh",
                      "paddle_tpu/ops/pallas/flash.py:132", "train"),
        "flash_bwd_dq": ("cuda", "paddle_tpu_torch/csrc/flash_bwd_sm90.cuh",
                         "paddle_tpu/ops/pallas/flash.py:255", "train"),
        "flash_bwd_dkv": ("cuda",
                          "paddle_tpu_torch/csrc/flash_bwd_sm90.cuh",
                          "paddle_tpu/ops/pallas/flash.py:277", "train"),
        "layer_norm": ("triton", "paddle_tpu_torch/ops/layer_norm.py",
                       "paddle_tpu/ops/pallas/norms.py:79", "unet_train"),
        "layer_norm_bwd": ("triton", "paddle_tpu_torch/ops/layer_norm.py",
                           "paddle_tpu/ops/pallas/norms.py:141",
                           "unet_train"),
        "group_norm": ("triton", "paddle_tpu_torch/ops/group_norm.py",
                       "paddle_tpu/ops/pallas/norms.py:366", "unet_train"),
        "group_norm_bwd": ("triton", "paddle_tpu_torch/ops/group_norm.py",
                           "paddle_tpu/ops/pallas/norms.py:424",
                           "unet_train"),
    }
    runs = {"serve": serve, "train": train, "unet_train": unet}
    kernels = []
    for name, (route, source, replaces, path) in sources.items():
        c = summary[name]
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": runs[path][name],
                        "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                        "device_ms": c.get("device_ms"),
                        "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                        "bound_by": c["bound_by"],
                        "library_ms": c["library_ms"], "case": c["name"],
                        "path": path,
                        "launches_by_path": {p: r[name]
                                             for p, r in runs.items()}})
    print(smi)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
