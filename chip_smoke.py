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
   float64 norms, head dim 192 in bf16 and in float16) must raise through
   nn.functional on the card, and a serving engine whose pool the paged
   kernel cannot take (block 8, head dim 32) must raise when it is built.
   float16: the paged kernel over a float16 pool (decode, s = 5, the
   engine's 8 x 1024 prefill) and under an int8 pool (decode), its row
   invariance; flash forward, dQ and dK/dV at the LM shapes (7B and 8B
   GQA, s = 4096, causal), BERT-base's s = 128 and 512 and the UNet's
   level-1 self-attention (D 80); the float16 backward bit for bit over
   two calls, as the bf16 one.
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
   The serving phases after it run LLaMA-2-7B's widths at SERVE_LAYERS
   = 8 layers (serve_model; the engine phase alone keeps 32), with every
   check and bitwise comparison they held at 32.
   serve_prefix, on that model and the engine geometry (SERVE_SLOTS,
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
14. resnet_train: bench_resnet50 (benchmarks/bench_models.py:116-152):
   resnet50(num_classes=1000) in bf16 from seeded weights made on the
   card, Momentum(0.025, 0.9) (RESNET_LR: the bench's 0.1 for 256
   images, scaled to 64), cross-entropy on f32 logits, through
   jit.TrainStep on one numpy-seeded batch of 64 x 3 x 224 x 224 with
   cudnn.benchmark on: 2 warm-up and 4 timed steps (host clock, each
   ending in loss.item()), the loss falling over them, no port kernel
   launched (none lies on this path), every BatchNorm buffer moved and
   finite; an eval pass whose finite logits give metric.Accuracy top-1
   and top-5 equal to a direct topk count.  Printed: images/s, step
   seconds (mean, range), model FLOP/s (hooks on every Conv2D and
   Linear, 3 x forward) and its share of 989 TFLOP/s, peak memory, one
   profiled step (busy against wall, kernel launches, device ms by kind:
   cuDNN's convolutions, the elementwise and reduction passes, and
   Momentum's loop told apart by its record_function span on the
   device), and the device time of a step's BatchNorm forwards and
   backwards run alone.
15. resnet_amp: the same ResNet-50 in f32 under amp.auto_cast O1
   float16 with amp.GradScaler through TrainStep(scaler=): 4 timed
   steps beside resnet_train's images/s, the scale's path, a dtype
   census of one forward (conv and Linear float16, BatchNorm and the
   loss float32); a step forced to overflow (scale 2**40) leaves every
   parameter and velocity bit for bit, moves the buffers and halves
   the scale; steps until one fits, then two that train.
16. resnet_parity: ResNet-50, b4 x 224 px, weights from one numpy seed
   through convert.state_from_jax (each bottleneck's
   bn3.weight at RESNET_BRANCH_SCALE): one Momentum TrainStep on the
   card and the CPU in f32 (TF32 off) and bf16 against the CPU in f64:
   the logits, the loss, every gradient, parameter and buffer, the card
   within GRAD_PARITY_FACTOR of the CPU's error plus GRAD_PARITY_FLOOR;
   the same seed's bf16 step twice with cudnn.deterministic, bit for
   bit.
17. hapi_fit: the high-level API over ResNet-50 (resnet50(num_classes=
   1000) in f32, cudnn.benchmark on, TF32 off in cuDNN and cuBLAS, as
   the phases before it leave them): FakeData
   (HAPI_TRAIN images of 3 x 224 x 224, 1,000 classes, seed 0) through
   RandomHorizontalFlip and ImageNet's Normalize, an io.DataLoader of 64
   (shuffled, drop_last, HAPI_WORKERS thread workers, batches pinned and
   copied to the card), Model.prepare(Momentum, nn.CrossEntropyLoss,
   Accuracy top-1/top-5).fit for one epoch with eval_data (HAPI_EVAL
   images, seed 1), evaluate, predict on one batch: no port kernel
   launched, finite figures of the right shape.  Model.save, then
   Model.load into a fresh model: every parameter, buffer and velocity,
   evaluate and a predict_batch bit for bit (cuDNN deterministic).
   Wiring: HAPI_WIRING_STEPS steps of fit and of a plain TrainStep over
   the same unshuffled batches from one initial state leave every
   parameter, buffer and velocity bit for bit equal.  Printed: fit's
   step seconds after HAPI_WARM warm steps (host clock between batch
   ends: the loader's wait, the copy and the step), each batch's loader
   stall (dataloader.stall_seconds), fit and a TrainStep loop on batches
   already on the card in turns (fit, loop, loop, fit) and their ratio,
   one profiled fit step (the loader's wait included) and peak memory.
18. serve_fp16 (after serve_tier): a float16 LLaMA (SERVE_LAYERS layers)
   served with no cache dtype, so the pool follows the model into
   float16: 8 greedy requests batched and one at a time, bitwise equal.
19. bert_amp (after bert_train_flash): BERT-base at bert_train_flash's
   config under amp.decorate O2 float16 (f32 master weights, GradScaler,
   the flash kernels in float16), and in f32 under O1 float16 with
   attention dropout 0.1: finite, falling losses, the scale path
   matching the skipped steps, sequences a second in turns with the
   bf16 step.
20. lbfgs and transformer_mt (after optimizers): LBFGS on the card
   against the CPU's iterates; Transformer-base translation from a
   PTRECD01 record file through RecordDataset and the DataLoader,
   TrainStep.many under O1 float16 with a GradScaler, then greedy decoding
   through the incremental caches (the flash forward at q_len 1), each
   step's logits against the full forward's.
21. hapi_fit_bert: benchmarks/ab_hapi_fit.py on the card:
   BertForMaskedLM(BERT_BASE) at bert_train_flash's config (attention
   dropout 0) in bf16, AdamW(1e-4, multi_precision) and MLMLoss through
   Model.fit over a TensorDataset of HAPI_BERT_STEPS x 32 seeded MLM
   sequences of 128: LayerNorm 26 + 26 and flash 12 + 12 + 12 launches a
   step asserted; fit and a TrainStep loop on one batch on the card in
   turns, their sequences a second beside bert_train_flash's.
22. the fused generation stack (after serve_fp16): fused_decode,
   GPT-3 6.7B widths (FUSED_GPT3: 32 layers, 4096, 32 heads of 128, FFN
   16,384, learned positions, a tied 50,257-token head) in bf16 through
   incubate.nn.functional.fused_multi_transformer as
   benchmarks/bench_decode.py drives it: b 8 and then b 1 prompts of 512
   tokens, a prefill into 1024-token caches (the flash forward 32 times,
   the LayerNorm 65) and 128 greedy steps with time_step on the host
   (the LayerNorm 65 times a step), once untimed and once timed, each
   checked step's logits against a fresh prefill of the same tokens
   (fused_frac) and the greedy token where the top-2 gap clears the
   bound; a 2-layer slice's kernel calls against their plain twins;
   prefill and decode tokens/s beside the weight-byte bound, the host's
   enqueue time, one profiled step, peak memory. fused_rotary: 8 layers
   of the same widths with inline NeoX and GPT-J rotary (b 4 x 256, 16
   steps, the same checks), then masked_multihead_attention at 32 x 128
   against its dense composition. fused_layers:
   FusedTransformerEncoderLayer at BERT-base width against
   nn.TransformerEncoderLayer over the same weights in f32, 4 bf16 AdamW
   steps on the kernels (launches asserted), fused_rms_norm's kernel
   route.

23. the vision model zoo (after hapi_fit_bert; no port kernel lies on
   it: cuDNN's convolutions, the rest plain torch): zoo_train,
   mobilenet_v3_large(num_classes=1000) at scale 1.0 in bf16, b 128 x
   224 px, Momentum(0.05, 0.9) through jit.TrainStep, 2 warm-up and 4
   timed steps: finite losses, every BatchNorm buffer moved; images/s,
   model FLOP/s (hapi.flops), one profiled step's idle share and top
   kernels, peak memory, no port kernel launched.
24. zoo_forward: each of the 25 constructors but the nine ResNets at its
   published input (LeNet 1 x 28 x 28, Inception-v3 299 px, the rest 224
   px), bf16 b 8: an eval forward (shape, finite, eval images/s) and a
   train-mode forward and backward (finite gradients; GoogLeNet's aux
   heads in the loss).
25. zoo_parity: each family's flagship with weights from one numpy seed
   through convert.state_from_jax, b 2 eval logits on the card
   in f32 (TF32 off) within ZOO_LOGIT_TOL of the CPU's f64; then one
   MobileNetV3-Large Momentum step held as resnet_parity's.
26. vision_ops: nms over 2,000 boxes of 80 categories (top_k 1,000;
   indices equal to the CPU's exactly), roi_align (sampling ratios 2 and
   -1) and roi_pool over 1,000 RoIs of a [2, 256, 200, 304] map, 7 x 7,
   box_coder's round trip, grid_sample and interpolate (bilinear,
   nearest, bicubic) on [8, 256, 64, 64], each against the CPU within
   TOLERANCES['float32'] with its CUDA-event ms.
27. seq2seq_train: PaddleNLP's attention LSTM seq2seq
   (machine_translation/seq2seq) at IWSLT'15 en-vi widths (S2S: 2-layer
   LSTM encoder and decoder, hidden 512, vocabularies 17,191 / 7,709),
   built from the port's public layers (seq2seq_model), f32, batch 128 x
   50, dropout 0.2 on the embeddings, Adam(0.001) with
   ClipGradByGlobalNorm(5.0) through jit.TrainStep: 2 warm-up and 4
   timed steps (finite losses), target tokens/s, step seconds, peak
   memory, the TF32 flags, one profiled step; in turns, the encoder's
   forward + backward on cuDNN (torch._VF) against the step loop, and
   the decoder's teacher-forced nn.RNN forward + backward with its
   profile (kernel launches, idle share).
28. seq2seq_decode: beam 10 over 128 sources, max_step_num 100, through
   BeamSearchDecoder and dynamic_decode: steps, ms a step, the host's
   share (the profiled decode's idle share), hypotheses' tokens/s.
29. seq2seq_parity: weights from one numpy seed through
   convert.state_from_jax at full width, batch 4: one Adam step
   on the card in f32 (TF32 off) against the CPU in f32 and f64, held
   as resnet_parity holds them; a beam decode in f64 on card and CPU
   whose every step's tokens and parents, ids and lengths are equal; a
   full-width beam step on tied bf16-valued log-probs, tokens, parents
   and finished flags equal.
30. tensor_surface: every function of the tensor slice's modules
   (creation, math, logic, attribute, stat, einsum, search, linalg,
   random, fft, signal, gather_tree) on the card against the CPU, one
   line per module (integers exact, floats within SURFACE_TOL); then
   CUDA-event ms of svd, eigh, qr, solve, inv, det and minimum-norm
   lstsq at [64, 256, 256], eig at [8, 128, 128], stft/istft of
   [32, 160000] (n_fft 512, hop 160, Hann), fft2 of [64, 512, 512]
   complex64, topk/sort/argsort over [4096, 32000] and multinomial over
   [128, 32000].
31. layer_api: a Paddle-style script through the root namespace
   (``import paddle_tpu_torch as paddle``): before any set_device, a
   Layer subclass lands on the card and takes an SGD step; set_device("gpu"),
   get_device, to_tensor on the card; BERT-base's four GEMMs at b 32 x
   128 forward + backward as paddle's F.linear on [in, out] weights
   against torch's on [out, in] copies, in turns (LAYER_GEMMS); BERT-base
   MLM inside a ``paddle.nn.Layer`` subclass re-drawn with
   TruncatedNormal(std=0.02) through ``Layer.apply``, built on the CPU,
   saved, loaded on the card with ``set_state_dict`` (card f32 logits
   against the CPU's), then 4 bf16 AdamW steps of a plain loop with
   ClipGradByGlobalNorm(group_name=...) (the LayerNorm kernels' launches
   asserted; step seconds beside bert_train's, idle share); ResNet-50
   bf16 b 64 with Momentum(0.1, 0.9, weight_decay=L2Decay(1e-4)) against
   the float decay, 4 steps each in turns, bitwise equal; a frozen conv1
   and a half-rate fc by ParamAttr after one f32 step.
32. host_api: the small host modules through the root namespace: a
   ``paddle.autograd.PyLayer`` over the RMSNorm kernels at [8192, 4096]
   bf16 (y, dx, dw bitwise equal to rms_norm's autograd path, forward +
   backward ms of both in turns; jacobian and jvp through it against the
   CPU's plain formula); ``paddle.profiler.Profiler(scheduler=(1, 3))``
   over 4 of layer_api's BERT-base steps with a RecordEvent each (the
   chrome trace's LayerNorm kernels equal the launch counters of steps 1
   and 2; step seconds without a profiler, timer_only and tracing in
   turns); a bf16 8192^3 product on a side ``device.Stream``, bitwise
   equal to the default stream's, and ``device.cuda``'s memory counters;
   ``text.viterbi_decode`` at B 256 x T 128 x 64 tags, card = CPU, ms a
   call and idle share; ``amp.debugging`` (check_numerics, the tensor
   checker naming the op, its cost on one BERT step); ``utils``
   (dlpack shares storage, run_check, a cpp_extension host op); and
   ``tiled_linear`` over paddle's [in, out] weight against an [out, in]
   copy at LLaMA-2-7B's projections, 8 and 1,024 rows, in turns, rows
   bitwise equal across the windows (the layout repair).
33. jit_deploy: BERT-base bf16 at full width, dropout 0, through Paddle's
   deployment flow (parts 1 and 3, which compile with Inductor, at 2 of
   its 12 layers): (1) ``jit.to_static`` eval forward at [32, 128]
   against eager within bert_parity's eval bound, the first call's
   seconds, ms a call in turns, the trace's flash and LayerNorm forward
   records equal to the counters (2 and 6); (2) ``jit.save`` of all 12
   layers with ``InputSpec([None, 128], "int64", "input_ids")``,
   ``jit.load`` and ``inference.create_predictor`` at batches 1, 8 and
   32 within the bound, one ``predictor.run`` profiled (its flash and
   LayerNorm forward records equal to the counters, 12 and 26; no
   library LayerNorm or SDPA kernel); (3) one training step through
   ``to_static`` with eager ``loss.backward()`` against an f32 copy's
   plain step within bert_parity's gradient bound, rows 5, 9 and 10
   launched; (4) ``TrainStep.many(8)`` as one CUDA graph against 8 eager
   steps: after three packs (two replays) every loss, parameter and
   optimizer state bitwise equal to 24 eager steps', replays and eager
   packs in turns (sequences/s, idle share), one replay's and each step
   of one eager pack's profile records of rows 4, 5 and 8-10 equal to the
   counters' rise (a replay's counts are the ones ``TrainStep`` adds for
   it), the
   same models with a ``GradScaler`` under replay (a scale forced to
   +inf skips both steps, a loaded state takes effect; bitwise equal to
   eager), then hidden dropout 0.1: finite losses and masks that differ
   between steps and packs; (5) the dy2static decode
   with a data-dependent early exit saved, loaded and equal to eager on
   both exits.
34. static_graph: ``paddle.static`` on BERT-base bf16 at full width,
   dropout 0, feeds fixed at [32, 128], its MLM loss recorded under
   ``enable_static`` layer by layer: (1) ``AdamW(1e-4).minimize`` and
   4 ``Executor.run`` steps against 4 eager steps of an identical model
   on the same batches, in turns, every loss, parameter and AdamW moment
   bitwise equal; each run's counter rise equal to an eager step's
   (26/26/12/12/12 of rows 4, 5 and 8-10) and to a profiled run's
   records; record, run and eager step seconds and the idle share;
   (2) the test clone's logits through ``save_inference_model`` and
   ``inference.create_predictor`` bitwise equal to ``Executor.run``, one
   ``predictor.run`` profiled (12 flash and 26 LayerNorm forward
   records, no library LayerNorm or SDPA kernel); (3) at 2 of the 12
   layers: ``static.amp.decorate(AdamW, dtype="float16")`` (two runs at
   the largest f32 scale, the loss scaled to +inf, leave parameters and
   moments bitwise unchanged and shrink the scale by ``decr_ratio``;
   then finite runs, a white-listed op's fetched output float16 and the
   loss float32) and recompute with a checkpoint at each layer's output
   bitwise equal to no recompute (losses, gradients, parameters), both
   memory peaks printed.

Every phase prints its wall seconds ({"phase_seconds": name, ...}), and
a "seconds" line sums them.  The last three lines are the card's
nvidia-smi line, the per-kernel JSON summary (the float16 variants as
entries of their own) and {"ok": true, "device": {...}}.  Exits 1
without a CUDA device.

    python3 chip_smoke.py --gn-fwd-sweep [--variants] [--tree DIR]
    python3 chip_smoke.py --ln-fwd-sweep [--variants] [--tree DIR]
    python3 chip_smoke.py --paged-sweep [--tree DIR]
    python3 chip_smoke.py --serve-phases serve_structured,serve_tier
    python3 chip_smoke.py --resnet-phases
    python3 chip_smoke.py --hapi-phases
    python3 chip_smoke.py --fp16-phases
    python3 chip_smoke.py --fused-phases
    python3 chip_smoke.py --zoo-phases
    python3 chip_smoke.py --seq2seq-phases
    python3 chip_smoke.py --layer-phases
    python3 chip_smoke.py --host-phases
    python3 chip_smoke.py --jit-phases
    python3 chip_smoke.py --static-phases

``--serve-phases`` runs the named serve phases alone on the engine
phase's model (no other phase and no kernels line); ``--resnet-phases``
likewise runs phases 14-16 alone and ``--hapi-phases`` phases 17 and
21 (the kernels built for hapi_fit_bert); ``--fp16-phases`` the float16
checks of phase 2 that need no plain twin at full size (the backward's
determinism, row invariance, the raises) and phases 18-20;
``--fused-phases`` the three phases of 22; ``--zoo-phases`` the four
phases of 23-26 and ``--seq2seq-phases`` the four of 27-30 (no kernel
built: none lies on their path); ``--layer-phases`` bert_train and 31
(the kernels built); ``--host-phases`` 32 alone, ``--jit-phases``
33 alone and ``--static-phases`` 34 alone (the kernels built).
The sweeps run the GroupNorm or
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
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float16": 989e12,
                  "float32": 67e12}                     # dense, no TF32

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
# fused_decode's prefill (GPT-3 6.7B widths, b 8 x 512): the flash forward
# at [8, 512, 32, 128] causal and the LayerNorm over its 4096 rows of 4096
FUSED_FLASH_CASE = ("gpt3_6p7b/b8_s512/causal", 32, 32, 512, 512, True,
                    "bfloat16", 8, 128)
FUSED_LN_ROWS = (8 * 512, 4096)
# ResNet-50 as bench_resnet50 (benchmarks/bench_models.py:116-152): bf16,
# Momentum(lr, 0.9), cross-entropy on f32 logits, b64 at 3 x 224 x 224.
# The learning rate is bench_resnet50's 0.1 scaled to the batch by the
# linear rule of Goyal et al. 2017 (0.1 a 256 images): at 0.1, b64 and no
# warm-up the loss of the first steps swings and rose over the timed steps
# on the card (PERF.md, PR 15); the rate leaves a step's work unchanged
RESNET_BATCH, RESNET_PX, RESNET_CLASSES = 64, 224, 1000
RESNET_WARMUP, RESNET_TIMED = 2, 4
RESNET_LR, RESNET_MOMENTUM = 0.1 * RESNET_BATCH / 256, 0.9
RESNET_PARITY_BATCH = 4
# each bottleneck's bn3.weight in resnet_parity's weights: at 1 (JAX's
# init) a ResNet-50 training step is ill conditioned in f32 (gradients 2 %
# apart norm-wise between f32 and f64 of one implementation), at 0.25 it
# is not (2e-5); see tests/test_torch_resnet.py
RESNET_BRANCH_SCALE = 0.25
# hapi_fit: ResNet-50 through Model.fit from FakeData (ImageNet's shape)
# through the threaded DataLoader; hapi_fit_bert: BERT-base MLM at
# bert_train_flash's config through Model.fit over a TensorDataset
HAPI_TRAIN, HAPI_EVAL, HAPI_WORKERS, HAPI_WARM = 512, 128, 4, 2
IMAGENET_MEAN, IMAGENET_STD = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
HAPI_WIRING_STEPS = 3
HAPI_BERT_STEPS = 8


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
    the int8 one with per-token scales), the float16 pool under a
    float16 query (the same kernel in float16) and the f32 pool (the FMA
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
                         ("int8", True), ("float16", False)):
        dtype = getattr(torch, pname) if not quant else torch.bfloat16
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
                                                 "int8", "float16"],
          "checks": report})


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
    variants = [("bfloat16", False), ("float32", False), ("bfloat16", True),
                ("float16", False), ("float16", True)]
    # float16: its pool at decode, s = 5 and the engine's prefill; an
    # int8 pool under a float16 query at decode
    fp16_windows = {(False, "decode"), (False, "verify5"),
                    (False, "prefill8x1024"), (True, "decode")}
    for lname, qh, kh in layouts:
        for wname, s, pos_list in windows:
            for dname, quant in variants:
                if (wname == "prefill8x1024" or wname == "verify5") and (
                        dname == "float32"):
                    continue
                if dname == "float16" and (quant, wname) not in fp16_windows:
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
                if (lname, wname) == ("llama2_7b", "decode") and \
                        dname != "float32":
                    summary[("paged_attention_int8" if quant
                             else "paged_attention")
                            + ("/float16" if dname == "float16" else "")] = \
                        case
                del q, k, v, tables, pos, ks, vs
    return seed


def kernel_phase(torch, dev, phase):
    """Every kernel case and check of phase 2, each step timed through
    ``phase(name, fn, *args)``; returns the summary cases by kernel."""
    summary = {}
    seed = phase("paged_cases", paged_cases, torch, dev, summary, 0)
    phase("paged_invariance", paged_invariance_check, torch, dev)
    seed = phase("rms_norm_cases", rms_fwd_cases, torch, dev, summary, seed)
    seed = phase("rms_norm_bwd_cases", rms_bwd_cases, torch, dev, summary,
                 seed)
    seed = phase("flash_cases", flash_cases, torch, dev, summary, seed)
    seed = phase("flash_bwd_determinism", flash_bwd_determinism_check,
                 torch, dev, seed)
    seed = phase("norm_cases", norm_cases, torch, dev, summary, seed)
    seed = phase("ln_fwd_dtypes", ln_fwd_dtype_check, torch, dev, seed)
    seed = phase("norm_bwd_determinism", norm_bwd_determinism_check, torch,
                 dev, seed)
    seed = phase("gn_fwd_sweep", gn_fwd_sweep, torch, dev, seed)
    seed = phase("ln_fwd_sweep", ln_fwd_sweep, torch, dev, seed)
    phase("rms_autograd", rms_autograd_check, torch, dev, seed)
    phase("unsupported_raises", unsupported_check, torch, dev)
    return summary


def rms_fwd_cases(torch, dev, summary, seed):
    """The RMSNorm forward kernel against its plain twin, timed beside
    its bound and F.rms_norm."""
    from paddle_tpu_torch.ops.rms_norm import rms_norm, rms_norm_plain

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
    return seed


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
              "bfloat16"),
             ("llama2_7b/s4096/causal", 32, 32, 4096, 4096, True, "float16"),
             ("llama3_8b_gqa/s4096/causal", 32, 8, 4096, 4096, True,
              "float16")]
    cases = [c + (b, d) for c in cases] + unet_flash_shapes() + \
        bert_flash_shapes() + [FUSED_FLASH_CASE]
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
        ns = dkv_splits(b, sq, sk, kh, d) if dname != "float32" else 1
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
            tag = "" if dname != "float16" else "/float16"
            if cname == "llama2_7b/s4096/causal" and dname != "float32":
                summary[kname + tag] = case
            if cname == BERT_FLASH_CASE and dname != "float32":
                summary["bert/" + kname + tag] = case
            if cname == FUSED_FLASH_CASE[0]:
                summary["fused/" + kname] = case
        del out_p, dq_p, dk_p, dv_p
    return seed


def flash_bwd_determinism_check(torch, dev, seed):
    """The bf16 and float16 backward kernels give bitwise equal dQ, dK
    and dV over two calls on the same inputs: at the LM shape (one query
    range) and at the UNet's level-0 cross-attention (dkv_splits > 1:
    f32 partials summed in index order by the second kernel)."""
    from paddle_tpu_torch.ops.flash_attention import (
        dkv_splits, flash_bwd_dkv_kernel, flash_bwd_dq_kernel,
        flash_fwd_plain,
    )

    report = {}
    for (cname, b, qh, kh, sq, sk, d, causal), dname in itertools.product((
            ("llama2_7b/s4096/causal", TRAIN_BATCH, 32, 32, 4096, 4096, 128,
             True),
            ("unet_level0_d40/cross", UNET_BATCH, 8, 8, 4096, UNET_CONTEXT,
             40, False)), ("bfloat16", "float16")):
        g = torch.Generator(device="cpu").manual_seed(seed)
        seed += 1
        q, k, v, do = (torch.randn(b, s, h, d, generator=g).to(
            getattr(torch, dname)).to(dev) for s, h in ((sq, qh), (sk, kh),
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
                raise AssertionError(f"flash_bwd_determinism {cname}/"
                                     f"{dname}/{n}: "
                                     f"{(a != c).sum().item()} elements "
                                     f"differ between two calls (NS {ns})")
        report[f"{cname}/{dname}"] = {"dkv_splits": ns,
                                      "dq_dk_dv": "bitwise equal"}
        del q, k, v, do, out, lse, delta, runs
    if min(r["dkv_splits"] for r in report.values()) != 1 or \
            max(r["dkv_splits"] for r in report.values()) <= 1:
        raise AssertionError(f"flash_bwd_determinism: want NS = 1 and NS > 1 "
                             f"{report}")
    emit({"phase": "flash_bwd_determinism",
          "dtypes": ["bfloat16", "float16"], "checks": report})
    return seed


def unet_flash_shapes():
    """The SD UNet's attention calls at UNET_BATCH and 64x64 latents, 8
    heads, not causal: self-attention over the level's HW tokens and
    cross-attention over the context's 77, at head dims 320/8 = 40,
    80 and 160 (40 runs padded to the kernel's 48); and level 1's
    self-attention (D 80) in float16."""
    out = []
    for level, d, hw in (("level0", 40, 4096), ("level1", 80, 1024),
                         ("level2", 160, 256), ("mid", 160, 64)):
        for kind, sk in (("self", hw), ("cross", UNET_CONTEXT)):
            out.append((f"unet_{level}_d{d}/{kind}", 8, 8, hw, sk, False,
                        "bfloat16", UNET_BATCH, d))
    out.append(("unet_level1_d80/self", 8, 8, 1024, 1024, False, "float16",
                UNET_BATCH, 80))
    return out


def bert_flash_shapes():
    """BERT-base's attention calls (12 heads of 64, not causal) at the
    bert_train batch: s = 128 in bf16, f32 and float16 (bert_amp's), and
    s = 512 (the bert_parity eval length) in bf16 and float16."""
    return [(f"bert_base/s{s}/full", 12, 12, s, s, False, dname,
             BERT_BATCH, 64)
            for s, dname in ((BERT_SEQ, "bfloat16"), (BERT_SEQ, "float32"),
                             (BERT_SEQ, "float16"), (512, "bfloat16"),
                             (512, "float16"))]


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
          ((4096, 100), "bfloat16", None),
          (FUSED_LN_ROWS, "bfloat16", None)]
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
                if (dname, shape) == ("bfloat16", FUSED_LN_ROWS):
                    summary["fused/" + kname] = case    # fused_decode's
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
        "sdpa/float16_head_dim_192": lambda: F.scaled_dot_product_attention(
            *(rand(1, 8, 2, 192, dtype=torch.float16) for _ in range(3))),
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
# the serving phases after the engine phase run LLaMA-2-7B's widths at
# this depth (the engine phase keeps all 32 layers): every check holds
# per layer, and the script keeps inside its time limit
SERVE_LAYERS = 8
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


def serve_model(torch, dev):
    """The model of the serving phases after the engine phase: LLaMA-2-7B
    widths at SERVE_LAYERS layers, bf16, the engine phase's seed."""
    from paddle_tpu_torch.models.llama import LLAMA2_7B, LlamaForCausalLM

    cfg = dataclasses.replace(LLAMA2_7B, num_hidden_layers=SERVE_LAYERS)
    return LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=0)


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


def profiled(torch, run, classify=None):
    """``run()`` under torch.profiler: the device's busy share of the
    wall time (union of kernel intervals) and the kernel time by name.
    The profiler slows the host, so the idle share is an upper bound of
    the unprofiled run's.  ``classify(kernels, events)``, if given,
    returns more fields from the kernel events and all events."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return profile_figures(prof, wall_us, classify)


def profile_figures(prof, wall_us, classify=None):
    """:func:`profiled`'s figures from a finished profile and the wall
    time it covered."""
    from torch.autograd import DeviceType

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
    out = {"wall_ms": wall_us / 1e3,
           "device_busy_ms": busy / 1e3 if kernels else "not measured",
           "device_idle_share": 1 - busy / wall_us if kernels
           else "not measured",
           "kernel_events": len(kernels),
           "device_ms_by_kind": by_kind,
           "top_kernels_ms": [[n[:80], t / 1e3] for n, t in top]}
    if classify is not None:
        out.update(classify(kernels, events))
    return out


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
    from paddle_tpu_torch.models.unet import CrossAttention
    from paddle_tpu_torch.nn import Conv2D, Linear

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
        fn = (conv if isinstance(m, Conv2D) else
              linear if isinstance(m, Linear) else
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

    saved = F._layer_norm_op, F._group_norm_op, F._flash_op
    F._layer_norm_op, F._group_norm_op, F._flash_op = (
        layer_norm_plain, group_norm_plain, flash_attention_plain)
    try:
        yield
    finally:
        F._layer_norm_op, F._group_norm_op, F._flash_op = saved


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
    tensors: the LayerNorm pair, and attention through the flash custom
    op's registered backward with the plain twins in place of the three
    kernels, the kernels' own recompute form (``delta`` from the bf16
    output, as the JAX kernel's ``paddle_tpu/ops/pallas/flash.py:251-253``)."""
    import importlib

    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.layer_norm import layer_norm_plain

    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    saved = (fa.flash_fwd_kernel, fa.flash_bwd_dq_kernel,
             fa.flash_bwd_dkv_kernel, F._layer_norm_op)

    def fwd(q, k, v, scale, causal=False):
        return fa._contiguous(fa.flash_fwd_plain(q, k, v, scale, causal))

    def dq(q, k, v, dout, lse, delta, scale, causal=False):
        return fa._bwd_plain(q, k, v, dout, lse, delta, scale,
                             causal)[0].contiguous()

    def dkv(q, k, v, dout, lse, delta, scale, causal=False):
        return fa._contiguous(fa._bwd_plain(q, k, v, dout, lse, delta,
                                            scale, causal)[1:])

    fa.flash_fwd_kernel, fa.flash_bwd_dq_kernel = fwd, dq
    fa.flash_bwd_dkv_kernel = dkv
    F._layer_norm_op = layer_norm_plain
    try:
        yield
    finally:
        (fa.flash_fwd_kernel, fa.flash_bwd_dq_kernel,
         fa.flash_bwd_dkv_kernel, F._layer_norm_op) = saved


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


# ---------------------------------------------------------- phases 14-16
def resnet_batch(torch, b, seed, dev, dtype):
    """bench_resnet50's batch: numpy-seeded N(0, 1) images [b, 3, 224,
    224] in ``dtype`` and int64 labels in [0, 1000), on ``dev``."""
    import numpy as np

    rng = np.random.RandomState(seed)
    x = rng.randn(b, 3, RESNET_PX, RESNET_PX).astype(np.float32)
    y = rng.randint(0, RESNET_CLASSES, (b,)).astype(np.int64)
    return (torch.from_numpy(x).to(dev, dtype), torch.from_numpy(y).to(dev))


def resnet_loss(net, x, y):
    """bench_resnet50's loss: cross-entropy on the f32 logits."""
    from paddle_tpu_torch.nn import functional as F

    return F.cross_entropy(net(x).float(), y)


def resnet_amp_loss(net, x, y):
    """The forward and the loss under ``amp.auto_cast`` O1 float16."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import functional as F

    with amp.auto_cast(level="O1", dtype="float16"):
        return F.cross_entropy(net(x), y)


@contextlib.contextmanager
def backend_flags(torch, **flags):
    """``torch.backends`` flags inside the block, restored after:
    ``benchmark`` and ``deterministic`` (cuDNN), ``tf32`` (cuDNN's
    convolutions and cuBLAS's matmuls).  Yields all four as set."""
    b = torch.backends
    saved = (b.cudnn.benchmark, b.cudnn.deterministic, b.cudnn.allow_tf32,
             b.cuda.matmul.allow_tf32)
    if "benchmark" in flags:
        b.cudnn.benchmark = flags["benchmark"]
    if "deterministic" in flags:
        b.cudnn.deterministic = flags["deterministic"]
    if "tf32" in flags:
        b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = flags["tf32"]
    try:
        yield {"cudnn.benchmark": b.cudnn.benchmark,
               "cudnn.deterministic": b.cudnn.deterministic,
               "cudnn.allow_tf32": b.cudnn.allow_tf32,
               "cuda.matmul.allow_tf32": b.cuda.matmul.allow_tf32}
    finally:
        (b.cudnn.benchmark, b.cudnn.deterministic, b.cudnn.allow_tf32,
         b.cuda.matmul.allow_tf32) = saved


def resnet_forward_flops(torch, model, x):
    """Model FLOPs of one forward, by hooks on every Conv2D (2 Cin/groups
    k^2 an output element) and Linear (2 in an output element), over an
    eval forward (which leaves the running buffers alone)."""
    from paddle_tpu_torch.nn import Conv2D, Linear

    total = [0]

    def count(m, inp, out):
        per = m.weight[0].numel() if isinstance(m, Conv2D) else \
            m.weight.shape[0]
        total[0] += 2 * per * out.numel()

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (Conv2D, Linear))]
    was = model.training
    model.eval()
    try:
        with torch.no_grad():
            model(x)
    finally:
        model.train(was)
        for h in hooks:
            h.remove()
    return total[0]


def batch_norm_alone_ms(torch, model, x):
    """Device ms of every BatchNorm forward and backward of one training
    step, run alone: the shapes from hooks on an eval forward, then each
    call of the step as the training-mode ``F.batch_norm`` forward and
    backward on random tensors of the model's dtype, once to warm up and
    once under torch.profiler, whose kernel durations are summed (the
    profiler can drop a kernel event, so this is a lower bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.nn import BatchNorm2D
    from paddle_tpu_torch.nn import functional as F

    calls = []

    def record(m, inp, out):
        calls.append((tuple(inp[0].shape), inp[0].dtype))

    hooks = [m.register_forward_hook(record) for m in model.modules()
             if isinstance(m, BatchNorm2D)]
    model.eval()
    try:
        with torch.no_grad():
            model(x)
    finally:
        model.train()
        for h in hooks:
            h.remove()
    inputs = {}
    for shape, dtype in set(calls):
        kw = dict(device=x.device, dtype=dtype)
        c = shape[1]
        inputs[shape, dtype] = (
            torch.randn(shape, **kw).requires_grad_(),
            torch.ones(c, **kw).requires_grad_(),
            torch.zeros(c, **kw).requires_grad_(), torch.zeros(c, **kw),
            torch.ones(c, **kw), torch.randn(shape, **kw))

    def step():
        for key in calls:
            a, w, b, rm, rv, cot = inputs[key]
            out = F.batch_norm(a, rm, rv, w, b, training=True)
            torch.autograd.backward(out, cot, inputs=[a, w, b])

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return "not measured", len(calls)
    return sum(e.time_range.elapsed_us() for e in kernels) / 1e3, len(calls)


#: kernel kinds of a ResNet step, by name (the first kind whose keys
#: match); Momentum's loop is told apart by the time window of its
#: ``record_function`` range on the device
RESNET_KERNEL_KINDS = (
    ("convolution (cuDNN)", ("fprop", "dgrad", "wgrad", "conv", "implicit",
                             "nchw", "nhwc", "cudnn")),
    ("gemm (cuBLAS)", ("gemm", "nvjet", "cublas")),
    ("pooling", ("pool",)),
    ("reduction (BatchNorm statistics and their backward)",
     ("reduce_kernel",)),
    ("elementwise (BatchNorm passes, ReLU, adds, casts)",
     ("elementwise", "unrolled", "copy", "fill")),
)
RESNET_OPTIMIZER_SPAN = "resnet.optimizer"


def resnet_classify(kernels, events):
    """Device ms of a ResNet step's kernels by kind (see
    RESNET_KERNEL_KINDS): those inside the device-side span of the
    optimizer's step are Momentum's loop, whatever their names."""
    from torch.autograd import DeviceType

    windows = [(e.time_range.start, e.time_range.end) for e in events
               if e.name == RESNET_OPTIMIZER_SPAN
               and e.device_type == DeviceType.CUDA]
    kinds, launches = {}, {}
    for e in kernels:
        t0 = e.time_range.start
        if any(a <= t0 <= b for a, b in windows):
            kind = "optimizer (Momentum's loop)"
        else:
            low = e.name.lower()
            kind = next((k for k, keys in RESNET_KERNEL_KINDS
                         if any(key in low for key in keys)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + e.time_range.elapsed_us() / 1e3
        launches[kind] = launches.get(kind, 0) + 1
    return {"device_ms_by_resnet_kind": kinds,
            "kernel_launches_by_resnet_kind": launches,
            "optimizer_span_on_device": bool(windows)}


def resnet_profile(torch, step, opt, batch):
    """One step under torch.profiler, Momentum's ``step`` inside a
    ``record_function`` span (resnet_classify)."""
    plain_step = opt.step

    def spanned(*a, **kw):
        with torch.profiler.record_function(RESNET_OPTIMIZER_SPAN):
            return plain_step(*a, **kw)

    opt.step = spanned
    try:
        return profiled(torch, lambda: step(*batch).item(),
                        classify=resnet_classify)
    finally:
        del opt.step


def resnet_train_phase(torch, dev):
    """ResNet-50 training as bench_resnet50 (see the module docstring):
    2 warm-up and 4 timed steps, the loss falling over them, every
    BatchNorm buffer moved and finite, an eval pass whose top-1/top-5
    Accuracy equals a direct topk count; images/s, FLOP share, peak
    memory, one profiled step by kernel kind and BatchNorm's device time
    alone.  Returns the port kernels' launches (none lies on this path)
    and the figures resnet_amp compares with."""
    from paddle_tpu_torch import metric
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = resnet50(num_classes=RESNET_CLASSES, device=dev, seed=0).to(
        torch.bfloat16)
    model.train()
    opt = Momentum(learning_rate=RESNET_LR, momentum=RESNET_MOMENTUM,
                   parameters=model.named_parameters(), device=dev)
    step = TrainStep(model, resnet_loss, opt, device=dev)
    batch = resnet_batch(torch, RESNET_BATCH, 0, dev, torch.bfloat16)
    flops = 3 * resnet_forward_flops(torch, model, batch[0])
    buffers0 = {n: b.clone() for n, b in model.named_buffers()}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    with backend_flags(torch, benchmark=True) as flags:
        losses = [step(*batch).item() for _ in range(RESNET_WARMUP)]
        step_s = []
        reset_kernel_launches()
        for _ in range(RESNET_TIMED):
            t1 = time.perf_counter()
            losses.append(step(*batch).item())    # .item() synchronises
            step_s.append(time.perf_counter() - t1)
        launches = kernel_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        prof = resnet_profile(torch, step, opt, batch)
        bn_ms, bn_calls = batch_norm_alone_ms(torch, model, batch[0])
    if any(launches.values()):
        raise AssertionError(f"resnet_train: a port kernel ran on a path "
                             f"that reaches none {launches}")
    timed = losses[RESNET_WARMUP:]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"resnet_train: non-finite loss {losses}")
    if not timed[-1] < timed[0]:
        raise AssertionError(f"resnet_train: loss did not fall {timed}")
    for n, b in model.named_buffers():
        if torch.equal(b, buffers0[n]) or not torch.isfinite(b).all():
            raise AssertionError(f"resnet_train: buffer {n} did not move "
                                 "or is not finite")
    model.eval()
    with torch.no_grad():
        logits = model(batch[0]).float()
    if not torch.isfinite(logits).all():
        raise AssertionError("resnet_train: non-finite eval logits")
    acc = metric.Accuracy(topk=(1, 5))
    acc.update(acc.compute(logits, batch[1]))
    top5 = logits.topk(5, dim=-1).indices
    direct = [(top5[:, :k] == batch[1][:, None]).any(-1).sum().item()
              / RESNET_BATCH for k in (1, 5)]
    if acc.accumulate() != direct:
        raise AssertionError(f"resnet_train: Accuracy {acc.accumulate()} "
                             f"vs topk count {direct}")
    mean_s = sum(step_s) / len(step_s)
    busy = prof["device_busy_ms"]
    figures = {"images_per_s": RESNET_BATCH / mean_s, "step_s_mean": mean_s}
    emit({"phase": "resnet_train", "model": "resnet50(num_classes=1000)",
          "dtype": "bfloat16", "batch": RESNET_BATCH,
          "image": [3, RESNET_PX, RESNET_PX], "optimizer":
          f"Momentum({RESNET_LR}, {RESNET_MOMENTUM})", "backend_flags": flags,
          "params": sum(p.numel() for p in model.parameters()),
          "setup_s": setup_s, "losses": losses, "step_s": step_s,
          "step_s_mean": mean_s, "step_s_range": [min(step_s), max(step_s)],
          "images_per_s": figures["images_per_s"],
          "model_flops_per_step": flops,
          "model_flops_formula": "3 x forward: conv 2 Cin/groups k^2 an "
                                 "output element, linear 2 in an output "
                                 "element",
          "model_flops_per_image": flops / RESNET_BATCH,
          "model_tflops_per_s": flops / mean_s / 1e12,
          "mfu_of_989": flops / mean_s / 989e12,
          "peak_memory_gb": peak_gb, "kernel_launches": launches,
          "eval_accuracy_top1_top5": acc.accumulate(),
          "batch_norm_alone_device_ms_per_step": bn_ms,
          "batch_norm_calls_per_step": bn_calls,
          "batch_norm_share_of_device_busy": (
              bn_ms / busy if isinstance(busy, float)
              and isinstance(bn_ms, float) else "not measured")})
    emit(dict(prof, phase="resnet_train_profile", steps=1))
    del step, opt, model, batch, logits
    gc.collect()
    torch.cuda.empty_cache()
    return launches, figures


def resnet_amp_phase(torch, dev, bf16_figures):
    """The same ResNet-50 in f32 under amp.auto_cast O1 float16, with a
    GradScaler through TrainStep(scaler=): 2 warm-up and 4 timed steps
    beside resnet_train's bf16; a dtype census of one forward (conv and
    Linear outputs float16, BatchNorm and the loss float32, as JAX's
    lists); then one step forced to overflow (the scale set to 2**40):
    the parameters and the Momentum velocities bit for bit unchanged over
    it, the BatchNorm buffers moved, the scale halved; then steps until
    one does not overflow (each bad step halves the scale), and two more
    that train."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import BatchNorm2D, Conv2D, Linear
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = resnet50(num_classes=RESNET_CLASSES, device=dev, seed=0)
    model.train()
    opt = Momentum(learning_rate=RESNET_LR, momentum=RESNET_MOMENTUM,
                   parameters=model.named_parameters(), device=dev)
    scaler = amp.GradScaler(device=dev)
    step = TrainStep(model, resnet_amp_loss, opt, scaler=scaler, device=dev)
    batch = resnet_batch(torch, RESNET_BATCH, 0, dev, torch.float32)
    census = {}

    def record(m, inp, out):
        census.setdefault(type(m).__name__, set()).add(str(out.dtype))

    hooks = [m.register_forward_hook(record) for m in model.modules()
             if isinstance(m, (Conv2D, Linear, BatchNorm2D))]
    model.eval()
    with torch.no_grad():
        loss = resnet_amp_loss(model, *batch)
    model.train()
    for h in hooks:
        h.remove()
    census = {k: sorted(v) for k, v in census.items()}
    census["cross_entropy"] = [str(loss.dtype)]
    want = {"Conv2D": ["torch.float16"], "Linear": ["torch.float16"],
            "BatchNorm2D": ["torch.float32"],
            "cross_entropy": ["torch.float32"]}
    if census != want:
        raise AssertionError(f"resnet_amp: dtype census {census}, want "
                             f"{want}")
    scales = [scaler.get_loss_scaling().item()]
    with backend_flags(torch, benchmark=True) as flags:
        losses = []
        for _ in range(RESNET_WARMUP):
            losses.append(step(*batch).item())
            scales.append(scaler.get_loss_scaling().item())
        step_s = []
        for _ in range(RESNET_TIMED):
            t1 = time.perf_counter()
            losses.append(step(*batch).item())    # .item() synchronises
            step_s.append(time.perf_counter() - t1)
            scales.append(scaler.get_loss_scaling().item())
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # one step forced to overflow: fp16 gradients times 2**40
        scaler.set_init_loss_scaling(2.0 ** 40)
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        velocity = {k: v.clone() for k, v in opt.state_dict().items()
                    if k.endswith("velocity")}
        buffers = {n: b.clone() for n, b in model.named_buffers()}
        forced_loss = step(*batch).item()
        forced_scale = scaler.get_loss_scaling().item()
        if forced_scale != 2.0 ** 39:
            raise AssertionError(f"resnet_amp: scale {forced_scale} after "
                                 "the forced overflow, want 2**39")
        for n, p in model.named_parameters():
            if not torch.equal(p, params[n]):
                raise AssertionError(f"resnet_amp: {n} moved over the "
                                     "overflowing step")
        for k, v in opt.state_dict().items():
            if k in velocity and not torch.equal(v, velocity[k]):
                raise AssertionError(f"resnet_amp: {k} moved over the "
                                     "overflowing step")
        if not any(not torch.equal(b, buffers[n])
                   for n, b in model.named_buffers()):
            raise AssertionError("resnet_amp: no BatchNorm buffer moved "
                                 "over the overflowing step")
        recovery = [forced_scale]
        while True:
            before = scaler.get_loss_scaling().item()
            step(*batch).item()
            recovery.append(scaler.get_loss_scaling().item())
            if recovery[-1] >= before or len(recovery) > 40:
                break
        if recovery[-1] < recovery[-2]:
            raise AssertionError(f"resnet_amp: still overflowing at scale "
                                 f"{recovery[-1]}")
        trained = []
        for _ in range(2):
            before = {n: p.detach().clone()
                      for n, p in model.named_parameters()}
            trained.append(step(*batch).item())
            moved = sum(not torch.equal(p, before[n])
                        for n, p in model.named_parameters())
            if moved == 0:
                raise AssertionError("resnet_amp: a step after the "
                                     "recovery did not train")
    if not all(math.isfinite(v) for v in losses + trained):
        raise AssertionError(f"resnet_amp: non-finite loss {losses}")
    mean_s = sum(step_s) / len(step_s)
    emit({"phase": "resnet_amp", "model": "resnet50(num_classes=1000), "
          "float32 parameters", "auto_cast": "O1 float16",
          "scaler": "GradScaler() through TrainStep(scaler=)",
          "backend_flags": flags, "batch": RESNET_BATCH, "losses": losses,
          "step_s": step_s, "step_s_mean": mean_s,
          "images_per_s": RESNET_BATCH / mean_s,
          "bf16_images_per_s": bf16_figures["images_per_s"],
          "amp_over_bf16_images_per_s": (RESNET_BATCH / mean_s)
          / bf16_figures["images_per_s"],
          "peak_memory_gb": peak_gb, "dtype_census": census,
          "scale_path": scales, "forced_overflow": {
              "scale_set": 2.0 ** 40, "loss": forced_loss,
              "scale_after": forced_scale,
              "scale_until_a_step_fits": recovery,
              "losses_after": trained}})
    del step, opt, model, batch, scaler
    gc.collect()
    torch.cuda.empty_cache()


def resnet_numpy_state(model, seed):
    """A ``state_dict`` of the keys and shapes of ``model`` (the port's
    ResNet-50, whose layout is the JAX model's: ``fc.weight`` [in, out])
    from one numpy seed, with JAX's
    initial distributions: convolutions U(-1/sqrt(fan_in),
    1/sqrt(fan_in)), the fc Xavier-normal, BatchNorm weight 1 (each
    bottleneck's bn3 RESNET_BRANCH_SCALE) and bias 0, running mean 0 and
    variance 1."""
    import numpy as np

    rng = np.random.RandomState(seed)
    state = {}
    for key, t in model.state_dict().items():
        shape = tuple(t.shape)
        if key == "fc.weight":
            fan_in, fan_out = shape
            a = rng.randn(fan_in, fan_out) * math.sqrt(2.0 / (fan_in
                                                              + fan_out))
        elif len(shape) == 4:
            bound = 1.0 / math.sqrt(math.prod(shape[1:]))
            a = rng.uniform(-bound, bound, shape)
        elif key.endswith(("_variance", ".weight")):
            scale = RESNET_BRANCH_SCALE if key.endswith("bn3.weight") else 1
            a = np.full(shape, scale)
        else:
            a = np.zeros(shape)
        state[key] = a.astype(np.float32)
    return state


def resnet_parity_phase(torch, dev):
    """ResNet-50 at full width, b4 x 224 px, weights from one numpy seed
    through convert.state_from_jax (resnet_numpy_state), one
    TrainStep with Momentum on each of: the card in f32, the CPU in f32
    and in f64 (the truth), with TF32 off; the card in bf16 and the CPU
    in bf16.  The logits, the loss, every gradient, every parameter and
    both running buffers after the step: the card's f32 error within
    GRAD_PARITY_FACTOR of the CPU f32's plus GRAD_PARITY_FLOOR
    (grad_parity's rule, norm-wise), and likewise the card's bf16 error
    against the CPU's bf16.  Then the same seed's bf16 step twice on the
    card with cuDNN's deterministic algorithms: every tensor bit for
    bit."""
    from paddle_tpu_torch.convert import state_from_jax
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50

    state = resnet_numpy_state(resnet50(num_classes=RESNET_CLASSES,
                                        device=dev), 1234)
    x32, y = resnet_batch(torch, RESNET_PARITY_BATCH, 7, "cpu",
                          torch.float32)

    def run(where, dtype):
        """One TrainStep: {tensor name: f32 CPU copy} of the logits, the
        loss, the gradients (captured as they land), the parameters and
        buffers after the update."""
        model = resnet50(num_classes=RESNET_CLASSES, device=where,
                         dtype=dtype)
        model.load_state_dict(state_from_jax(state, model, device=where,
                                             dtype=dtype))
        model.train()
        opt = Momentum(learning_rate=RESNET_LR, momentum=RESNET_MOMENTUM,
                       parameters=model.named_parameters(), device=where)
        grads = {}
        for n, p in model.named_parameters():
            p.register_post_accumulate_grad_hook(
                lambda p, n=n: grads.__setitem__(n, p.grad.detach().clone()))

        def loss_aux(net, x, lbl):
            logits = net(x).float()
            return F.cross_entropy(logits, lbl), logits

        step = TrainStep(model, loss_aux, opt, has_aux=True, device=where)
        loss, logits = step(x32.to(where, dtype), y.to(where))
        out = {"loss": loss, "logits": logits}
        out.update({"grad." + n: g for n, g in grads.items()})
        out.update(model.state_dict())
        return {k: v.detach().to("cpu", torch.float64)
                for k, v in out.items()}

    with backend_flags(torch, tf32=False, benchmark=False) as flags:
        truth = run("cpu", torch.float64)
        cpu32 = run("cpu", torch.float32)
        card32 = run(dev, torch.float32)
        cpu16 = run("cpu", torch.bfloat16)
        card16 = run(dev, torch.bfloat16)

    def errors(got):
        return {k: ((got[k] - ref).norm() / max(ref.norm().item(), 1e-30)
                    ).item() for k, ref in truth.items()}

    e_card32, e_cpu32 = errors(card32), errors(cpu32)
    e_card16, e_cpu16 = errors(card16), errors(cpu16)
    failed = []
    for name, card, cpu in (("f32", e_card32, e_cpu32),
                            ("bf16", e_card16, e_cpu16)):
        for k in truth:
            tol = GRAD_PARITY_FACTOR * cpu[k] + GRAD_PARITY_FLOOR
            if not (math.isfinite(card[k]) and card[k] <= tol):
                failed.append(f"{name} {k}: card {card[k]:.3e} > "
                              f"{tol:.3e} (CPU {cpu[k]:.3e})")
    if failed:
        raise AssertionError(f"resnet_parity: {len(failed)} tensors out of "
                             f"tolerance: {failed[:12]}")
    # the same seed's bf16 step twice on the card, bit for bit
    with backend_flags(torch, deterministic=True, benchmark=False) as det:
        first, second = run(dev, torch.bfloat16), run(dev, torch.bfloat16)
    differ = [k for k in first if not torch.equal(first[k], second[k])]
    if differ:
        raise AssertionError(f"resnet_parity: the same seed's bf16 step "
                             f"differs in {len(differ)} tensors "
                             f"{differ[:8]}")
    grads = [k for k in truth if k.startswith("grad.")]
    top = sorted(grads, key=lambda k: -e_card16[k])[:8]
    emit({"phase": "resnet_parity", "model": "resnet50(num_classes=1000)",
          "batch": RESNET_PARITY_BATCH, "image": [3, RESNET_PX, RESNET_PX],
          "bn3_weight": RESNET_BRANCH_SCALE, "backend_flags": flags,
          "deterministic_flags": det, "tensors_checked": len(truth),
          "rule": f"card err <= {GRAD_PARITY_FACTOR} x CPU err + "
                  f"{GRAD_PARITY_FLOOR}, norm-wise against the CPU f64",
          "loss": {"f64": truth["loss"].item(), "card_f32":
                   card32["loss"].item(), "card_bf16":
                   card16["loss"].item()},
          "worst_f32": max(e_card32.items(), key=lambda kv: kv[1]),
          "worst_cpu_f32": max(e_cpu32.items(), key=lambda kv: kv[1]),
          "logits_err": {"card_f32": e_card32["logits"],
                         "cpu_f32": e_cpu32["logits"],
                         "card_bf16": e_card16["logits"],
                         "cpu_bf16": e_cpu16["logits"]},
          "grad_rel_err_bf16_card_vs_cpu": {
              k[5:]: [e_card16[k], e_cpu16[k]] for k in top},
          "grad_rel_err_bf16_median": [
              statistics.median(e_card16[k] for k in grads),
              statistics.median(e_cpu16[k] for k in grads)],
          "same_seed_bitwise": True})


# ---------------------------------------------------------- phases 17-18
def step_clock(torch, profile_step=None, stall=None):
    """A ``Model.fit`` callback: the host clock at the end of each train
    batch (the loader's wait, the copy to the card and the step lie
    between two of them); with ``stall`` (the loader's
    ``dataloader.stall_seconds`` histogram) each batch's stall; and with
    ``profile_step`` that batch under torch.profiler, from the end of the
    batch before it to its own end (:func:`profile_figures` in
    ``.profile``)."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.hapi.callbacks import Callback

    class StepClock(Callback):
        def __init__(self):
            super().__init__()
            self.ends = []
            self.stalls = []
            self.profile = None
            self._prof = None
            self._t0 = None
            self._stall_sum = 0.0

        def on_train_batch_begin(self, step, logs=None):
            if stall is not None:      # the loader observed this batch
                total = stall.stats(workers="threads")["sum"]
                self.stalls.append(total - self._stall_sum)
                self._stall_sum = total

        def on_train_batch_end(self, step, logs=None):
            self.ends.append(time.perf_counter())
            if self._prof is not None:
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - self._t0) * 1e6
                self._prof.__exit__(None, None, None)
                self.profile = profile_figures(self._prof, wall_us)
                self._prof = None
            if profile_step is not None and step == profile_step - 1:
                torch.cuda.synchronize()
                self._prof = profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA])
                self._prof.__enter__()
                self._t0 = time.perf_counter()

        def timed(self, warm):
            """Seconds of each batch after the first ``warm``."""
            return [b - a for a, b in zip(self.ends[warm - 1:],
                                          self.ends[warm:])]

    return StepClock()


def hapi_images(torch, size, seed, flip):
    """FakeData at ImageNet's shape through hapi_fit's transforms."""
    from paddle_tpu_torch.vision import transforms as T
    from paddle_tpu_torch.vision.datasets import FakeData

    norm = T.Normalize(IMAGENET_MEAN, IMAGENET_STD, data_format="CHW")
    return FakeData(size=size, image_shape=(3, RESNET_PX, RESNET_PX),
                    num_classes=RESNET_CLASSES, seed=seed, transform=(
                        T.Compose([T.RandomHorizontalFlip(), norm]) if flip
                        else norm))


def hapi_model(torch, dev, net):
    """``Model(net)`` prepared as hapi_fit's: Momentum, CrossEntropyLoss,
    top-1/top-5 Accuracy."""
    from paddle_tpu_torch import Model, metric, nn
    from paddle_tpu_torch.optimizer import Momentum

    opt = Momentum(learning_rate=RESNET_LR, momentum=RESNET_MOMENTUM,
                   parameters=net.named_parameters(), device=dev)
    return Model(net).prepare(opt, nn.CrossEntropyLoss(),
                              metric.Accuracy(topk=(1, 5)))


def state_equal(torch, a, b):
    """Names of the tensors of two state dicts that differ."""
    return [k for k, v in a.items() if isinstance(v, torch.Tensor)
            and not torch.equal(v, b[k])]


def hapi_fit_phase(torch, dev):
    """ResNet-50 through the high-level API (see the module docstring):
    Model.fit from FakeData through the threaded DataLoader with eval
    data, evaluate, predict, save and load into a fresh model (evaluate
    bit for bit), fit = TrainStep bit for bit over the same batches; fit
    in turns with a TrainStep loop on batches already on the card."""
    import random
    import tempfile

    import numpy as np

    from paddle_tpu_torch import io, nn
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.observability import metrics as obs_metrics
    from paddle_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from paddle_tpu_torch.vision.models import resnet50

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    stall = obs_metrics.histogram("dataloader.stall_seconds")
    train = hapi_images(torch, HAPI_TRAIN, 0, flip=True)
    evalset = hapi_images(torch, HAPI_EVAL, 1, flip=False)

    def loader(ds, shuffle):
        return io.DataLoader(ds, places=dev, batch_size=RESNET_BATCH,
                             shuffle=shuffle, drop_last=True,
                             num_workers=HAPI_WORKERS)

    net = resnet50(num_classes=RESNET_CLASSES, device=dev, seed=0)
    twin = copy.deepcopy(net)          # the wiring check's initial state
    model = hapi_model(torch, dev, net)
    steps = HAPI_TRAIN // RESNET_BATCH
    with backend_flags(torch, benchmark=True, tf32=False) as flags:
        random.seed(0)
        np.random.seed(0)
        stall.clear()
        reset_kernel_launches()
        clock = step_clock(torch, stall=stall)
        t0 = time.perf_counter()
        model.fit(loader(train, True), eval_data=evalset,
                  batch_size=RESNET_BATCH, epochs=1, verbose=0,
                  callbacks=[clock])
        fit_s = time.perf_counter() - t0
        launches = kernel_launches()
        fit_step_s = clock.timed(HAPI_WARM)
        stalls = clock.stalls
        ev = model.evaluate(evalset, batch_size=RESNET_BATCH, verbose=0)
        pred = model.predict(io.Subset(evalset, range(RESNET_BATCH)),
                             batch_size=RESNET_BATCH)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if any(launches.values()):
        raise AssertionError(f"hapi_fit: a port kernel ran on a path that "
                             f"reaches none {launches}")
    if len(clock.ends) != steps or len(stalls) != steps:
        raise AssertionError(f"hapi_fit: {len(clock.ends)} of {steps} "
                             "train batches")
    for k in ("loss", "acc_top1", "acc_top5"):
        if not (math.isfinite(ev[k]) and (k == "loss" or 0 <= ev[k] <= 1)):
            raise AssertionError(f"hapi_fit: evaluate {k} = {ev[k]}")
    logits = pred[0][0]
    if logits.shape != (RESNET_BATCH, RESNET_CLASSES) or \
            not np.isfinite(logits).all():
        raise AssertionError(f"hapi_fit: predict gave {logits.shape}")

    # save, then load into a fresh model: its evaluate bit for bit
    with tempfile.TemporaryDirectory() as tmp, backend_flags(
            torch, deterministic=True, benchmark=False, tf32=False):
        path = os.path.join(tmp, "resnet50")
        model.save(path)
        fresh = hapi_model(torch, dev, resnet50(
            num_classes=RESNET_CLASSES, device=dev, seed=1))
        fresh.load(path)
        differ = state_equal(torch, net.state_dict(),
                             fresh.network.state_dict())
        differ += state_equal(torch, model._optimizer.state_dict(),
                              fresh._optimizer.state_dict())
        ev1 = model.evaluate(evalset, batch_size=RESNET_BATCH, verbose=0)
        ev2 = fresh.evaluate(evalset, batch_size=RESNET_BATCH, verbose=0)
        p1 = model.predict_batch([torch.from_numpy(np.stack(
            [evalset[i][0] for i in range(8)]))])[0]
        p2 = fresh.predict_batch([torch.from_numpy(np.stack(
            [evalset[i][0] for i in range(8)]))])[0]
    if differ or ev1 != ev2 or not np.array_equal(p1, p2):
        raise AssertionError(f"hapi_fit: the loaded model differs: "
                             f"{differ[:8]} {ev1} {ev2}")
    del fresh

    # fit = TrainStep over the same batches from one initial state
    def ce_loss(m, x, y):
        return nn.CrossEntropyLoss()(m(x), y)

    with backend_flags(torch, deterministic=True, benchmark=False,
                       tf32=False):
        wired = hapi_model(torch, dev, copy.deepcopy(twin))
        wired.fit(loader(hapi_images(torch, HAPI_TRAIN, 0, flip=False),
                         False), epochs=1, verbose=0,
                  num_iters=HAPI_WIRING_STEPS)
        plain_opt = hapi_model(torch, dev, twin)._optimizer
        step = TrainStep(twin, ce_loss, plain_opt, device=dev)
        for i, (x, y) in enumerate(loader(hapi_images(
                torch, HAPI_TRAIN, 0, flip=False), False)):
            if i == HAPI_WIRING_STEPS:
                break
            step(x, y)
    differ = state_equal(torch, wired.network.state_dict(),
                         twin.state_dict())
    differ += state_equal(torch, wired._optimizer.state_dict(),
                          plain_opt.state_dict())
    if differ:
        raise AssertionError(f"hapi_fit: fit and TrainStep differ in "
                             f"{len(differ)} tensors {differ[:8]}")
    del wired, step, plain_opt

    # fit in turns with a TrainStep loop on batches already on the card
    step = TrainStep(net, ce_loss, model._optimizer, device=dev)
    on_card = []
    for x, y in loader(train, False):
        on_card.append((x, y))
    turns = {"fit": [], "train_step": []}
    with backend_flags(torch, benchmark=True, tf32=False):
        for kind in ("fit", "train_step", "train_step", "fit"):
            if kind == "fit":
                clock = step_clock(torch)
                model.fit(loader(train, True), epochs=1, verbose=0,
                          callbacks=[clock])
                turns["fit"] += clock.timed(HAPI_WARM)
            else:
                ends = []
                for x, y in on_card:
                    step(x, y).item()
                    ends.append(time.perf_counter())
                turns["train_step"] += [b - a for a, b in zip(
                    ends[HAPI_WARM - 1:], ends[HAPI_WARM:])]
        # one fit step under the profiler, the loader's wait included
        clock = step_clock(torch, profile_step=HAPI_WARM + 2)
        model.fit(loader(train, True), epochs=1, verbose=0,
                  num_iters=HAPI_WARM + 3, callbacks=[clock])
    if clock.profile is None:
        raise AssertionError("hapi_fit: the profiled fit step was not "
                             "reached")
    fit_ips = RESNET_BATCH / statistics.mean(turns["fit"])
    step_ips = RESNET_BATCH / statistics.mean(turns["train_step"])
    out = {"phase": "hapi_fit", "model": "resnet50(num_classes=1000)",
           "dtype": "float32", "backend_flags": flags,
           "data": f"FakeData({HAPI_TRAIN}, (3, {RESNET_PX}, {RESNET_PX}), "
                   f"1000) RandomHorizontalFlip + Normalize(ImageNet)",
           "loader": {"batch_size": RESNET_BATCH, "num_workers":
                      HAPI_WORKERS, "workers": "threads", "shuffle": True,
                      "drop_last": True},
           "optimizer": f"Momentum({RESNET_LR}, {RESNET_MOMENTUM})",
           "fit_s": fit_s, "fit_step_s": fit_step_s,
           "fit_step_s_mean": statistics.mean(fit_step_s),
           "fit_step_s_range": [min(fit_step_s), max(fit_step_s)],
           "fit_images_per_s": RESNET_BATCH / statistics.mean(fit_step_s),
           "loader_stall_s": stalls,
           "loader_stall_after_warm_s": {
               "mean": statistics.mean(stalls[HAPI_WARM:]),
               "max": max(stalls[HAPI_WARM:])},
           "loader_stall_first_s": stalls[0],
           "fit_step_profile": clock.profile,
           "evaluate": ev, "predict_shape": list(logits.shape),
           "peak_memory_gb": peak_gb, "kernel_launches": launches,
           "save_load_bitwise": True, "fit_equals_train_step_bitwise": True,
           "wiring_steps": HAPI_WIRING_STEPS,
           "turns_step_s": turns,
           "turns_images_per_s": {"fit": fit_ips, "train_step": step_ips},
           "fit_over_train_step": fit_ips / step_ips,
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    del step, model, net, twin, on_card
    gc.collect()
    torch.cuda.empty_cache()
    return launches


class MLMLoss:
    """``benchmarks/ab_hapi_fit.py``'s MLMLoss: cross-entropy of the MLM
    logits over every scored position (labels -100 elsewhere)."""

    def __call__(self, logits, labels):
        from paddle_tpu_torch.nn import functional as F

        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1))


def hapi_fit_bert_phase(torch, dev, flash_figures=None):
    """BERT-base MLM through Model.fit as ``benchmarks/ab_hapi_fit.py``
    (see the module docstring): the five kernels' launches asserted per
    step; fit in turns with a TrainStep loop on one batch on the card."""
    from paddle_tpu_torch import Model, io
    from paddle_tpu_torch import random as prandom
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.bert import BERT_BASE, BertForMaskedLM
    from paddle_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from paddle_tpu_torch.optimizer import AdamW

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(BERT_BASE, attention_probs_dropout_prob=0.0)
    prandom.seed(2019)
    net = BertForMaskedLM(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    opt = AdamW(learning_rate=1e-4, parameters=net.named_parameters(),
                multi_precision=True, device=dev)
    model = Model(net).prepare(opt, MLMLoss())
    n = BERT_BATCH * HAPI_BERT_STEPS
    ids, _, labels = bert_batch(torch, cfg, n, BERT_SEQ, "cpu", 4321)
    data = io.TensorDataset([ids, labels])
    clock = step_clock(torch)
    losses = []
    reset_kernel_launches()
    model.fit(data, batch_size=BERT_BATCH, epochs=1, shuffle=True,
              verbose=0, callbacks=[clock])
    launches = kernel_launches()
    for name, per in BERT_FLASH_PER_STEP.items():
        if launches[name] != per * HAPI_BERT_STEPS:
            raise AssertionError(f"hapi_fit_bert: {name} launched "
                                 f"{launches[name]} times in "
                                 f"{HAPI_BERT_STEPS} steps, want {per} a step")
    fit_step_s = clock.timed(HAPI_WARM)
    batch = (ids[:BERT_BATCH].to(dev), labels[:BERT_BATCH].to(dev))
    step = TrainStep(net, lambda m, x, y: MLMLoss()(m(x), y), opt,
                     device=dev)
    turns = {"fit": [], "train_step": []}
    for kind in ("fit", "train_step", "train_step", "fit"):
        if kind == "fit":
            clock = step_clock(torch)
            model.fit(data, batch_size=BERT_BATCH, epochs=1, shuffle=True,
                      verbose=0, callbacks=[clock])
            turns["fit"] += clock.timed(HAPI_WARM)
        else:
            ends = []
            for _ in range(HAPI_BERT_STEPS):
                losses.append(step(*batch).item())
                ends.append(time.perf_counter())
            turns["train_step"] += [b - a for a, b in zip(
                ends[HAPI_WARM - 1:], ends[HAPI_WARM:])]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"hapi_fit_bert: non-finite loss {losses}")
    fit_sps = BERT_BATCH / statistics.mean(turns["fit"])
    step_sps = BERT_BATCH / statistics.mean(turns["train_step"])
    out = {"phase": "hapi_fit_bert", "model": "BERT_BASE MLM",
           "dtype": "bfloat16", "attention_dropout": 0.0,
           "batch": BERT_BATCH, "seq": BERT_SEQ, "optimizer":
           "AdamW(1e-4, multi_precision)", "steps": HAPI_BERT_STEPS,
           "fit_step_s": fit_step_s,
           "fit_seqs_per_s": BERT_BATCH / statistics.mean(fit_step_s),
           "turns_step_s": turns,
           "turns_seqs_per_s": {"fit": fit_sps, "train_step": step_sps},
           "fit_over_train_step": fit_sps / step_sps,
           "bert_train_flash_seqs_per_s": (
               flash_figures["seqs_per_s"] if flash_figures else None),
           "train_step_losses": losses,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "kernel_launches": launches,
           "launches_per_step": BERT_FLASH_PER_STEP,
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    del step, model, net, opt, data, batch
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------ float16 and the MT slice
# bert_amp: BERT-base MLM at bert_train_flash's config in float16 AMP: O2
# (amp.decorate, f32 master weights) and O1 with attention dropout 0.1
BERT_AMP_TURNS = ("float16", "bfloat16", "bfloat16", "float16", "float16",
                  "bfloat16")
BERT_AMP_STEPS_A_TURN = 3
# serve_fp16: LLaMA-2-7B widths at SERVE_LAYERS layers in float16
SERVE_FP16_DRIVE = dict(lengths=(16, 40, 100, 200, 350, 500, 750, 1024),
                        new_tokens=32)
# transformer_mt: Transformer-base (Vaswani et al. 2017, sec. 3 and 5):
# nn.Transformer's defaults, a 37,000-token shared vocabulary (the
# paper's BPE vocabulary for WMT14 en-de), label smoothing 0.1,
# Adam(0.9, 0.98, 1e-9) under NoamDecay(512, 4000); 32 pairs of 64-128
# tokens a batch, padded to 128
MT_CONFIG = dict(d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1)
MT_VOCAB, MT_SEQ, MT_BATCH = 37000, 128, 32
MT_PAD, MT_BOS, MT_EOS = 0, 1, 2
MT_WARM_PACK, MT_TIMED_PACK = 2, 4
MT_DECODE_SOURCES, MT_DECODE_TOKENS = 8, 32
# a cached decode step's logits against the full forward's row over the
# same prefix: both run float16 AMP (their products round in float16 at
# other points: q_len 1 against a masked window of up to 32 rows, flash
# against the plain path), so a row may move by a few float16 ulps of
# its largest logit through 6 layers; a wrong cache (a shifted position,
# a missing key) moves it by the logits' whole spread
MT_DECODE_TOL = 2.0 ** -6
# lbfgs: a least-squares MLP on the card against the CPU, f32, TF32 off
LBFGS_DIMS, LBFGS_ROWS, LBFGS_STEPS = (64, 32, 1), 512, 3


def scale_path_check(phase, records):
    """Each step of a GradScaler run (scale before and after, bad-step
    count before and after, whether any parameter moved, the learning
    rate): a skipped step (the bad count rose) halves the scale and moves
    no parameter; any other keeps the scale (no 2000-step growth in a
    short run) and, at a learning rate above 0, trains."""
    for i, (s0, s1, b0, b1, moved, lr) in enumerate(records):
        skipped = b1 > b0
        if skipped and (s1 != s0 / 2 or moved):
            raise AssertionError(f"{phase}: skipped step {i} moved the "
                                 f"parameters or the scale {s0} -> {s1}")
        if not skipped and (s1 != s0 or (lr > 0 and not moved)):
            raise AssertionError(f"{phase}: step {i} at scale {s0} -> {s1}, "
                                 f"lr {lr}, moved parameters: {moved}")


def scaled_step(torch, step, batch, records, losses, times=None):
    """One step of ``step`` (a TrainStep with a scaler) on ``batch``: its
    loss, host seconds (when ``times`` is a list) and scale record (see
    scale_path_check) appended."""
    scaler, model = step.scaler, step.model
    before = [p.detach().clone() for p in model.parameters()]
    lr = step.optimizer.get_lr()
    s0, b0 = scaler.get_loss_scaling().item(), int(scaler._bad_steps)
    t1 = time.perf_counter()
    losses.append(step(*batch).item())             # .item() synchronises
    if times is not None:
        times.append(time.perf_counter() - t1)
    moved = any(not torch.equal(p, q)
                for p, q in zip(model.parameters(), before))
    records.append((s0, scaler.get_loss_scaling().item(), b0,
                    int(scaler._bad_steps), moved, lr))


def bert_amp_phase(torch, dev, flash_figures):
    """BERT-base MLM at bert_train_flash's config (b32 x s128, attention
    dropout 0, hidden dropout 0.1) under amp.decorate(level="O2",
    dtype="float16"): float16 parameters, AdamW's f32 master weights, a
    GradScaler through TrainStep(scaler=), the flash kernels in float16
    (12 + 12 + 12 launches a step) and LayerNorm in f32 (26 + 26);
    BERT_WARMUP warm-up and BERT_TIMED timed steps, the loss finite and
    falling over the timed steps, the scale path matching the skipped
    steps; then its steps and bert_train_flash's bf16 steps in turns on
    one seed's weights (BERT_AMP_TURNS), sequences a second of each.
    Then the same model in f32 under O1 float16 with attention dropout
    0.1 (the plain float16 path: no flash launch), the same checks."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch import random as prandom
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.bert import BERT_BASE, BertForMaskedLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import LinearWarmup, PolynomialDecay

    free_device_memory(torch)
    torch.cuda.reset_peak_memory_stats()

    def build(cfg, dtype, level):
        """(schedule, step) as bert_train_run's, in ``dtype`` (bfloat16:
        no AMP; float16: O2 through decorate; float32: O1)."""
        prandom.seed(2019)
        model = BertForMaskedLM(cfg, device=dev, dtype=(
            torch.bfloat16 if dtype == "bfloat16" else torch.float32),
            seed=0)
        model.train()
        sched = LinearWarmup(PolynomialDecay(
            BERT_LR, BERT_TIMED, end_lr=0.0, power=1.0), BERT_WARMUP, 0.0,
            BERT_LR)
        opt = AdamW(learning_rate=sched, beta1=0.9, beta2=0.999,
                    epsilon=1e-8, parameters=model.named_parameters(),
                    weight_decay=0.01,
                    apply_decay_param_fun=lambda n: not (
                        n.endswith("bias") or "norm" in n),
                    grad_clip=ClipGradByGlobalNorm(1.0),
                    multi_precision=True, device=dev)
        if level is None:
            return sched, TrainStep(model, bert_loss, opt, device=dev)
        if level == "O2":
            model, opt = amp.decorate(model, opt, level="O2",
                                      dtype="float16")

        def loss(net, *batch):
            with amp.auto_cast(level=level, dtype="float16"):
                return bert_loss(net, *batch)

        return sched, TrainStep(model, loss, opt,
                                scaler=amp.GradScaler(device=dev),
                                device=dev)

    cfg = dataclasses.replace(BERT_BASE, attention_probs_dropout_prob=0.0)
    batch = bert_batch(torch, cfg, BERT_BATCH, BERT_SEQ, dev, 1234)
    runs = {}
    for name, run_cfg, level, per_step in (
            ("O2", cfg, "O2", BERT_FLASH_PER_STEP),
            ("O1_attention_dropout", BERT_BASE, "O1", BERT_PER_STEP)):
        sched, step = build(run_cfg, "float16" if level == "O2"
                            else "float32", level)
        records, losses, step_s = [], [], []
        for _ in range(BERT_WARMUP):
            scaled_step(torch, step, batch, records, losses)
            sched.step()
        reset_kernel_launches()
        for _ in range(BERT_TIMED):
            scaled_step(torch, step, batch, records, losses, step_s)
            sched.step()
        launches = kernel_launches()
        for k, n in per_step.items():
            if launches[k] != n * BERT_TIMED:
                raise AssertionError(f"bert_amp {name}: {k} launched "
                                     f"{launches[k]} times in {BERT_TIMED} "
                                     f"steps, want {n} a step")
        timed = losses[BERT_WARMUP:]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"bert_amp {name}: non-finite loss {losses}")
        if not timed[-1] < timed[0]:
            raise AssertionError(f"bert_amp {name}: loss did not fall "
                                 f"{timed}")
        scale_path_check(f"bert_amp {name}", records)
        dtypes = sorted({str(p.dtype) for p in step.model.parameters()})
        masters = sorted({str(st["master_weight"].dtype) for st in
                          step.optimizer._accumulators.values()
                          if "master_weight" in st})
        mean_s = statistics.mean(step_s)
        runs[name] = {"level": level, "param_dtypes": dtypes,
                      "master_weight_dtypes": masters,
                      "attention_dropout":
                          run_cfg.attention_probs_dropout_prob,
                      "losses": losses, "step_s": step_s,
                      "step_s_mean": mean_s,
                      "seqs_per_s": BERT_BATCH / mean_s,
                      "scale_path": [r[0] for r in records]
                      + [records[-1][1]],
                      "skipped_steps": sum(r[3] > r[2] for r in records),
                      "kernel_launches": launches}
        if name == "O2":
            fp16_step, amp_launches = step, launches
        del step
    # the float16 O2 step and bert_train_flash's bf16 step in turns, on
    # one seed's weights (the bf16 model built as bert_train_run's)
    _, bf16_step = build(cfg, "bfloat16", None)
    for _ in range(BERT_WARMUP):
        bf16_step(*batch).item()
    turns = {"float16": [], "bfloat16": []}
    for dname in BERT_AMP_TURNS:
        stepper = fp16_step if dname == "float16" else bf16_step
        for _ in range(BERT_AMP_STEPS_A_TURN):
            t1 = time.perf_counter()
            stepper(*batch).item()
            turns[dname].append(time.perf_counter() - t1)
    ratio = statistics.median(turns["bfloat16"]) / statistics.median(
        turns["float16"])
    emit({"phase": "bert_amp", "model": "BERT_BASE", "batch": BERT_BATCH,
          "seq": BERT_SEQ, "runs": runs,
          "turns_step_s": turns,
          "turns_fp16_over_bf16_seqs_per_s": ratio,
          "bert_train_flash_seqs_per_s": flash_figures["seqs_per_s"],
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    del fp16_step, bf16_step, batch
    free_device_memory(torch)
    return amp_launches


def serve_fp16_phase(torch, dev):
    """A float16 LLaMA (LLaMA-2-7B widths at SERVE_LAYERS layers, seeded
    random weights made on the card) served by Engine(num_slots=8,
    max_seq_len=2048) with no cache dtype given: the pool follows the
    model into float16 and the paged kernel runs its float16 variant.
    SERVE_FP16_DRIVE's 8 greedy requests together, then each alone on
    the same engine: the streams bitwise equal, the launch counts of
    each drive equal to its forwards, no block leased after either."""
    from paddle_tpu_torch.models.llama import LLAMA2_7B, LlamaForCausalLM
    from paddle_tpu_torch.serving import (
        Engine, EngineConfig, SamplingParams, kernel_launches,
        reset_kernel_launches,
    )

    free_device_memory(torch)
    cfg = dataclasses.replace(LLAMA2_7B, num_hidden_layers=SERVE_LAYERS)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.float16, seed=0)
    eng = Engine(model, EngineConfig(num_slots=SERVE_SLOTS,
                                     max_seq_len=SERVE_MAX_SEQ,
                                     prefix_cache_bytes=0), device=dev)
    if eng.pool.store_dtype != torch.float16:
        raise AssertionError(f"serve_fp16: pool {eng.pool.store_dtype}, "
                             "want the model's float16")
    eng.generate([1, 2, 3, 4], SamplingParams(max_new_tokens=4))  # warm-up
    g = torch.Generator(device="cpu").manual_seed(1717)
    sd = SERVE_FP16_DRIVE
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()
               for n in sd["lengths"]]
    sp = SamplingParams(max_new_tokens=sd["new_tokens"])
    figures = {}
    streams = {}
    for mode in ("batched", "sequential"):
        before = eng.stats()
        reset_kernel_launches()
        t0 = time.perf_counter()
        if mode == "batched":
            reqs = [eng.submit(p, sp) for p in prompts]
            eng.run()
        else:
            reqs = []
            for p in prompts:
                reqs.append(eng.submit(p, sp))
                eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_launches()
        after = eng.stats()
        delta = {k: after[k] - before[k] for k in (
            "prefill_calls", "decode_steps", "decode_tokens",
            "decode_seconds")}
        check_drained(eng)
        check_serving_launches(launches, SERVE_LAYERS,
                               delta["prefill_calls"], delta["decode_steps"])
        streams[mode] = [list(r.output_ids) for r in reqs]
        for r in reqs:
            if len(r.output_ids) != sd["new_tokens"]:
                raise AssertionError(f"serve_fp16: request "
                                     f"{r.request_id} gave "
                                     f"{len(r.output_ids)} tokens")
        figures[mode] = {"wall_s": wall, "decode_tokens_per_s":
                         delta["decode_tokens"] / delta["decode_seconds"],
                         "prefill_dispatches": delta["prefill_calls"],
                         "decode_steps": delta["decode_steps"],
                         "kernel_launches": launches}
    if streams["batched"] != streams["sequential"]:
        bad = [i for i, (a, b) in enumerate(zip(*streams.values()))
               if a != b]
        raise AssertionError(f"serve_fp16: batched and sequential greedy "
                             f"streams differ for requests {bad}")
    emit({"phase": "serve_fp16", "model": "LLAMA2_7B widths",
          "layers": SERVE_LAYERS, "dtype": "float16",
          "pool_dtype": str(eng.pool.store_dtype), "requests": len(prompts),
          "prompt_lengths": list(sd["lengths"]),
          "new_tokens_each": sd["new_tokens"],
          "batched_equals_sequential": "bitwise", **figures})
    launches = figures["batched"]["kernel_launches"]
    del eng, model
    free_device_memory(torch)
    return launches


def mt_pairs(torch, n, seed):
    """``n`` seeded (source, target) pairs as int32 [n, 2, MT_SEQ]: each
    side a length in 64..128, BOS, random ids in [3, MT_VOCAB), EOS, then
    MT_PAD."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    out = torch.full((n, 2, MT_SEQ), MT_PAD, dtype=torch.int32)
    lens = torch.randint(64, MT_SEQ + 1, (n, 2), generator=g)
    for i in range(n):
        for side in range(2):
            m = int(lens[i, side])
            out[i, side, 0] = MT_BOS
            out[i, side, 1:m - 1] = torch.randint(3, MT_VOCAB, (m - 2,),
                                                  generator=g)
            out[i, side, m - 1] = MT_EOS
    return out


def mt_model(torch, dev):
    """Transformer-base with a shared source/target embedding (scaled by
    sqrt(d_model), sinusoidal positions, dropout 0.1 on the sum) and the
    output projection tied to it, composed here over nn.Transformer."""
    from torch import nn as tnn

    from paddle_tpu_torch import nn
    from paddle_tpu_torch import random as prandom
    from paddle_tpu_torch.tensor import matmul

    d = MT_CONFIG["d_model"]

    class MTModel(tnn.Module):
        def __init__(self):
            super().__init__()
            self.transformer = nn.Transformer(**MT_CONFIG, device=dev)
            self.embedding = nn.Embedding(MT_VOCAB, d, device=dev)
            with torch.no_grad():   # N(0, d^-1/2): unit variance once scaled
                self.embedding.weight.normal_(
                    0.0, d ** -0.5, generator=prandom.next_generator(dev))
            pos = torch.arange(4 * MT_SEQ, dtype=torch.float32)[:, None]
            div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32)
                            * (-math.log(10000.0) / d))
            pe = torch.zeros(4 * MT_SEQ, d)
            pe[:, 0::2], pe[:, 1::2] = torch.sin(pos * div), torch.cos(
                pos * div)
            self.register_buffer("pe", pe.to(dev))
            self.dropout = nn.Dropout(MT_CONFIG["dropout"])

        def embed(self, ids, start=0):
            x = self.embedding(ids) * math.sqrt(d)
            return self.dropout(x + self.pe[start:start + ids.shape[1]])

        def logits(self, h):
            return matmul(h, self.embedding.weight.t())

        def forward(self, src, tgt_in, src_mask=None):
            t = self.transformer
            causal = t.generate_square_subsequent_mask(tgt_in.shape[1], dev)
            memory = t.encoder(self.embed(src), src_mask)
            return self.logits(t.decoder(self.embed(tgt_in), memory, causal,
                                         src_mask))

    prandom.seed(1706)
    return MTModel()


def mt_loss(net, batch):
    """Label-smoothed (0.1) cross entropy of the next target token under
    O1 float16 AMP, the source's padding masked in the encoder and the
    cross-attention, the targets' padding ignored."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import functional as F

    src, tgt = batch[:, 0].long(), batch[:, 1].long()
    src_mask = (src != MT_PAD)[:, None, None, :]
    with amp.auto_cast(dtype="float16"):
        logits = net(src, tgt[:, :-1], src_mask)
        return F.cross_entropy(logits.reshape(-1, MT_VOCAB),
                               tgt[:, 1:].reshape(-1), ignore_index=MT_PAD,
                               label_smoothing=0.1)


def transformer_mt_phase(torch, dev):
    """Transformer-base translation training and decoding (see MT_*):
    (MT_WARM_PACK + MT_TIMED_PACK) x MT_BATCH seeded pairs written with
    io.RecordWriter, read back through io.RecordDataset and an
    io.DataLoader onto the card; TrainStep.many over a pack of
    MT_WARM_PACK batches, then over MT_TIMED_PACK timed ones, under O1
    float16 AMP with a GradScaler (every loss finite, the parameters
    moved, the scale path matching the skipped steps); then greedy
    decoding of MT_DECODE_SOURCES sources (each alone at its own length:
    no mask, so both attentions run the flash forward at q_len 1) for
    MT_DECODE_TOKENS tokens through decoder.gen_cache: each step's logits
    against the full forward over the same prefix within MT_DECODE_TOL
    of the row's largest logit, the flash forward launched twice a layer
    a step."""
    import tempfile

    import numpy as np

    from paddle_tpu_torch import amp, io
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.optimizer.lr import NoamDecay

    free_device_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = mt_model(torch, dev)
    model.train()
    sched = NoamDecay(MT_CONFIG["d_model"], 4000)
    opt = Adam(learning_rate=sched, beta1=0.9, beta2=0.98, epsilon=1e-9,
               parameters=model.named_parameters(), device=dev)
    scaler = amp.GradScaler(device=dev)
    step = TrainStep(model, mt_loss, opt, scaler=scaler, device=dev)
    n_batches = MT_WARM_PACK + MT_TIMED_PACK
    pairs = mt_pairs(torch, n_batches * MT_BATCH, 31)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "paddle_tpu_torch", "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        path = os.path.join(tmp, "wmt_pairs.ptrec")
        with io.RecordWriter(path) as w:
            for p in pairs.numpy():
                w.write(p)
        ds = io.RecordDataset(path, ndarray_spec=(np.int32, (2, MT_SEQ)))
        t1 = time.perf_counter()
        batches = [(b,) for b in io.DataLoader(ds, places=dev,
                                               batch_size=MT_BATCH,
                                               num_workers=2)]
        load_s = time.perf_counter() - t1
        ds._rf.close()
    if len(batches) != n_batches or not torch.equal(
            torch.cat([b[0] for b in batches]).cpu(), pairs):
        raise AssertionError("transformer_mt: the record file's batches "
                             "differ from the pairs written")
    setup_s = time.perf_counter() - t0
    records = []

    def pack(bs):
        s0, b0 = scaler.get_loss_scaling().item(), int(scaler._bad_steps)
        before = [p.detach().clone() for p in model.parameters()]
        t1 = time.perf_counter()
        losses = step.many(bs).tolist()           # synchronises
        secs = time.perf_counter() - t1
        records.append((s0, scaler.get_loss_scaling().item(), b0,
                        int(scaler._bad_steps),
                        any(not torch.equal(p, q)
                            for p, q in zip(model.parameters(), before))))
        for _ in bs:
            sched.step()
        return losses, secs

    warm_losses, _ = pack(batches[:MT_WARM_PACK])
    lr_timed = opt.get_lr()
    timed_losses, pack_s = pack(batches[MT_WARM_PACK:])
    losses = warm_losses + timed_losses
    if len(timed_losses) != MT_TIMED_PACK or not all(
            math.isfinite(x) for x in losses):
        raise AssertionError(f"transformer_mt: losses {losses}")
    # a pack moves the parameters unless every step in it was skipped
    for i, (s0, s1, b0, b1, moved) in enumerate(records):
        k = (MT_WARM_PACK, MT_TIMED_PACK)[i]
        if moved != (b1 - b0 < k) or s1 != s0 / 2 ** (b1 - b0):
            raise AssertionError(f"transformer_mt: pack {i} scale {s0} -> "
                                 f"{s1}, {b1 - b0} skipped of {k}, moved "
                                 f"{moved}")
    tokens = sum(int((b[0][:, 1, 1:] != MT_PAD).sum()) for b in
                 batches[MT_WARM_PACK:])
    train = {"pack_s": pack_s, "steps_per_s": MT_TIMED_PACK / pack_s,
             "target_tokens_per_s": tokens / pack_s, "losses": losses,
             "lr_after_warm_pack": lr_timed,
             "scale_packs": [(r[0], r[1], r[3] - r[2]) for r in records],
             "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
             "record_load_s": load_s, "setup_s": setup_s}
    del batches, step

    # greedy decoding through the incremental caches
    model.eval()
    t = model.transformer
    worst, steps_checked = 0.0, 0
    reset_kernel_launches()
    decode_s = 0.0
    sources = [p[0][:int((p[0] != MT_PAD).sum())].long().to(dev)
               for p in pairs[:MT_DECODE_SOURCES]]
    with torch.no_grad(), amp.auto_cast(dtype="float16"):
        for src in sources:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            memory = t.encoder(model.embed(src[None]))
            cache = t.decoder.gen_cache(memory)
            out_ids, rows = [MT_BOS], []
            for i in range(MT_DECODE_TOKENS):
                x = model.embed(torch.tensor([[out_ids[-1]]], device=dev),
                                start=i)
                h, cache = t.decoder(x, memory, None, None, cache)
                row = model.logits(h)[0, 0].float()
                rows.append(row)
                out_ids.append(int(row.argmax()))
            torch.cuda.synchronize()
            decode_s += time.perf_counter() - t1
            prefix = torch.tensor([out_ids[:-1]], device=dev)
            full = model.logits(t.decoder(
                model.embed(prefix), memory,
                t.generate_square_subsequent_mask(MT_DECODE_TOKENS, dev)))
            full = full[0].float()
            for i, row in enumerate(rows):
                err = (row - full[i]).abs().max().item()
                lim = MT_DECODE_TOL * full[i].abs().max().item()
                worst = max(worst, err / full[i].abs().max().item())
                if not (math.isfinite(err) and err <= lim):
                    raise AssertionError(
                        f"transformer_mt: cached step {i} logits differ "
                        f"from the full forward by {err:.4e} > {lim:.4e}")
                steps_checked += 1
    launches = kernel_launches()
    layers = len(t.decoder.layers)
    # decode steps: 2 flash forwards a decoder layer; encoders and the
    # full forwards' cross-attention add one a layer each
    want = MT_DECODE_SOURCES * (MT_DECODE_TOKENS * 2 * layers
                                + len(t.encoder.layers) + layers)
    if launches["flash_fwd"] != want:
        raise AssertionError(f"transformer_mt: flash_fwd launched "
                             f"{launches['flash_fwd']} times, want {want}")
    emit({"phase": "transformer_mt", "model": "Transformer-base",
          "vocab": MT_VOCAB, "batch": MT_BATCH, "seq": MT_SEQ,
          "params": sum(p.numel() for p in model.parameters()),
          "auto_cast": "O1 float16", "many_packs": [MT_WARM_PACK,
                                                     MT_TIMED_PACK],
          "train": train, "decode": {
              "sources": MT_DECODE_SOURCES, "tokens": MT_DECODE_TOKENS,
              "steps_checked": steps_checked,
              "worst_rel_err_vs_full": worst, "tol": MT_DECODE_TOL,
              "tokens_per_s": MT_DECODE_SOURCES * MT_DECODE_TOKENS
              / decode_s, "flash_fwd_launches": launches["flash_fwd"]}})
    del model, opt, scaler
    free_device_memory(torch)
    return {"flash_fwd": launches["flash_fwd"]}


def lbfgs_phase(torch, dev):
    """optimizer.LBFGS (strong-Wolfe line search) on a least-squares MLP
    (LBFGS_DIMS, tanh, LBFGS_ROWS seeded rows) on the card in f32 with
    TF32 off, against the same start on the CPU: every parameter after
    each of LBFGS_STEPS steps within 1e-4 of its largest magnitude, the
    losses within 1e-4 relative, and the loss falling."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch import random as prandom
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import LBFGS

    i, h, o = LBFGS_DIMS
    g = torch.Generator(device="cpu").manual_seed(77)
    x = torch.randn(LBFGS_ROWS, i, generator=g)
    y = torch.randn(LBFGS_ROWS, o, generator=g)
    prandom.seed(5)        # one start for both: made on the CPU, copied
    start = nn.Sequential(nn.Linear(i, h, device="cpu"), nn.Tanh(),
                          nn.Linear(h, o, device="cpu"))
    runs = {}
    with backend_flags(torch, tf32=False):
        for where in ("cpu", dev):
            net = copy.deepcopy(start).to(where)
            opt = LBFGS(learning_rate=1.0, max_iter=10, history_size=10,
                        line_search_fn="strong_wolfe",
                        parameters=net.parameters(), device=where)
            xd, yd = x.to(where), y.to(where)

            def closure():
                loss = F.mse_loss(net(xd), yd)
                loss.backward()
                return loss

            losses, iterates = [], []
            for _ in range(LBFGS_STEPS):
                losses.append(opt.step(closure).item())
                iterates.append([p.detach().cpu().clone()
                                 for p in net.parameters()])
            runs[str(where)] = (losses, iterates)
    (cl, ci), (dl, di) = runs["cpu"], runs[str(dev)]
    for k in range(LBFGS_STEPS):
        for a, b in zip(di[k], ci[k]):
            if (a - b).abs().max() > 1e-4 * b.abs().max():
                raise AssertionError(f"lbfgs: step {k} iterate differs "
                                     f"from the CPU's by "
                                     f"{(a - b).abs().max().item():.3e}")
        if abs(dl[k] - cl[k]) > 1e-4 * abs(cl[k]):
            raise AssertionError(f"lbfgs: step {k} loss {dl[k]} vs the "
                                 f"CPU's {cl[k]}")
    if not dl[-1] < dl[0]:
        raise AssertionError(f"lbfgs: loss did not fall {dl}")
    emit({"phase": "lbfgs", "dims": list(LBFGS_DIMS), "rows": LBFGS_ROWS,
          "line_search": "strong_wolfe", "losses_card": dl,
          "losses_cpu": cl})


# ------------------------------------------------ the fused generation stack
# GPT-3 6.7B (Brown et al. 2020, Table 2.1): 32 layers, d_model 4096, 32
# heads of 128, FFN 4 x 4096, GELU, pre-LN, biases, learned positions,
# GPT-2's 50,257-token vocabulary with the head tied to the embedding;
# seeded random bf16 weights made on the card (6.65 B parameters).  The
# drive follows benchmarks/bench_decode.py (:94-150): embedding (+ positions)
# -> fused_multi_transformer -> final LayerNorm -> head, a prefill into
# fixed-capacity caches, then greedy single-token steps with time_step on
# the host.
FUSED_GPT3 = dict(layers=32, dim=4096, heads=32, ffn=16384, vocab=50257,
                  positions=2048)
FUSED_DRIVE = dict(batches=(8, 1), prompt=512, max_seq=1024, steps=128,
                   checks=(1, 64, 128))
FUSED_SLICE_LAYERS = 2
FUSED_ROTARY = dict(layers=8, batch=4, prompt=256, max_seq=512, steps=16,
                    checks=(1, 16), mmha_lens=(0, 100, 257, 511))
FUSED_LAYERS_DRIVE = dict(d_model=768, nhead=12, ffn=3072, batch=32,
                          seq=128, steps=4, lr=1e-3)
FUSED_RMS_SHAPE = (8192, 4096)


def fused_frac(layers):
    """The bound on a cached decode step's logits against a fresh
    prefill of the same tokens, as a fraction of the fresh logits'
    largest magnitude (plus TOLERANCES["bfloat16"]'s rtol of each
    element): both run in bf16 through other kernels and GEMM shapes, and
    each rounds the residual stream at its 2 adds a layer, one
    TOLERANCES["bfloat16"] rtol (2**-7, two half-ulps) each, so the two
    drift apart as a random walk over 2 L roundings, relative to the
    stream: 2**-7 sqrt(2 L) / 2 (2**-5 at 32 layers, 2**-6 at 8, 2**-7
    at 2).  A wrong position, rope angle or cache slot moves the logits
    by their own scale (~20 % of the largest)."""
    return TOLERANCES["bfloat16"][0] * math.sqrt(2 * layers) / 2


def check_within(name, got, ref, frac):
    """|got - ref| <= 2**-7 |ref| + frac max|ref| elementwise; returns the
    max abs error and the bound's absolute part."""
    import torch

    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = (got - ref).abs()
    atol = frac * ref.abs().max().item()
    limit = TOLERANCES["bfloat16"][0] * ref.abs() + atol
    if not (err <= limit).all():
        raise AssertionError(f"{name}: error {err.max().item():.4e} beyond "
                             f"the bound (frac {frac:.4e}, atol "
                             f"{atol:.4e})")
    return err.max().item(), atol


class FusedGPT:
    """The generator of the fused phases, over ``incubate.nn.functional.
    fused_multi_transformer``: token embedding (+ learned positions, or
    inline rotary tables) -> the fused stack -> final LayerNorm of the
    last position -> the tied head, logits in f32 (cuBLAS's f32 output of
    the bf16 product)."""

    def __init__(self, torch, dev, layers, seed, rotary=None, batch=None,
                 max_seq=None):
        from paddle_tpu_torch.convert import FUSED_MT_WEIGHTS

        c = FUSED_GPT3
        d, f, h = c["dim"], c["ffn"], c["heads"]
        hd = d // h
        g = torch.Generator(device=dev).manual_seed(seed)
        bf = dict(device=dev, dtype=torch.bfloat16)

        def rand(shape, std):
            return torch.randn(shape, generator=g, **bf).mul_(std)

        out_std = 0.02 / math.sqrt(2 * c["layers"])
        shapes = dict(ln_scales=(d,), ln_biases=(d,),
                      qkv_weights=(3, h, hd, d), qkv_biases=(3 * d,),
                      linear_weights=(d, d), linear_biases=(d,),
                      ffn_ln_scales=(d,), ffn_ln_biases=(d,),
                      ffn1_weights=(d, f), ffn1_biases=(f,),
                      ffn2_weights=(f, d), ffn2_biases=(d,))
        std = dict(linear_weights=out_std, ffn2_weights=out_std)
        self.w = {k: [rand(shapes[k], std.get(k, 0.02)) + (
            1 if k.endswith("scales") else 0) for _ in range(layers)]
            for k in FUSED_MT_WEIGHTS}
        self.embed = rand((c["vocab"], d), 0.02)
        self.pos = None if rotary else rand((c["positions"], d), 0.01)
        self.lnf_w, self.lnf_b = rand((d,), 0.02) + 1, rand((d,), 0.02)
        self.torch, self.layers, self.kw = torch, layers, {}
        if rotary:
            inv = 1.0 / (10000.0 ** (torch.arange(
                0, hd, 2, device=dev, dtype=torch.float32) / hd))
            ang = torch.outer(torch.arange(max_seq, device=dev,
                                           dtype=torch.float32), inv)
            ang = (torch.cat([ang, ang], -1) if rotary == "neox"
                   else ang.repeat_interleave(2, -1))
            tab = torch.stack([ang.cos(), ang.sin()])[:, None, None]
            self.kw = dict(rotary_embs=tab.expand(
                2, batch, 1, max_seq, hd).contiguous(), rotary_emb_dims=1,
                use_neox_rotary_style=rotary == "neox")

    def weight_bytes(self):
        ts = [t for v in self.w.values() for t in v] + [
            self.embed, self.lnf_w, self.lnf_b] + (
            [self.pos] if self.pos is not None else [])
        return sum(t.numel() * t.element_size() for t in ts)

    def caches(self, b, max_seq):
        c = FUSED_GPT3
        return [self.torch.zeros(2, b, c["heads"], max_seq,
                                 c["dim"] // c["heads"],
                                 dtype=self.torch.bfloat16,
                                 device=self.embed.device)
                for _ in range(self.layers)]

    def __call__(self, ids, caches=None, start=0, slice_layers=None):
        """f32 logits ``[b, vocab]`` of the last position of ``ids``
        ``[b, s]`` at positions ``start...``; with ``caches`` a prefill
        into them (``start`` 0) or a decode step at ``start``."""
        from paddle_tpu_torch.incubate.nn.functional import (
            fused_multi_transformer,
        )
        from paddle_tpu_torch.nn import functional as F
        from paddle_tpu_torch.ops.fused_ce import _mm_f32

        torch = self.torch
        x = self.embed[ids]
        if self.pos is not None:
            x = x + self.pos[start:start + ids.shape[1]]
        w = self.w if slice_layers is None else {
            k: v[:slice_layers] for k, v in self.w.items()}
        kw = dict(self.kw)
        if caches is not None:
            kw["cache_kvs"] = caches
            if start:
                kw["time_step"] = torch.tensor(start)     # on the host
        out = fused_multi_transformer(x, **w, **kw)
        h = out[0] if caches is not None else out
        h = F.layer_norm(h[:, -1], [h.shape[-1]], self.lnf_w, self.lnf_b)
        return _mm_f32(h, self.embed.t())


def fused_generate(torch, model, prompt, max_seq, steps, checks, tag):
    """A prefill of ``prompt`` [b, s] into fresh caches and ``steps``
    greedy decode steps (the next token stays on the card; nothing syncs
    until the end), once untimed on caches of its own (cuBLAS's choices
    for these shapes and the allocator's blocks for every window made
    before the clock starts), then timed; then each step in ``checks``
    against a fresh prefill of the same tokens (:func:`fused_frac`), and
    the greedy token wherever the fresh top-2 gap exceeds twice the
    bound.  Returns the figures."""
    from paddle_tpu_torch.ops import kernel_launches, reset_kernel_launches

    b, s = prompt.shape
    L = model.layers

    def run():
        caches = model.caches(b, max_seq)
        torch.cuda.synchronize()
        reset_kernel_launches()
        t0 = time.perf_counter()
        logits = model(prompt, caches)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        got = kernel_launches()
        want = {"flash_fwd": L, "layer_norm": 2 * L + 1}
        if {k: v for k, v in got.items() if v} != want:
            raise AssertionError(f"{tag}: prefill launches {got}, want "
                                 f"{want}")
        launches = dict(got)
        tok = logits.argmax(-1)
        toks, saved = [tok], {}
        reset_kernel_launches()
        t0 = time.perf_counter()
        for k in range(1, steps + 1):
            logits = model(tok[:, None], caches, s + k - 1)
            if k in checks:
                saved[k] = logits
            tok = logits.argmax(-1)
            toks.append(tok)
        enqueue_s = time.perf_counter() - t0   # the host's share: no sync
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        got = kernel_launches()
        want = {"layer_norm": (2 * L + 1) * steps}
        if {k: v for k, v in got.items() if v} != want:
            raise AssertionError(f"{tag}: decode launches {got}, want "
                                 f"{want}")
        launches = {k: v + got[k] for k, v in launches.items()}
        return (caches, tok, toks, saved, launches, prefill_s, enqueue_s,
                decode_s)

    run()                                                   # warm-up
    caches, tok, toks, saved, launches, prefill_s, enqueue_s, decode_s = \
        run()
    frac = fused_frac(L)
    seq = torch.cat([prompt, torch.stack(toks, 1)], 1)
    parity = {}
    for k in checks:
        fresh = model(seq[:, :s + k])
        err, atol = check_within(f"{tag}/step{k}", saved[k], fresh, frac)
        top2 = fresh.topk(2, -1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * atol
        agree = saved[k].argmax(-1) == fresh.argmax(-1)
        if not agree[clear].all():
            raise AssertionError(f"{tag}/step{k}: greedy token differs "
                                 "where the top-2 gap exceeds the bound")
        parity[k] = {"max_abs_err": err, "atol": atol,
                     "clear_rows": int(clear.sum()),
                     "tokens_agree": int(agree.sum())}
    step = lambda: model(tok[:, None], caches, s + steps)
    prof = profiled(torch, step)
    return {"batch": b, "prompt": s, "max_seq": max_seq, "steps": steps,
            "prefill_s": prefill_s, "prefill_tokens_per_s": b * s / prefill_s,
            "decode_s": decode_s, "decode_ms_per_step": decode_s / steps * 1e3,
            "host_enqueue_ms_per_step": enqueue_s / steps * 1e3,
            "decode_tokens_per_s": b * steps / decode_s,
            "parity_frac": frac, "parity": parity,
            "distinct_tokens_row0": len(set(seq[0, s:].tolist())),
            "kernel_launches": launches,
            "profiled_step": {k: prof[k] for k in (
                "wall_ms", "device_busy_ms", "device_idle_share",
                "kernel_events", "device_ms_by_kind")}}


def fused_slice_check(torch, model, prompt):
    """A 2-layer slice of the model's widths on the kernels against its
    plain twins: every flash and LayerNorm call of the prefill held
    against the twin on the same inputs (TOLERANCES), and the slice's
    logits against the all-twin slice (:func:`fused_frac` at 2 layers)."""
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.flash_attention import flash_attention_plain
    from paddle_tpu_torch.ops.layer_norm import layer_norm_plain

    kern = IF._flash_op, IF._layer_norm_op, F._layer_norm_op
    errs = {"flash_fwd": 0.0, "layer_norm": 0.0}

    def held(name, fn, twin):
        def call(*a, **kw):
            out, ref = fn(*a, **kw), twin(*a, **kw)
            errs[name] = max(errs[name], check_close(
                f"fused_slice/{name}", out, ref, "bfloat16"))
            return out
        return call

    IF._flash_op = held("flash_fwd", kern[0], flash_attention_plain)
    IF._layer_norm_op = held("layer_norm", kern[1], layer_norm_plain)
    F._layer_norm_op = held("layer_norm", kern[2], layer_norm_plain)
    try:
        got = model(prompt, slice_layers=FUSED_SLICE_LAYERS)
        IF._flash_op = flash_attention_plain
        IF._layer_norm_op = F._layer_norm_op = layer_norm_plain
        ref = model(prompt, slice_layers=FUSED_SLICE_LAYERS)
    finally:
        IF._flash_op, IF._layer_norm_op, F._layer_norm_op = kern
    err, _ = check_within("fused_slice/logits", got, ref,
                          fused_frac(FUSED_SLICE_LAYERS))
    return {"layers": FUSED_SLICE_LAYERS, "calls_max_abs_err": errs,
            "logits_max_abs_err": err}


def fused_decode_phase(torch, dev):
    """GPT-3 6.7B at full width through fused_multi_transformer (see
    FUSED_GPT3, FUSED_DRIVE): b 8 and then b 1 prompts of 512 tokens, a
    prefill into 1024-token caches (the flash forward 32 times, the
    LayerNorm 65) and 128 greedy steps (the LayerNorm 65 times a step,
    nothing else of the port's kernels), each checked step against a
    fresh prefill; a 2-layer slice against its plain twins.  Prints the
    prefill and decode rates beside the weight-byte bound of a step, one
    profiled step's idle share and the peak memory."""
    free_device_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = FusedGPT(torch, dev, FUSED_GPT3["layers"], seed=6700)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    wbytes = model.weight_bytes()
    g = torch.Generator(device="cpu").manual_seed(6701)
    fd = FUSED_DRIVE
    prompt = torch.randint(0, FUSED_GPT3["vocab"],
                           (max(fd["batches"]), fd["prompt"]),
                           generator=g).to(dev)
    with torch.no_grad():
        runs = {}
        for b in fd["batches"]:
            runs[f"b{b}"] = fused_generate(torch, model, prompt[:b],
                                           fd["max_seq"], fd["steps"],
                                           fd["checks"], f"fused_decode/b{b}")
            free_device_memory(torch)
        slice_check = fused_slice_check(torch, model, prompt)
    kv_bytes = lambda b, t: (2 * FUSED_GPT3["layers"] * b * t
                             * FUSED_GPT3["dim"] * 2)
    bound_ms = wbytes / HBM_BYTES_PER_S * 1e3
    for key, r in runs.items():
        mid = fd["prompt"] + fd["steps"] // 2
        r["weight_bound_ms"] = bound_ms
        r["weight_kv_bound_ms"] = (wbytes + kv_bytes(r["batch"], mid)) \
            / HBM_BYTES_PER_S * 1e3
        r["bound_tokens_per_s"] = r["batch"] / (bound_ms / 1e3)
        r["share_of_weight_bound"] = bound_ms / r["decode_ms_per_step"]
    emit({"phase": "fused_decode", "model": "GPT-3 6.7B widths",
          **{k: v for k, v in FUSED_GPT3.items()}, "dtype": "bfloat16",
          "weight_gb": wbytes / 1e9, "init_s": init_s,
          "kv_cache_gb_b8": kv_bytes(8, fd["max_seq"]) / 1e9,
          "time_step_on": "host", **runs, "slice": slice_check,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    del model
    free_device_memory(torch)
    return runs[f"b{max(fd['batches'])}"]["kernel_launches"]


def mmha_check(torch, dev):
    """masked_multihead_attention at the model's widths (32 heads of
    128), b 4 at cached lengths FUSED_ROTARY["mmha_lens"] of a 512-token
    bf16 cache, an additive src_mask and NeoX tables, against the dense
    composition of the same steps: ``ops.rope.apply_rotary_emb`` at each
    row's position, the new k and v put in a copy of the cache, then
    ``nn.functional.sdpa_plain`` over keys ``<= length`` with the mask
    (TOLERANCES); the kernel-free function's cache bit for bit."""
    from paddle_tpu_torch.incubate.nn.functional import (
        masked_multihead_attention,
    )
    from paddle_tpu_torch.nn.functional import sdpa_plain
    from paddle_tpu_torch.ops.rope import apply_rotary_emb

    fr = FUSED_ROTARY
    h, d = FUSED_GPT3["heads"], FUSED_GPT3["dim"] // FUSED_GPT3["heads"]
    lens = torch.tensor(fr["mmha_lens"])
    b, t = len(fr["mmha_lens"]), fr["max_seq"]
    g = torch.Generator(device="cpu").manual_seed(6720)
    cache = torch.zeros(2, b, h, t, d, dtype=torch.bfloat16)
    for i, n in enumerate(fr["mmha_lens"]):
        cache[:, i, :, :n] = torch.randn(2, h, n, d, generator=g)
    x = torch.randn(b, 3 * h * d, generator=g).to(torch.bfloat16)
    mask = torch.zeros(b, 1, 1, t)
    mask[2, ..., 10:20] = -1e4
    mask[1] += torch.randn(1, 1, t, generator=g)
    cache, x, mask, lens = (v.to(dev) for v in (cache, x, mask, lens))
    # the tables on the card, as ops.rope makes its own there (the CPU's
    # sin and cos differ from the card's in the last ulp)
    inv = 1.0 / (10000.0 ** (torch.arange(
        0, d, 2, dtype=torch.float32, device=dev) / d))
    ang = torch.outer(torch.arange(t, dtype=torch.float32, device=dev), inv)
    ang = torch.cat([ang, ang], -1)
    tab = torch.stack([ang.cos(), ang.sin()])[:, None, None].expand(
        2, b, 1, t, d)
    ref_cache = cache.clone()
    out, got_cache = masked_multihead_attention(
        x, cache_kv=cache, src_mask=mask, sequence_lengths=lens.cpu(),
        rotary_tensor=tab, rotary_emb_dims=1, use_neox_rotary_style=True)
    qkv = x.view(b, 3, h, d)
    q, k = (apply_rotary_emb(qkv[:, j, None], position_ids=lens[:, None],
                             neox=True)[:, 0] for j in (0, 1))
    rows = torch.arange(b, device=dev)
    ref_cache[0, rows, :, lens] = k
    ref_cache[1, rows, :, lens] = qkv[:, 2]
    if not torch.equal(got_cache, ref_cache):
        raise AssertionError("mmha: the written cache differs")
    valid = torch.arange(t, device=dev)[None, :] <= lens[:, None]
    full = torch.where(valid[:, None, None, :], mask, -1e30)
    ref = sdpa_plain(q[:, None], ref_cache[0].transpose(1, 2),
                     ref_cache[1].transpose(1, 2), full)
    err = check_close("mmha/out", out, ref.reshape(b, h * d), "bfloat16")
    return {"batch": b, "heads": h, "head_dim": d, "max_seq": t,
            "lengths": list(fr["mmha_lens"]), "max_abs_err": err,
            "cache": "bitwise"}


def fused_rotary_phase(torch, dev):
    """FUSED_ROTARY: GPT-3 6.7B widths at 8 layers with inline rotary
    tables (no learned positions), NeoX and then interleaved (GPT-J)
    pairs: b 4 prompts of 256 tokens into 512-token caches, 16 greedy
    steps, each checked step against a fresh prefill
    (:func:`fused_frac` at 8 layers); then :func:`mmha_check`."""
    fr = FUSED_ROTARY
    g = torch.Generator(device="cpu").manual_seed(6711)
    prompt = torch.randint(0, FUSED_GPT3["vocab"], (fr["batch"],
                                                    fr["prompt"]),
                           generator=g).to(dev)
    runs = {}
    with torch.no_grad():
        for style in ("neox", "gptj"):
            model = FusedGPT(torch, dev, fr["layers"], seed=6712,
                             rotary=style, batch=fr["batch"],
                             max_seq=fr["max_seq"])
            runs[style] = fused_generate(
                torch, model, prompt, fr["max_seq"], fr["steps"],
                fr["checks"], f"fused_rotary/{style}")
            del model
            free_device_memory(torch)
        mmha = mmha_check(torch, dev)
    emit({"phase": "fused_rotary", "model": "GPT-3 6.7B widths",
          "layers": fr["layers"], "rotary_emb_dims": 1, **runs,
          "masked_multihead_attention": mmha})
    return runs["neox"]["kernel_launches"]


def fused_layers_phase(torch, dev):
    """FusedTransformerEncoderLayer at BERT-base width (FUSED_LAYERS_DRIVE,
    dropouts 0, post-LN, relu) against nn.TransformerEncoderLayer over the
    same weights, b 32 x s 128: output, the input's and every weight's
    gradient in f32 with TF32 off (TOLERANCES["float32"], the weights'
    fraction of the largest weight gradient); then 4 AdamW
    steps in bf16 on the kernels (LayerNorm 2 + 2, flash 1 + 1 + 1
    launches a step asserted), the loss finite and falling; then
    fused_rms_norm at FUSED_RMS_SHAPE (2-D: the RMSNorm kernel, once,
    against its plain twin) and at [8, 1024, 4096] (the default
    begin_norm_axis=1 normalizes the last two axes: no kernel)."""
    from paddle_tpu_torch import random as prandom
    from paddle_tpu_torch.incubate.nn import FusedTransformerEncoderLayer
    from paddle_tpu_torch.incubate.nn.functional import fused_rms_norm
    from paddle_tpu_torch.nn import TransformerEncoderLayer
    from paddle_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from paddle_tpu_torch.ops.rms_norm import rms_norm_plain
    from paddle_tpu_torch.optimizer import AdamW

    fl = FUSED_LAYERS_DRIVE
    e, nh, f = fl["d_model"], fl["nhead"], fl["ffn"]
    prandom.seed(7680)
    fused = FusedTransformerEncoderLayer(e, nh, f, dropout_rate=0.0,
                                         device=dev)
    ref = TransformerEncoderLayer(e, nh, f, dropout=0.0, device=dev)
    at, ff = fused.fused_attn, fused.ffn
    sa = ref.self_attn
    # q, k or v of the fused [3, heads, head_dim, E] weight as nn's
    # [in, out]
    part = lambda j: (lambda t: t[j].reshape(e, e).t())      # noqa: E731
    third = lambda j: (lambda t: t[j * e:(j + 1) * e])       # noqa: E731
    same = lambda t: t                                       # noqa: E731
    # (nn parameter, fused parameter, fused layout -> nn layout)
    pairs = [(sa.q_proj.weight, at.qkv_weight, part(0)),
             (sa.k_proj.weight, at.qkv_weight, part(1)),
             (sa.v_proj.weight, at.qkv_weight, part(2)),
             (sa.q_proj.bias, at.qkv_bias, third(0)),
             (sa.k_proj.bias, at.qkv_bias, third(1)),
             (sa.v_proj.bias, at.qkv_bias, third(2)),
             (sa.out_proj.weight, at.linear_weight, same),
             (sa.out_proj.bias, at.linear_bias, same),
             (ref.linear1.weight, ff.linear1_weight, same),
             (ref.linear1.bias, ff.linear1_bias, same),
             (ref.linear2.weight, ff.linear2_weight, same),
             (ref.linear2.bias, ff.linear2_bias, same),
             (ref.norm1.weight, at.ln_scale, same),
             (ref.norm1.bias, at.ln_bias, same),
             (ref.norm2.weight, ff.ln2_scale, same),
             (ref.norm2.bias, ff.ln2_bias, same)]
    with torch.no_grad():
        for p, fp, to_nn in pairs:
            p.copy_(to_nn(fp))
    g = torch.Generator(device="cpu").manual_seed(7681)
    x = torch.randn(fl["batch"], fl["seq"], e, generator=g).to(dev)
    gy = torch.randn(fl["batch"], fl["seq"], e, generator=g).to(dev)
    errs = {}
    with backend_flags(torch, tf32=False):
        xs = [x.clone().requires_grad_(), x.clone().requires_grad_()]
        outs = [fused(xs[0]), ref(xs[1])]
        errs["out"] = check_close("fused_layers/out", outs[0], outs[1],
                                  "float32")
        for o in outs:
            (o * gy).sum().backward()
        errs["dx"] = check_close("fused_layers/dx", xs[0].grad, xs[1].grad,
                                 "float32")
        # TOLERANCES["float32"] with its fraction taken of the layer's
        # largest gradient: the key bias's gradient is 0 up to rounding
        # (softmax ignores a shift of a query's scores), ~1e-8 here
        rtol, frac = TOLERANCES["float32"]
        scale = max(p.grad.abs().max().item() for p, _, _ in pairs)
        errs["weight_grads"] = 0.0
        for i, (p, fp, to_nn) in enumerate(pairs):
            err = (to_nn(fp.grad) - p.grad).abs()
            if not (err <= rtol * p.grad.abs() + frac * scale).all():
                raise AssertionError(f"fused_layers/grad{i}: error "
                                     f"{err.max().item():.3e} beyond "
                                     f"rtol {rtol} + {frac} of the "
                                     f"largest gradient {scale:.3e}")
            errs["weight_grads"] = max(errs["weight_grads"],
                                       err.max().item())
    # bf16 training on the kernels
    net = copy.deepcopy(fused).to(torch.bfloat16)
    opt = AdamW(learning_rate=fl["lr"], parameters=net.parameters(),
                multi_precision=True, device=dev)
    xb = x.to(torch.bfloat16)
    target = torch.randn(fl["batch"], fl["seq"], e, generator=g).to(dev)
    losses, step_s, launches = [], [], {}
    want = {"layer_norm": 2, "layer_norm_bwd": 2, "flash_fwd": 1,
            "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    for step in range(fl["steps"]):
        torch.cuda.synchronize()
        reset_kernel_launches()
        t0 = time.perf_counter()
        loss = (net(xb).float() - target).square().mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
        step_s.append(time.perf_counter() - t0)
        got = {k: v for k, v in kernel_launches().items() if v}
        if got != want:
            raise AssertionError(f"fused_layers: step {step} launched "
                                 f"{got}, want {want}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"fused_layers: losses {losses}")
    # fused_rms_norm: the kernel for a 2-D input, not for a 3-D one
    xr = torch.randn(*FUSED_RMS_SHAPE, generator=g).to(torch.bfloat16) \
        .to(dev)
    wr = (1 + 0.1 * torch.randn(FUSED_RMS_SHAPE[1], generator=g)).to(
        torch.bfloat16).to(dev)
    reset_kernel_launches()
    yr = fused_rms_norm(xr, wr)
    if kernel_launches()["rms_norm"] != 1:
        raise AssertionError("fused_rms_norm: a 2-D input did not launch "
                             "the RMSNorm kernel once")
    rms_err = check_close("fused_rms_norm", yr, rms_norm_plain(xr, wr),
                          "bfloat16")
    y3 = fused_rms_norm(xr.view(8, -1, FUSED_RMS_SHAPE[1]), wr)
    if kernel_launches()["rms_norm"] != 1 or not torch.isfinite(y3).all():
        raise AssertionError("fused_rms_norm: a 3-D input at "
                             "begin_norm_axis=1 reached the kernel")
    launches["rms_norm"] = 1
    emit({"phase": "fused_layers", "layer": "FusedTransformerEncoderLayer",
          **fl, "parity_f32_max_abs_err": errs, "losses": losses,
          "step_s": step_s, "launches_per_step": want,
          "fused_rms_norm": {"shape": list(FUSED_RMS_SHAPE),
                             "max_abs_err": rms_err,
                             "3d_default_axis_launches": 0}})
    del fused, ref, net, opt
    free_device_memory(torch)
    return launches


# ---------------------------------------------------------- phases 23-26
# MobileNetV3-Large (Howard et al. 2019, Table 1: 15 bneck blocks, 8 of
# them with squeeze-excite, hardswish in the last 11 and the stem) at its
# published width (scale 1.0) and input (224 px), bf16, trained as
# resnet_train is: Momentum(0.9), cross-entropy on the f32 logits, the
# rate 0.1 a 256 images (Goyal et al. 2017) at b 128
ZOO_BATCH, ZOO_PX, ZOO_CLASSES = 128, 224, 1000
ZOO_WARMUP, ZOO_TIMED = 2, 4
ZOO_LR, ZOO_MOMENTUM = 0.1 * ZOO_BATCH / 256, 0.9
# zoo_forward: every constructor but the nine ResNets at its published
# input, bf16 b 8 (LeNet takes 1 x 28 x 28, Inception-v3 299 px)
ZOO_FORWARD_BATCH = 8
ZOO_FORWARD = (
    "LeNet", "alexnet", "vgg11", "vgg13", "vgg16", "vgg19", "squeezenet1_0",
    "squeezenet1_1", "mobilenet_v1", "mobilenet_v2", "mobilenet_v3_small",
    "mobilenet_v3_large", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
    "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
    "shufflenet_v2_x2_0", "densenet121", "densenet161", "densenet169",
    "densenet201", "densenet264", "googlenet", "inception_v3")
# zoo_parity: each family's flagship, b 2 eval logits on the card in f32
# (TF32 off) against the CPU in f64: both sum the same products in other
# orders in f32 and f64, ~1e-6 of the logits' norm; ZOO_LOGIT_TOL leaves
# two orders of margin and a wrong layer moves them by far more
ZOO_PARITY = (("LeNet", {}), ("alexnet", {}), ("vgg16", {"batch_norm": True}),
              ("squeezenet1_1", {}), ("mobilenet_v1", {}),
              ("mobilenet_v2", {}), ("mobilenet_v3_large", {}),
              ("shufflenet_v2_x1_0", {}), ("densenet121", {}),
              ("googlenet", {}), ("inception_v3", {}))
ZOO_PARITY_BATCH, ZOO_LOGIT_TOL = 2, 1e-4
# zoo_parity's MobileNetV3-Large step.  In f64 the card and the CPU
# compute the same function to ~1e-9 of each tensor (the card's f64 run
# held within ZOO_F64_TOL).  In f32 one activation can land on the other
# side of a hardswish kink (x = +-3, where its derivative jumps by 0.5)
# than in f64: on an H100, one of the 131,712 inputs of
# features.13.block.1.act crossed it on the card and none on the CPU, and
# that one element moved every gradient below it by 2-5e-3 of its norm.
# So the f32 step is held to GRAD_PARITY_FACTOR x the CPU f32's error plus
# ZOO_GRAD_FLOOR, and the crossings are counted
ZOO_F64_TOL, ZOO_GRAD_FLOOR = 1e-8, 1e-2
# vision_ops: a detection head's calls at Faster R-CNN's sizes (a
# stride-4 FPN level of an 800 x 1216 image: [2, 256, 200, 304]; 1,000
# RoIs of 16-400 px, 7 x 7 bins; NMS over 2,000 boxes of 80 categories
# keeping 1,000), and the resizes of a [8, 256, 64, 64] map
OPS_MAP, OPS_SCALE, OPS_ROIS, OPS_BINS = (2, 256, 200, 304), 0.25, 1000, 7
OPS_NMS_BOXES, OPS_NMS_CLASSES, OPS_NMS_TOP_K = 2000, 80, 1000
OPS_RESIZE = (8, 256, 64, 64)


def zoo_model(torch, name, dev, dtype=None, seed=0, **kw):
    """The zoo constructor ``name`` at its published width (1,000
    classes; LeNet's 10) on ``dev``."""
    from paddle_tpu_torch.vision import models

    classes = 10 if name == "LeNet" else ZOO_CLASSES
    return getattr(models, name)(num_classes=classes, device=dev,
                                 dtype=dtype, seed=seed, **kw)


def zoo_input_shape(name, batch):
    if name == "LeNet":
        return (batch, 1, 28, 28)
    px = 299 if name == "inception_v3" else ZOO_PX
    return (batch, 3, px, px)


def zoo_train_phase(torch, dev):
    """MobileNetV3-Large (1,000 classes, 224 px) training in bf16
    through jit.TrainStep with Momentum: 2 warm-up and 4 timed steps,
    the losses finite, every BatchNorm buffer moved and finite; images/s,
    step seconds, model FLOP/s (``hapi.flops``: 3 x the forward), one
    profiled step's idle share and top kernels, peak memory.  Returns the
    port kernels' launches (none lies on this path)."""
    import numpy as np

    from paddle_tpu_torch import flops as hapi_flops
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from paddle_tpu_torch.optimizer import Momentum

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = zoo_model(torch, "mobilenet_v3_large", dev).to(torch.bfloat16)
    model.train()
    opt = Momentum(learning_rate=ZOO_LR, momentum=ZOO_MOMENTUM,
                   parameters=model.named_parameters(), device=dev)
    step = TrainStep(model, resnet_loss, opt, device=dev)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(ZOO_BATCH, 3, ZOO_PX, ZOO_PX).astype(
        np.float32)).to(dev, torch.bfloat16)
    y = torch.from_numpy(rng.randint(0, ZOO_CLASSES, ZOO_BATCH)).to(dev)
    flops = 3 * hapi_flops(model, [ZOO_BATCH, 3, ZOO_PX, ZOO_PX])
    buffers0 = {n: b.clone() for n, b in model.named_buffers()}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    with backend_flags(torch, benchmark=True) as flags:
        losses = [step(x, y).item() for _ in range(ZOO_WARMUP)]
        step_s = []
        reset_kernel_launches()
        for _ in range(ZOO_TIMED):
            t1 = time.perf_counter()
            losses.append(step(x, y).item())      # .item() synchronises
            step_s.append(time.perf_counter() - t1)
        launches = kernel_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        prof = resnet_profile(torch, step, opt, (x, y))
    if any(launches.values()):
        raise AssertionError(f"zoo_train: a port kernel ran on a path that "
                             f"reaches none {launches}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"zoo_train: non-finite loss {losses}")
    for n, b in model.named_buffers():
        if torch.equal(b, buffers0[n]) or not torch.isfinite(b).all():
            raise AssertionError(f"zoo_train: buffer {n} did not move or "
                                 "is not finite")
    mean_s = sum(step_s) / len(step_s)
    emit({"phase": "zoo_train",
          "model": "mobilenet_v3_large(num_classes=1000), scale 1.0",
          "dtype": "bfloat16", "batch": ZOO_BATCH,
          "image": [3, ZOO_PX, ZOO_PX],
          "optimizer": f"Momentum({ZOO_LR}, {ZOO_MOMENTUM})",
          "backend_flags": flags,
          "params": sum(p.numel() for p in model.parameters()),
          "setup_s": setup_s, "losses": losses, "step_s": step_s,
          "step_s_mean": mean_s, "step_s_range": [min(step_s), max(step_s)],
          "images_per_s": ZOO_BATCH / mean_s,
          "model_flops_per_step": flops,
          "model_flops_formula": "3 x hapi.flops of the forward",
          "model_tflops_per_s": flops / mean_s / 1e12,
          "mfu_of_989": flops / mean_s / 989e12,
          "peak_memory_gb": peak_gb, "kernel_launches": launches})
    emit(dict(prof, phase="zoo_train_profile", steps=1))
    del step, opt, model, x, y
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def zoo_forward_phase(torch, dev):
    """Every zoo constructor but the ResNets (ZOO_FORWARD) at its
    published width and input, bf16 b 8 on the card: one eval forward
    (the logits' shape, finite; eval images/s over a second, timed
    forward) and one train-mode forward and backward (finite, every
    parameter with a finite gradient; GoogLeNet's two aux heads in the
    loss)."""
    from paddle_tpu_torch.nn import functional as F

    report = {}
    for i, name in enumerate(ZOO_FORWARD):
        t0 = time.perf_counter()
        model = zoo_model(torch, name, dev, torch.bfloat16, seed=i)
        shape = zoo_input_shape(name, ZOO_FORWARD_BATCH)
        x = torch.randn(shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(i)).to(torch.bfloat16)
        classes = 10 if name == "LeNet" else ZOO_CLASSES
        model.eval()
        with torch.no_grad():
            model(x)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits = model(x)
            torch.cuda.synchronize()
            eval_s = time.perf_counter() - t1
        if tuple(logits.shape) != (ZOO_FORWARD_BATCH, classes) or \
                not torch.isfinite(logits).all():
            raise AssertionError(f"zoo_forward {name}: logits "
                                 f"{tuple(logits.shape)}, finite "
                                 f"{bool(torch.isfinite(logits).all())}")
        model.train()
        out = model(x)
        outs = out if isinstance(out, tuple) else (out,)
        y = torch.arange(ZOO_FORWARD_BATCH, device=dev) % classes
        loss = sum(F.cross_entropy(o.float(), y) for o in outs)
        loss.backward()
        bad = [n for n, p in model.named_parameters()
               if p.grad is None or not torch.isfinite(p.grad).all()]
        if not math.isfinite(loss.item()) or bad:
            raise AssertionError(f"zoo_forward {name}: loss {loss.item()}, "
                                 f"parameters without a finite gradient "
                                 f"{bad[:4]}")
        report[name] = {"input": list(shape),
                        "params": sum(p.numel() for p in model.parameters()),
                        "eval_images_per_s": ZOO_FORWARD_BATCH / eval_s,
                        "train_outputs": len(outs), "loss": loss.item(),
                        "seconds": time.perf_counter() - t0}
        del model, x, logits, out, outs, loss
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "zoo_forward", "dtype": "bfloat16",
          "batch": ZOO_FORWARD_BATCH, "models": report})


def zoo_numpy_state(model, seed):
    """A ``state_dict`` of ``model``'s keys in the JAX models' layout
    (Linear weights [in, out]) from one numpy seed: convolutions and
    their biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)), Linear weights
    Xavier-normal and biases 0, BatchNorm weights U(0.5, 1.5), biases and
    running means N(0, 0.1^2), running variances U(0.5, 1.5)."""
    import numpy as np

    from paddle_tpu_torch.nn import Conv2D, Linear

    rng = np.random.RandomState(seed)
    kinds = {}
    for name, m in model.named_modules():
        for leaf in ("weight", "bias", "_mean", "_variance"):
            kinds[f"{name}.{leaf}"] = (type(m), leaf, m)
    state = {}
    for key, t in model.state_dict().items():
        kind, leaf, m = kinds[key]
        shape = tuple(t.shape)
        if kind is Linear and leaf == "weight":
            fan_in, fan_out = shape
            a = rng.randn(fan_in, fan_out) * math.sqrt(2.0 / (fan_in
                                                              + fan_out))
        elif kind is Linear:
            a = np.zeros(shape)
        elif kind is Conv2D:
            a = rng.uniform(-1, 1, shape) / math.sqrt(
                math.prod(m.weight.shape[1:]))
        elif leaf in ("weight", "_variance"):
            a = rng.uniform(0.5, 1.5, shape)
        else:
            a = rng.randn(*shape) * 0.1
        state[key] = a.astype(np.float32)
    return state


def zoo_parity_phase(torch, dev):
    """Each family's flagship (ZOO_PARITY) with weights from one numpy
    seed through convert.state_from_jax: b 2 eval logits on the
    card in f32 (TF32 off) against the CPU in f64, within ZOO_LOGIT_TOL
    of the f64 logits' norm.  Then MobileNetV3-Large one Momentum step (b
    4, the head's Dropout at 0: its masks come from the card's stream)
    on the card in f64 and f32, the CPU in f32 and in f64 (the truth):
    the logits, the loss, every gradient, parameter and buffer after it,
    norm-wise (a gradient that is 0 in exact arithmetic against the
    gradients' global norm, as grad_parity's zero_truth): the card's f64
    within ZOO_F64_TOL, its f32 within GRAD_PARITY_FACTOR of the CPU
    f32's error plus ZOO_GRAD_FLOOR (see there); the hardswish inputs
    that f32 puts across a kink are counted."""
    import numpy as np

    from paddle_tpu_torch.convert import state_from_jax
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import Hardswish
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum

    def build(name, kw, where, dtype, state=None):
        model = zoo_model(torch, name, where, dtype, **kw)
        if state is None:
            state = zoo_numpy_state(model, 1234)
        model.load_state_dict(state_from_jax(state, model, device=where,
                                             dtype=dtype))
        return model, state

    def rel(got, ref):
        return ((got.double().cpu() - ref).norm()
                / max(ref.norm().item(), 1e-30)).item()

    logits_err = {}
    with backend_flags(torch, tf32=False, benchmark=False) as flags:
        for i, (name, kw) in enumerate(ZOO_PARITY):
            x = torch.from_numpy(np.random.RandomState(i).randn(
                *zoo_input_shape(name, ZOO_PARITY_BATCH)).astype(np.float32))
            ref_model, state = build(name, kw, "cpu", torch.float64)
            card_model, _ = build(name, kw, dev, torch.float32, state)
            with torch.no_grad():
                ref = ref_model.eval()(x.double())
                got = card_model.eval()(x.to(dev))
            logits_err[name] = rel(got, ref)
            if not logits_err[name] <= ZOO_LOGIT_TOL:
                raise AssertionError(f"zoo_parity {name}: card f32 logits "
                                     f"{logits_err[name]:.3e} from the CPU "
                                     f"f64, beyond {ZOO_LOGIT_TOL}")
            del ref_model, card_model
        x = torch.from_numpy(np.random.RandomState(7).randn(
            4, 3, ZOO_PX, ZOO_PX).astype(np.float32))
        y = torch.from_numpy(np.random.RandomState(8).randint(
            0, ZOO_CLASSES, 4))
        state = None

        def step_run(where, dtype):
            nonlocal state
            model, state = build("mobilenet_v3_large", {}, where, dtype,
                                 state)
            model.classifier[2].p = 0.0
            model.train()
            opt = Momentum(learning_rate=ZOO_LR, momentum=ZOO_MOMENTUM,
                           parameters=model.named_parameters(),
                           device=where)
            grads, acts = {}, {}
            for n, p in model.named_parameters():
                p.register_post_accumulate_grad_hook(
                    lambda p, n=n: grads.__setitem__(
                        n, p.grad.detach().clone()))
            for n, m in model.named_modules():
                if isinstance(m, Hardswish):
                    m.register_forward_hook(
                        lambda m, i, o, n=n: acts.__setitem__(
                            n, i[0].detach()))

            def loss_aux(net, a, lbl):      # in the run's dtype (f32, f64)
                logits = net(a)
                return F.cross_entropy(logits, lbl), logits

            tstep = TrainStep(model, loss_aux, opt, has_aux=True,
                              device=where)
            loss, logits = tstep(x.to(where, dtype), y.to(where))
            out = {"loss": loss, "logits": logits}
            out.update({"grad." + n: g for n, g in grads.items()})
            out.update(model.state_dict())
            out.update({"act." + n: a for n, a in acts.items()})
            return {k: v.detach().to("cpu", torch.float64)
                    for k, v in out.items()}

        truth = step_run("cpu", torch.float64)
        cpu32 = step_run("cpu", torch.float32)
        card32 = step_run(dev, torch.float32)
        card64 = step_run(dev, torch.float64)
    # a gradient that is 0 in exact arithmetic (a BatchNorm bias whose
    # shift the next train-mode BatchNorm subtracts again) is rounding
    # noise on every path: its error is taken relative to the global
    # norm of the f64 gradients, as grad_parity's zero_truth
    total = math.sqrt(sum(v.norm().item() ** 2 for k, v in truth.items()
                          if k.startswith("grad.")))
    zero = {k for k, v in truth.items() if k.startswith("grad.")
            and v.norm().item() <= 1e-9 * total}

    def err(got, k):
        ref = truth[k]
        return ((got[k] - ref).norm().item() / total if k in zero
                else rel(got[k], ref))

    e_card = {k: err(card32, k) for k in truth}
    e_cpu = {k: err(cpu32, k) for k in truth}
    e_card64 = {k: err(card64, k) for k in truth}
    failed = [f"f64 {k}: card {e_card64[k]:.3e} > {ZOO_F64_TOL}"
              for k in truth if not e_card64[k] <= ZOO_F64_TOL]
    failed += [f"f32 {k}: card {e_card[k]:.3e} > {GRAD_PARITY_FACTOR} x "
               f"CPU {e_cpu[k]:.3e} + {ZOO_GRAD_FLOOR}" for k in truth
               if not (math.isfinite(e_card[k]) and e_card[k]
                       <= GRAD_PARITY_FACTOR * e_cpu[k] + ZOO_GRAD_FLOOR)]
    if failed:
        raise AssertionError(f"zoo_parity: {len(failed)} tensors of the "
                             f"MobileNetV3-Large step out of tolerance: "
                             f"{failed[:12]}")
    crossings = {}
    for tag, got in (("card_f32", card32), ("cpu_f32", cpu32)):
        crossings[tag] = {k[4:]: n for k, v in truth.items()
                          if k.startswith("act.") for n in [int(sum(
                              (torch.sign(got[k] - c) != torch.sign(v - c))
                              .sum().item() for c in (3.0, -3.0)))] if n}
    emit({"phase": "zoo_parity", "backend_flags": flags,
          "eval_logits_rel_err_card_f32_vs_cpu_f64": logits_err,
          "eval_tolerance": ZOO_LOGIT_TOL,
          "step_model": "mobilenet_v3_large(num_classes=1000), b4 x 224",
          "step_tensors_checked": len(truth),
          "step_worst_card_f64": max(e_card64.items(), key=lambda kv: kv[1]),
          "step_f64_tolerance": ZOO_F64_TOL,
          "hardswish_kink_crossings_against_f64": crossings,
          "step_zero_truth_gradients": sorted(k[5:] for k in zero),
          "step_rule": f"f32: card err <= {GRAD_PARITY_FACTOR} x CPU f32 "
                       f"err + {ZOO_GRAD_FLOOR}; f64: card err <= "
                       f"{ZOO_F64_TOL}; norm-wise against the CPU f64",
          "step_loss": {"f64": truth["loss"].item(),
                        "card_f32": card32["loss"].item()},
          "step_worst_card": max(e_card.items(), key=lambda kv: kv[1]),
          "step_worst_cpu_f32": max(e_cpu.items(), key=lambda kv: kv[1])})


def detection_inputs(torch, seed):
    """vision_ops' inputs on the CPU: the feature map, 1,000 RoIs split
    between the two images, 2,000 NMS boxes with scores and categories,
    in image pixels (800 x 1216)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    n, _, h, w = OPS_MAP
    feat = torch.from_numpy(rng.randn(*OPS_MAP).astype(np.float32))

    def boxes(k, lo, hi):
        wh = rng.uniform(lo, hi, (k, 2))
        xy = rng.uniform(0, 1, (k, 2)) * ([w / OPS_SCALE, h / OPS_SCALE]
                                         - wh)
        return torch.from_numpy(np.concatenate([xy, xy + wh], 1).astype(
            np.float32))

    rois = boxes(OPS_ROIS, 16, 400)
    num = torch.tensor([OPS_ROIS // 2, OPS_ROIS - OPS_ROIS // 2],
                       dtype=torch.int32)
    nms_boxes = boxes(OPS_NMS_BOXES, 8, 300)
    scores = torch.from_numpy(rng.uniform(0, 1, OPS_NMS_BOXES).astype(
        np.float32))
    cats = torch.from_numpy(rng.randint(0, OPS_NMS_CLASSES, OPS_NMS_BOXES))
    return feat, rois, num, nms_boxes, scores, cats


def vision_ops_phase(torch, dev):
    """``vision.ops`` and the resizes on the card against the same calls
    on the CPU, each with its CUDA-event ms: nms (2,000 boxes, 80
    categories, top_k 1,000; indices equal exactly), roi_align (sampling
    ratios 2 and -1) and roi_pool over 1,000 RoIs of the [2, 256, 200,
    304] map, 7 x 7, within TOLERANCES['float32'] (and their gradients'
    time); box_coder's encode and decode, the round trip giving the
    targets back; grid_sample and interpolate (bilinear x 2 with and
    without aligned corners, nearest, bicubic) on [8, 256, 64, 64]."""
    import numpy as np

    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.vision import ops

    feat, rois, num, nboxes, scores, cats = detection_inputs(torch, 0)
    card = [t.to(dev) for t in (feat, rois, num, nboxes, scores, cats)]
    report = {}

    def both(name, fn, cpu_args, card_args, exact=False, reps=5):
        ref = fn(*cpu_args)
        got = fn(*card_args)
        if exact:
            if not torch.equal(got.cpu(), ref):
                raise AssertionError(f"vision_ops {name}: the card's "
                                     "result differs from the CPU's")
            err = 0.0
        else:
            err = check_close(f"vision_ops {name}", got.cpu(), ref,
                              "float32")
        report[name] = {"ms": cuda_ms(lambda: fn(*card_args), reps),
                        "max_abs_err": err, "shape": list(got.shape)}
        return got

    kept = both("nms", lambda b, s, c: ops.nms(
        b, 0.5, s, c, list(range(OPS_NMS_CLASSES)), OPS_NMS_TOP_K),
        (nboxes, scores, cats), card[3:], exact=True)
    report["nms"]["kept"] = int(kept.numel())
    for name, kw in (("roi_align/sampling2", dict(sampling_ratio=2)),
                     ("roi_align/sampling-1", dict(sampling_ratio=-1))):
        both(name, lambda f, r, k, kw=kw: ops.roi_align(
            f, r, k, OPS_BINS, OPS_SCALE, **kw), (feat, rois, num),
            card[:3])
    both("roi_pool", lambda f, r, k: ops.roi_pool(
        f, r, k, OPS_BINS, OPS_SCALE), (feat, rois, num), card[:3])
    fmap = card[0].clone().requires_grad_()
    for name, fn in (("roi_align/backward", lambda: ops.roi_align(
            fmap, card[1], card[2], OPS_BINS, OPS_SCALE, 2)),
                     ("roi_pool/backward", lambda: ops.roi_pool(
                         fmap, card[1], card[2], OPS_BINS, OPS_SCALE))):
        out = fn()
        report[name] = {"ms": cuda_ms(lambda: torch.autograd.grad(
            fn().sum(), fmap), 3)}
        del out
    priors, targets = nboxes[:OPS_ROIS], rois
    var = torch.tensor([0.1, 0.1, 0.2, 0.2])
    enc = both("box_coder/encode", lambda p, v, t: ops.box_coder(p, v, t),
               (priors, var, targets), (card[3][:OPS_ROIS], var.to(dev),
                                        card[1]))
    dec = both("box_coder/decode", lambda p, v, d: ops.box_coder(
        p, v, d, code_type="decode_center_size"),
        (priors, var, enc.cpu()), (card[3][:OPS_ROIS], var.to(dev), enc))
    check_close("vision_ops box_coder round trip", dec,
                card[1][:, None, :].expand_as(dec), "float32")
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(*OPS_RESIZE).astype(np.float32))
    grid = torch.from_numpy(rng.uniform(-1.1, 1.1, (OPS_RESIZE[0], 64, 64,
                                                   2)).astype(np.float32))
    both("grid_sample/bilinear", lambda a, g: F.grid_sample(a, g),
         (x, grid), (x.to(dev), grid.to(dev)))
    for name, kw in (("bilinear_x2", dict(scale_factor=2,
                                          mode="bilinear")),
                     ("bilinear_x2_corners", dict(
                         scale_factor=2, mode="bilinear",
                         align_corners=True)),
                     ("nearest_x2", dict(scale_factor=2, mode="nearest")),
                     ("bicubic_x2", dict(scale_factor=2, mode="bicubic")),
                     ("bilinear_down", dict(size=[32, 32],
                                            mode="bilinear"))):
        both(f"interpolate/{name}", lambda a, kw=kw: F.interpolate(a, **kw),
             (x,), (x.to(dev),))
    emit({"phase": "vision_ops", "map": list(OPS_MAP), "rois": OPS_ROIS,
          "bins": OPS_BINS, "nms_boxes": OPS_NMS_BOXES,
          "resize_input": list(OPS_RESIZE),
          "tolerance": f"TOLERANCES['float32'] {TOLERANCES['float32']}; "
                       "nms indices exact", "ops": report})

# ------------------------------------------------------------ phases 27-30
# PaddleNLP's attention seq2seq (examples/machine_translation/seq2seq) at
# its IWSLT'15 English-Vietnamese widths; synthetic token ids from a seed
S2S = dict(src_vocab=17191, trg_vocab=7709, hidden=512, layers=2,
           dropout=0.2, batch=128, seq=50, lr=0.001, clip=5.0, beam=10,
           max_steps=100, bos=1, eos=2, init_scale=0.1)
S2S_WARMUP, S2S_TIMED = 2, 4
S2S_TURNS = ("fused", "loop", "loop", "fused")
S2S_PARITY_BATCH = 4
S2S_PARITY_BEAM_STEPS = 30          # the f64 beam decode on both sides
S2S_TIE_VOCAB_GRID = 16             # logits on a 1/16 grid: bf16 values


def seq2seq_model(torch, dev, dtype=None, dropout=None):
    """The attention seq2seq from the port's public layers, as a user
    builds it: ``nn.Embedding`` -> ``nn.LSTM`` encoder; a decoder cell
    (``nn.RNNCellBase``) of two ``nn.LSTMCell`` with input feeding and
    dot-product attention over the projected encoder outputs, masked by
    ``sequence_mask``, ``Linear(1024 -> 512)`` after it; the vocabulary
    projection; teacher forcing through ``nn.RNN``, beam search through
    ``nn.BeamSearchDecoder`` and ``nn.dynamic_decode`` over encoder
    outputs tiled by ``tile_beam_merge_with_batch``.  Dropout on the
    embeddings.  The cell's state is the flat tuple ``(h0, c0, h1, c1,
    feed)``."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch import tensor as T
    from paddle_tpu_torch.nn import functional as F

    c = S2S
    hidden, layers, vt = c["hidden"], c["layers"], c["trg_vocab"]
    kw = dict(device=dev, dtype=dtype)
    p = c["dropout"] if dropout is None else dropout

    class AttentionCell(nn.RNNCellBase):
        def __init__(self):
            super().__init__()
            self.hidden_size = hidden
            self.cells = nn.LayerList([
                nn.LSTMCell(2 * hidden if i == 0 else hidden, hidden, **kw)
                for i in range(layers)])
            self.input_proj = nn.Linear(hidden, hidden, bias_attr=False,
                                        **kw)
            self.output_proj = nn.Linear(2 * hidden, hidden,
                                         bias_attr=False, **kw)
            self.mem = {}

        def forward(self, x, states):
            inp = T.concat([x, states[-1]], axis=1)
            new = []
            for i, cell in enumerate(self.cells):
                inp, (h, cst) = cell(inp, (states[2 * i], states[2 * i + 1]))
                new += [h, cst]
            scores = T.matmul(T.unsqueeze(inp, [1]), self.mem["keys"],
                              transpose_y=True) + self.mem["bias"]
            attn = F.softmax(scores, axis=-1)
            ctx = T.squeeze(T.matmul(attn, self.mem["keys"]), [1])
            out = self.output_proj(T.concat([ctx, inp], axis=1))
            return out, tuple(new) + (out,)

    class Seq2Seq(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.src_emb = nn.Embedding(c["src_vocab"], hidden, **kw)
            self.trg_emb = nn.Embedding(vt, hidden, **kw)
            self.dropout = nn.Dropout(p)
            self.encoder = nn.LSTM(hidden, hidden, num_layers=layers, **kw)
            self.decoder = nn.RNN(AttentionCell())
            self.output_layer = nn.Linear(hidden, vt, bias_attr=False, **kw)

        def encode(self, src, src_len, beam=None):
            enc, (h, cst) = self.encoder(self.dropout(self.src_emb(src)))
            mask = F.sequence_mask(src_len, maxlen=src.shape[1],
                                   dtype=str(enc.dtype).split(".")[1])
            cell = self.decoder.cell
            keys = cell.input_proj(enc)
            bias = T.unsqueeze((mask - 1.0) * 1e9, [1])
            if beam:
                tile = nn.BeamSearchDecoder.tile_beam_merge_with_batch
                keys, bias = tile(keys, beam), tile(bias, beam)
            cell.mem.update(keys=keys, bias=bias)
            feed = cell.get_initial_states(batch_ref=enc, dtype=enc.dtype)
            return tuple(s for i in range(layers)
                         for s in (h[i], cst[i])) + (feed,)

        def forward(self, src, src_len, trg_in):
            states = self.encode(src, src_len)
            out, _ = self.decoder(self.dropout(self.trg_emb(trg_in)),
                                  states)
            return self.output_layer(out)

        def beam_search(self, src, src_len, beam, max_steps, decoder=None):
            states = self.encode(src, src_len, beam)
            dec = decoder or nn.BeamSearchDecoder(
                self.decoder.cell, c["bos"], c["eos"], beam,
                embedding_fn=self.trg_emb, output_fn=self.output_layer)
            return nn.dynamic_decode(dec, states, max_step_num=max_steps,
                                     return_length=True)

    return Seq2Seq()


def seq2seq_loss(net, src, src_len, trg_in, trg_out, trg_len, aux=False):
    """PaddleNLP's criterion: token cross-entropy masked by the target
    lengths, summed over time and averaged over the batch."""
    from paddle_tpu_torch import tensor as T
    from paddle_tpu_torch.nn import functional as F

    logits = net(src, src_len, trg_in)
    ce = F.cross_entropy(T.reshape(logits, [-1, logits.shape[-1]]),
                         T.reshape(trg_out, [-1]), reduction="none")
    mask = F.sequence_mask(trg_len, maxlen=trg_out.shape[1],
                           dtype=str(logits.dtype).split(".")[1])
    loss = T.sum(T.reshape(ce, mask.shape) * mask) / src.shape[0]
    return (loss, logits) if aux else loss


def seq2seq_batch(torch, b, seed, dev):
    """``(src, src_len, trg_in, trg_out, trg_len)``: ids from a seed,
    lengths from a fifth of the sequence to all of it, on ``dev``."""
    import numpy as np

    c = S2S
    rng = np.random.RandomState(seed)
    src = rng.randint(3, c["src_vocab"], (b, c["seq"]))
    trg = rng.randint(3, c["trg_vocab"], (b, c["seq"] + 1))
    trg[:, 0] = c["bos"]
    src_len = rng.randint(c["seq"] // 5, c["seq"] + 1, b)
    trg_len = rng.randint(c["seq"] // 5, c["seq"] + 1, b)
    out = (src, src_len, trg[:, :-1], trg[:, 1:], trg_len)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
        dev, torch.int64) for a in out)


def seq2seq_numpy_state(model, seed):
    """The JAX package's state dict of the same model, as numpy: every
    weight ``Uniform(-0.1, 0.1)`` (PaddleNLP's ``init_scale``) from one
    ``RandomState``, ``Linear`` weights in paddle's ``[in, out]``."""
    import numpy as np

    rng = np.random.RandomState(seed)
    out = {}
    for k, v in model.state_dict().items():
        s = S2S["init_scale"]
        out[k] = rng.uniform(-s, s, tuple(v.shape)).astype(np.float32)
    return out


def seq2seq_train_phase(torch, dev):
    """The full-width seq2seq training in f32 through jit.TrainStep with
    Adam(0.001) and ClipGradByGlobalNorm(5.0), batch 128 x 50: 2 warm-up
    and 4 timed steps, finite losses; target tokens/s, step seconds,
    peak memory, the TF32 flags; one profiled step (idle share, kernel
    launches, top kernels); then, in turns in this call, the encoder's
    forward + backward on the cuDNN route against the step loop, and the
    decoder's nn.RNN forward + backward with its own profile.  Returns
    the port kernels' launches (none lies on this path)."""
    from paddle_tpu_torch import random as prandom
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from paddle_tpu_torch.optimizer import Adam

    c = S2S
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prandom.seed(0)
    model = seq2seq_model(torch, dev)
    model.train()
    opt = Adam(c["lr"], parameters=model.named_parameters(),
               grad_clip=ClipGradByGlobalNorm(c["clip"]), device=dev)
    step = TrainStep(model, seq2seq_loss, opt, device=dev)
    batch = seq2seq_batch(torch, c["batch"], 0, dev)
    tokens = int(batch[4].sum())
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    with backend_flags(torch) as flags:
        losses = [step(*batch).item() for _ in range(S2S_WARMUP)]
        step_s = []
        reset_kernel_launches()
        for _ in range(S2S_TIMED):
            t1 = time.perf_counter()
            losses.append(step(*batch).item())    # .item() synchronises
            step_s.append(time.perf_counter() - t1)
        launches = kernel_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        prof = profiled(torch, lambda: step(*batch))

        # the encoder alone, cuDNN against the step loop, in turns
        src, src_len, trg_in = batch[:3]
        x = model.src_emb(src).detach().requires_grad_()

        def enc_run():
            out, (h, cst) = model.encoder(x)
            (out.sum() + h.sum() + cst.sum()).backward()

        enc_s = {"fused": [], "loop": []}
        for route in ("fused", "loop"):
            model.encoder.route = route
            enc_run()                                  # warm
        for route in S2S_TURNS:
            model.encoder.route = route
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            enc_run()
            torch.cuda.synchronize()
            enc_s[route].append(time.perf_counter() - t1)
        enc_prof = {}
        for route in ("fused", "loop"):
            model.encoder.route = route
            ep = profiled(torch, enc_run)
            enc_prof[route] = {k: ep[k] for k in (
                "kernel_events", "device_busy_ms", "device_idle_share")}
            enc_prof[route]["top_kernels_ms"] = ep["top_kernels_ms"][:4]
        model.encoder.route = None

        # the decoder's teacher-forced nn.RNN, forward + backward
        with torch.no_grad():
            states = model.encode(src, batch[1])
            y = model.trg_emb(trg_in)
        states = tuple(s.detach().requires_grad_() for s in states)
        y = y.detach().requires_grad_()

        def dec_run():
            out, _ = model.decoder(y, states)
            out.sum().backward()

        dec_run()
        dec_s = []
        for _ in range(2):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            dec_run()
            torch.cuda.synchronize()
            dec_s.append(time.perf_counter() - t1)
        dec_prof = profiled(torch, dec_run)
    if any(launches.values()):
        raise AssertionError(f"seq2seq_train: a port kernel ran on a path "
                             f"that reaches none {launches}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"seq2seq_train: non-finite loss {losses}")
    mean_s = sum(step_s) / len(step_s)
    emit({"phase": "seq2seq_train",
          "model": "attention LSTM seq2seq, PaddleNLP machine_translation/"
                   "seq2seq at IWSLT'15 en-vi widths",
          "config": c, "dtype": "float32", "backend_flags": flags,
          "params": sum(p.numel() for p in model.parameters()),
          "setup_s": setup_s, "losses": losses, "step_s": step_s,
          "step_s_mean": mean_s, "step_s_range": [min(step_s), max(step_s)],
          "target_tokens_per_step": tokens,
          "target_tokens_per_s": tokens / mean_s,
          "peak_memory_gb": peak_gb, "kernel_launches": launches,
          "encoder_fwd_bwd_s": enc_s,
          "encoder_loop_over_fused": (sum(enc_s["loop"])
                                      / sum(enc_s["fused"])),
          "encoder_profiles": enc_prof,
          "decoder_rnn_fwd_bwd_s": dec_s,
          "decoder_rnn_kernel_launches": dec_prof["kernel_events"],
          "decoder_rnn_idle_share": dec_prof["device_idle_share"]})
    emit(dict(prof, phase="seq2seq_train_profile", steps=1))
    emit(dict(dec_prof, phase="seq2seq_decoder_rnn_profile"))
    del step, opt, model, batch, states, y, x
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def seq2seq_decode_phase(torch, dev):
    """Beam search at full width: beam 10 over 128 sources,
    max_step_num 100, f32, eval; steps, ms a step, the host's share of a
    step (the profiled decode's device-idle share), hypotheses' tokens/s,
    peak memory; the ids in the vocabulary, the lengths within the
    steps."""
    from paddle_tpu_torch import random as prandom

    c = S2S
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prandom.seed(1)
    model = seq2seq_model(torch, dev)
    model.eval()
    src, src_len = seq2seq_batch(torch, c["batch"], 1, dev)[:2]
    with torch.no_grad():
        model.beam_search(src[:2], src_len[:2], c["beam"], 2)   # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, _, lengths = model.beam_search(src, src_len, c["beam"],
                                            c["max_steps"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        prof = profiled(torch, lambda: model.beam_search(
            src, src_len, c["beam"], c["max_steps"]))
    steps = ids.shape[1]
    if tuple(ids.shape) != (c["batch"], steps, c["beam"]):
        raise AssertionError(f"seq2seq_decode: ids {tuple(ids.shape)}")
    if not (0 <= int(ids.min()) and int(ids.max()) < c["trg_vocab"]):
        raise AssertionError("seq2seq_decode: an id outside the vocabulary")
    if not (0 <= int(lengths.min()) and int(lengths.max()) <= steps):
        raise AssertionError("seq2seq_decode: lengths outside the steps")
    hyp_tokens = int(lengths.sum())
    emit({"phase": "seq2seq_decode", "beam": c["beam"],
          "sources": c["batch"], "max_step_num": c["max_steps"],
          "steps": steps, "wall_s": wall, "ms_per_step": wall / steps * 1e3,
          "host_share_of_step": prof["device_idle_share"],
          "host_share_rule": "the profiled decode's device-idle share "
                             "(an upper bound: the profiler slows the host)",
          "kernel_launches_per_step": prof["kernel_events"] / steps,
          "hypothesis_tokens": hyp_tokens,
          "hypothesis_tokens_per_s": hyp_tokens / wall,
          "finished_beams": int((lengths < steps).sum()),
          "peak_memory_gb": peak_gb})
    emit(dict(prof, phase="seq2seq_decode_profile"))
    del model
    gc.collect()
    torch.cuda.empty_cache()


class RecordingDecoder:
    """A beam decoder whose every step's tokens and parents are kept
    (``dynamic_decode`` returns only the backtraced ids)."""

    def __init__(self, dec):
        self.dec = dec
        self.beam_size = dec.beam_size
        self.tokens, self.parents = [], []

    def initialize(self, states):
        return self.dec.initialize(states)

    def step(self, time_, inputs, states, batch):
        out = self.dec.step(time_, inputs, states, batch)
        self.tokens.append(out[0].cpu())
        self.parents.append(out[1].cpu())
        return out


def beam_tie_step(torch, dev, b, beam, vocab, seed):
    """One beam step at full width whose logits lie on a 1/16 grid (bf16
    values: many equal) and whose running log-probs are multiples of 8
    with repeats, some beams finished: ``(token, parent, log_probs,
    finished)`` on ``dev``, moved to the CPU.  Each source's beams share
    one logits row, so its log-softmax shift is common to them and the
    ties are exact on any device."""
    import numpy as np

    from paddle_tpu_torch import nn

    rng = np.random.RandomState(seed)
    logits = np.clip(np.round(rng.randn(b, vocab) * S2S_TIE_VOCAB_GRID)
                     / S2S_TIE_VOCAB_GRID, -4, 4).astype(np.float32)
    lp = (-8.0 * rng.randint(0, 3, (b, beam))).astype(np.float32)
    fin = rng.rand(b, beam) < 0.2
    table = torch.from_numpy(logits).to(dev)

    def cell(src_rows, states):
        return table[src_rows], states

    dec = nn.BeamSearchDecoder(cell, S2S["bos"], S2S["eos"], beam)
    rows = torch.arange(b, device=dev).repeat_interleave(beam)
    states = (rows, torch.from_numpy(lp).to(dev),
              torch.from_numpy(fin).to(dev))
    out = dec.step(0, rows, states, b)
    return [out[i].cpu() for i in (0, 1, 2, 5)]


def seq2seq_parity_phase(torch, dev):
    """Weights from one numpy seed through convert.state_from_jax
    at full width, batch 4, dropout 0: one TrainStep (Adam, clip) on the
    card in f32 with TF32 off, the CPU in f32 and the CPU in f64 (the
    truth): logits, loss, every gradient and every parameter after the
    step, the card's error within GRAD_PARITY_FACTOR of the CPU f32's
    plus GRAD_PARITY_FLOOR (resnet_parity's rule, norm-wise).  Then a
    beam decode (beam 10) in f64 on the card and the CPU: every step's
    tokens and parents, the ids and the lengths equal exactly.  Then a
    full-width beam step on tied bf16-valued log-probs (beam_tie_step):
    tokens, parents and finished flags equal exactly."""
    from paddle_tpu_torch.convert import state_from_jax
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import BeamSearchDecoder, ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import Adam

    c = S2S
    probe = seq2seq_model(torch, "cpu", dropout=0.0)
    state = seq2seq_numpy_state(probe, 1234)
    del probe
    batch = seq2seq_batch(torch, S2S_PARITY_BATCH, 5, "cpu")

    def build(where, dtype):
        model = seq2seq_model(torch, where, dtype, dropout=0.0)
        model.load_state_dict(state_from_jax(state, model, device=where,
                                             dtype=dtype))
        return model

    def run(where, dtype):
        model = build(where, dtype)
        model.train()
        opt = Adam(c["lr"], parameters=model.named_parameters(),
                   grad_clip=ClipGradByGlobalNorm(c["clip"]), device=where)
        grads = {}
        for n, p in model.named_parameters():
            p.register_post_accumulate_grad_hook(
                lambda p, n=n: grads.__setitem__(n, p.grad.detach().clone()))
        step = TrainStep(model, lambda net, *b: seq2seq_loss(
            net, *b, aux=True), opt, has_aux=True, device=where)
        loss, logits = step(*[t.to(where) for t in batch])
        out = {"loss": loss, "logits": logits}
        out.update({"grad." + n: g for n, g in grads.items()})
        out.update(model.state_dict())
        return {k: v.detach().to("cpu", torch.float64)
                for k, v in out.items()}

    with backend_flags(torch, tf32=False) as flags:
        truth = run("cpu", torch.float64)
        cpu32 = run("cpu", torch.float32)
        card32 = run(dev, torch.float32)

    def errors(got):
        return {k: ((got[k] - ref).norm() / max(ref.norm().item(), 1e-30)
                    ).item() for k, ref in truth.items()}

    e_card, e_cpu = errors(card32), errors(cpu32)
    failed = [f"{k}: card {e_card[k]:.3e} > {GRAD_PARITY_FACTOR} x CPU "
              f"{e_cpu[k]:.3e} + {GRAD_PARITY_FLOOR}" for k in truth
              if not (math.isfinite(e_card[k]) and e_card[k]
                      <= GRAD_PARITY_FACTOR * e_cpu[k] + GRAD_PARITY_FLOOR)]
    if failed:
        raise AssertionError(f"seq2seq_parity: {len(failed)} tensors out of "
                             f"tolerance: {failed[:12]}")

    def decode(where):
        model = build(where, torch.float64)
        model.eval()
        rec = RecordingDecoder(BeamSearchDecoder(
            model.decoder.cell, c["bos"], c["eos"], c["beam"],
            embedding_fn=model.trg_emb, output_fn=model.output_layer))
        with torch.no_grad():
            ids, _, lengths = model.beam_search(
                batch[0].to(where), batch[1].to(where), c["beam"],
                S2S_PARITY_BEAM_STEPS, decoder=rec)
        return (ids.cpu(), lengths.cpu(), torch.stack(rec.tokens),
                torch.stack(rec.parents))

    with backend_flags(torch, tf32=False):
        card_dec, cpu_dec = decode(dev), decode("cpu")
    for name, a, b in zip(("ids", "lengths", "tokens", "parents"),
                          card_dec, cpu_dec):
        if not torch.equal(a, b):
            raise AssertionError(f"seq2seq_parity: the f64 beam decode's "
                                 f"{name} differ between card and CPU")
    card_tie = beam_tie_step(torch, dev, c["batch"], c["beam"],
                             c["trg_vocab"], 9)
    cpu_tie = beam_tie_step(torch, "cpu", c["batch"], c["beam"],
                            c["trg_vocab"], 9)
    for name, a, b in zip(("token", "parent", "log_probs", "finished"),
                          card_tie, cpu_tie):
        if name != "log_probs" and not torch.equal(a, b):
            raise AssertionError(f"seq2seq_parity: the tied beam step's "
                                 f"{name} differ between card and CPU")
    lp_diff = (card_tie[2] - cpu_tie[2]).abs().max().item()
    ties = int((cpu_tie[2][:, 1:] == cpu_tie[2][:, :-1]).sum())
    grads = [k for k in truth if k.startswith("grad.")]
    emit({"phase": "seq2seq_parity", "batch": S2S_PARITY_BATCH,
          "backend_flags": flags, "tensors_checked": len(truth),
          "rule": f"card err <= {GRAD_PARITY_FACTOR} x CPU f32 err + "
                  f"{GRAD_PARITY_FLOOR}, norm-wise against the CPU f64",
          "loss": {"f64": truth["loss"].item(),
                   "card_f32": card32["loss"].item()},
          "logits_err": {"card_f32": e_card["logits"],
                         "cpu_f32": e_cpu["logits"]},
          "worst_card": max(e_card.items(), key=lambda kv: kv[1]),
          "worst_cpu": max(e_cpu.items(), key=lambda kv: kv[1]),
          "worst_grad_card": max(((k, e_card[k]) for k in grads),
                                 key=lambda kv: kv[1]),
          "beam_f64": {"steps": int(card_dec[2].shape[0]),
                       "ids_equal": True, "parents_equal": True,
                       "lengths": card_dec[1].tolist()},
          "tied_step": {"batch": c["batch"], "beam": c["beam"],
                        "vocab": c["trg_vocab"],
                        "equal_adjacent_log_probs": ties,
                        "tokens_parents_finished_equal": True,
                        "log_probs_max_abs_diff": lp_diff}})


# the tensor surface's card-against-CPU table: float outputs within
# SURFACE_TOL of the CPU's largest magnitude (SURFACE_SPECIAL_TOL for the
# special functions and the decompositions' invariants); integer and bool
# outputs (indices, counts, ties included) equal exactly
SURFACE_TOL = 1e-5
SURFACE_SPECIAL_TOL = 1e-4
SURFACE_SHAPE = (64, 128)
# the timed calls: shapes from the issue of this slice (ms by CUDA events)
SURFACE_LINALG_SHAPE = (64, 256, 256)
SURFACE_EIG_SHAPE = (8, 128, 128)
SURFACE_STFT = dict(shape=(32, 160000), n_fft=512, hop=160)
SURFACE_FFT2_SHAPE = (64, 512, 512)
SURFACE_SORT_SHAPE = (4096, 32000)
SURFACE_MULTINOMIAL_SHAPE = (128, 32000)


def surface_cases(torch):
    """``{module: {name: (fn, args, tol)}}`` over every name each ported
    module exports: ``fn(device, *args)`` runs the port's function on
    ``args`` moved to ``device``.  Random draws are held to their shapes,
    dtypes and ranges (``fn`` returns those), not to the CPU's values:
    each device has its own generator."""
    import importlib

    import numpy as np

    from paddle_tpu_torch import fft as FFT
    from paddle_tpu_torch import signal as SIG
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.tensor import (attribute, creation, linalg, logic,
                                         math as M, random as R, search,
                                         stat)

    EIN = importlib.import_module("paddle_tpu_torch.tensor.einsum")
    rng = np.random.RandomState(0)

    def f(*s, lo=-2.0, hi=2.0):
        return torch.from_numpy(rng.uniform(lo, hi, s).astype(np.float32))

    sh = SURFACE_SHAPE
    x, y, v = f(*sh), f(*sh), f(sh[1])
    pos, unit, near1 = f(*sh, lo=0.5, hi=2.0), f(*sh, lo=-0.9, hi=0.9), \
        f(*sh, lo=0.95, hi=1.05)
    ints = torch.from_numpy(rng.randint(-50, 50, sh).astype(np.int32))
    pints = torch.from_numpy(rng.randint(1, 50, sh).astype(np.int32))
    ties = torch.from_numpy(rng.randint(0, 8, sh).astype(np.float32))
    sq = f(16, 16) + 8 * torch.eye(16)
    spd = sq @ sq.T
    cplx = torch.complex(f(16, 32), f(16, 32))
    sig = f(4, 4000)
    win = torch.hann_window(256)
    nanx = x.clone()
    nanx[::3, ::5] = float("nan")
    S, X = SURFACE_SPECIAL_TOL, SURFACE_TOL
    cases = {m: {} for m in ("creation", "math", "logic", "attribute",
                             "stat", "einsum", "search", "linalg", "random",
                             "fft", "signal", "nn.functional")}

    def add(mod, name, fn, args=(), tol=X):
        cases[mod][name] = (fn, args, tol)

    # creation
    for n, call in {
            "zeros": lambda d: creation.zeros([3, 5], device=d),
            "ones": lambda d: creation.ones([4], "int32", device=d),
            "full": lambda d: (creation.full([3], 7, device=d),
                               creation.full([2, 2], True, device=d),
                               creation.full([2], 1.5, device=d)),
            "empty": lambda d: creation.empty([2, 3], device=d),
            "arange": lambda d: (creation.arange(10, device=d),
                                 creation.arange(0.0, 1.0, 0.1, device=d)),
            "linspace": lambda d: creation.linspace(-3.0, 7.0, 33, device=d),
            "logspace": lambda d: creation.logspace(0.0, 3.0, 17,
                                                    device=d),
            "eye": lambda d: creation.eye(5, 7, device=d),
            "tril_indices": lambda d: creation.tril_indices(9, 7, -1,
                                                            device=d),
            "triu_indices": lambda d: creation.triu_indices(8, 8, 2,
                                                            device=d)}.items():
        add("creation", n, call)
    for n, call in {
            "zeros_like": lambda d, a: creation.zeros_like(a),
            "ones_like": lambda d, a: creation.ones_like(a, "int32"),
            "full_like": lambda d, a: creation.full_like(a, 2.5),
            "empty_like": lambda d, a: creation.empty_like(a),
            "tril": lambda d, a: creation.tril(a, 3),
            "triu": lambda d, a: creation.triu(a, -2),
            "diag": lambda d, a: (creation.diag(a), creation.diag(
                a[0], 2, 1.5)),
            "diagflat": lambda d, a: creation.diagflat(a[:4, :4], -1),
            "diag_embed": lambda d, a: (creation.diag_embed(a[:3, :5], 1),
                                        creation.diag_embed(a[:3, :5], -2)),
            "assign": lambda d, a: creation.assign(a),
            "clone": lambda d, a: creation.clone(a),
            "meshgrid": lambda d, a: creation.meshgrid(a[0], a[1, :9]),
            "complex": lambda d, a: creation.complex(a, a * 2),
            "polar": lambda d, a: creation.polar(a.abs(), a)}.items():
        add("creation", n, call, (x,))
    add("creation", "one_hot", lambda d, i: creation.one_hot(i, 60),
        (pints,))
    # math: unary, binary, reductions and the rest
    for n in ("sqrt", "rsqrt", "log", "log2", "log10", "reciprocal",
              "lgamma", "gammaln", "digamma"):
        add("math", n, lambda d, a, n=n: getattr(M, n)(a), (pos,),
            S if "gamma" in n else X)
    for n in ("asin", "acos", "atanh", "erfinv", "logit"):
        add("math", n, lambda d, a, n=n: getattr(M, n)(
            a.abs() if n == "logit" else a), (unit,), S)
    for n in ("square", "exp", "expm1", "log1p", "abs", "neg", "negative",
              "sign", "sgn", "sin", "cos", "tan", "atan", "sinh", "cosh",
              "tanh", "asinh", "floor", "ceil", "round", "trunc", "frac",
              "sigmoid", "logsigmoid", "erf", "i0", "i0e", "i1", "i1e",
              "angle", "conj", "real", "imag", "deg2rad", "rad2deg", "isnan",
              "isinf", "isfinite", "signbit", "positive", "stanh",
              "nan_to_num", "frexp"):
        add("math", n, lambda d, a, n=n: getattr(M, n)(
            a.abs() if n == "log1p" else a), (x,),
            S if n.startswith("i") and n[1:2].isdigit() else X)
    add("math", "acosh", lambda d, a: M.acosh(a + 1.0), (pos,))
    add("math", "polygamma", lambda d, a: (M.polygamma(a, 1),
                                           M.polygamma(a, 2)), (pos,), S)
    for n in ("add", "subtract", "multiply", "divide", "floor_divide",
              "remainder", "mod", "floor_mod", "pow", "maximum", "minimum",
              "fmax", "fmin", "atan2", "hypot", "heaviside", "nextafter",
              "copysign", "ldexp", "logaddexp", "gammainc", "gammaincc"):
        add("math", n, lambda d, a, b, n=n: (getattr(M, n)(a, b),
                                             getattr(M, n)(a, 1.5)),
            (pos, near1), S if "gamma" in n else X)
    for n in ("gcd", "lcm"):
        add("math", n, lambda d, a, b, n=n: getattr(M, n)(a, b),
            (pints, pints.flip(0)))
    add("math", "clip", lambda d, a: M.clip(a, -0.5, 1.0), (x,))
    add("math", "scale", lambda d, a: M.scale(a, 2.0, 0.5, False), (x,))
    add("math", "lerp", lambda d, a, b: M.lerp(a, b, 0.3), (x, y))
    for n in ("sum", "nansum", "mean", "nanmean", "max", "min", "amax",
              "amin", "std", "var", "logsumexp", "count_nonzero"):
        add("math", n, lambda d, a, n=n: (getattr(M, n)(a), getattr(M, n)(
            a, 1, keepdim=True), getattr(M, n)(a, [0, 1])), (x,))
    add("math", "prod", lambda d, a: (M.prod(a, 1), M.prod(a[:4])),
        (near1,))
    for n in ("cumsum", "cumprod", "logcumsumexp", "cummax", "cummin"):
        add("math", n, lambda d, a, n=n: (getattr(M, n)(a, 1),
                                          getattr(M, n)(a[:8])), (near1,))
    add("math", "cummax", lambda d, a, t: (M.cummax(a, 1), M.cummax(t, 1),
                                           M.cummin(t, 0)), (near1, ties))
    add("math", "diff", lambda d, a: (M.diff(a), M.diff(a, 2, 0, 1.0)),
        (x,))
    add("math", "trace", lambda d, a: (M.trace(a), M.trace(a, 3)), (x,))
    add("math", "add_n", lambda d, a, b: M.add_n([a, b, a]), (x, y))
    for n, call in {
            "matmul": lambda d, a, b: M.matmul(a, b, False, True),
            "mm": lambda d, a, b: M.mm(a, b.T),
            "bmm": lambda d, a, b: M.bmm(a.reshape(4, 16, 128),
                                         b.reshape(4, 128, 16)),
            "dot": lambda d, a, b: M.dot(a, b),
            "inner": lambda d, a, b: M.inner(a[:4], b[:5]),
            "outer": lambda d, a, b: M.outer(a[0], b[1]),
            "kron": lambda d, a, b: M.kron(a[:3, :4], b[:2, :5]),
            "mv": lambda d, a, b: M.mv(a, b[0]),
            "addmm": lambda d, a, b: M.addmm(a[:, :64], a, b.T[:, :64], 0.5,
                                             2.0),
            "cross": lambda d, a, b: M.cross(a[:, :3], b[:, :3]),
            "allclose": lambda d, a, b: (M.allclose(a, a), M.allclose(a, b)),
            "isclose": lambda d, a, b: M.isclose(a, b, 0.5, 0.2),
            "equal_all": lambda d, a, b: (M.equal_all(a, a.clone()),
                                          M.equal_all(a, b)),
            "multiplex": lambda d, a, b: M.multiplex(
                [a, b], (torch.arange(a.shape[0], device=a.device) % 2)[
                    :, None]),
            "trapezoid": lambda d, a, b: (M.trapezoid(a), M.trapezoid(
                a, b.cumsum(1))),
            "cumulative_trapezoid": lambda d, a, b: M.cumulative_trapezoid(
                a, dx=0.25),
            "vander": lambda d, a, b: M.vander(a[0, :8] / 2),
            "renorm": lambda d, a, b: M.renorm(a, 2.0, 0, 5.0),
            "dist": lambda d, a, b: (M.dist(a, b), M.dist(a, b, 1),
                                     M.dist(a, b, float("inf"))),
            "inverse": lambda d, a, b: M.inverse(sq.to(a.device))}.items():
        add("math", n, call, (x, y))
    add("math", "bincount", lambda d, i, w: (M.bincount(i.reshape(-1)),
                                             M.bincount(i.reshape(-1), w)),
        (pints, pos.reshape(-1)))
    add("math", "combinations", lambda d, a: M.combinations(a[0, :9], 3),
        (x,))
    add("math", "increment", lambda d, a: M.increment(a.clone(), 2.0),
        (x,))
    # logic
    for n in ("equal", "not_equal", "greater_than", "greater_equal",
              "less_than", "less_equal", "logical_and", "logical_or",
              "logical_xor", "bitwise_and", "bitwise_or", "bitwise_xor",
              "bitwise_left_shift", "bitwise_right_shift"):
        add("logic", n, lambda d, a, b, n=n: getattr(logic, n)(
            a, (b % 4) if "shift" in n else b), (ints, ints.flip(1)))
    for n in ("logical_not", "bitwise_not"):
        add("logic", n, lambda d, a, n=n: getattr(logic, n)(a), (ints,))
    for n in ("all", "any"):
        add("logic", n, lambda d, a, n=n: (getattr(logic, n)(a > -1.9),
                                           getattr(logic, n)(a > 1.9, 1,
                                                             True)), (x,))
    add("logic", "is_empty", lambda d, a: (logic.is_empty(a),
                                           logic.is_empty(a[:0])), (x,))
    add("logic", "is_tensor", lambda d, a: torch.tensor(logic.is_tensor(a)),
        (x,))
    add("logic", "in_dynamic_mode",
        lambda d: torch.tensor(logic.in_dynamic_mode()))
    # attribute, stat, einsum
    for n in ("shape", "rank", "numel"):
        add("attribute", n, lambda d, a, n=n: getattr(attribute, n)(a), (x,))
    for n in ("is_complex", "is_floating_point", "is_integer"):
        add("attribute", n, lambda d, a, i, n=n: torch.tensor(
            [getattr(attribute, n)(a), getattr(attribute, n)(i)]),
            (x, ints))
    for n in ("mean", "std", "var", "nansum", "nanmean", "median",
              "nanmedian", "quantile", "numel"):
        add("stat", n, lambda d, a, n=n: getattr(stat, n)(
            a, 0.3, 1) if n == "quantile" else getattr(stat, n)(a), (nanx
                                                                 if "nan" in n
                                                                 else x,))
    add("einsum", "einsum", lambda d, a, b: (
        EIN.einsum("ij,kj->ik", a, b), EIN.einsum("ii->i", a[:, :64]),
        EIN.einsum("bij,bjk->bik", a.reshape(4, 16, 128),
                   b.reshape(4, 128, 16))), (x, y))
    # search, ties planted
    add("search", "argmax", lambda d, a: (search.argmax(a),
                                          search.argmax(a, 1, True)), (ties,))
    add("search", "argmin", lambda d, a: (search.argmin(a),
                                          search.argmin(a, 0)), (ties,))
    add("search", "argsort", lambda d, a: (search.argsort(a, 1),
                                           search.argsort(a, 0, True)),
        (ties,))
    add("search", "sort", lambda d, a: (search.sort(a, 1, True),
                                        search.sort(a, 0)), (ties,))
    add("search", "topk", lambda d, a: (search.topk(a, 5), search.topk(
        a, 7, 0, False)), (ties,))
    add("search", "kthvalue", lambda d, a: (search.kthvalue(a, 9),
                                            search.kthvalue(a, 3, 0, True)),
        (ties,))
    add("search", "mode", lambda d, a: (search.mode(a), search.mode(a, 0)),
        (ties,))
    add("search", "searchsorted", lambda d, a, b: search.searchsorted(
        a.sort(1).values, b, right=True), (x, y))
    add("search", "bucketize", lambda d, a, b: search.bucketize(
        b, a[0].sort().values), (x, y))
    for n in ("median", "nanmedian"):
        add("search", n, lambda d, a, n=n: (getattr(search, n)(a, 1),
                                            getattr(search, n)(a)),
            (nanx if n == "nanmedian" else x,))
    for n in ("quantile", "nanquantile"):
        add("search", n, lambda d, a, n=n: tuple(
            getattr(search, n)(a, [0.1, 0.5, 0.9], 1, False, m)
            for m in ("linear", "lower", "higher", "midpoint", "nearest")),
            (nanx if n == "nanquantile" else x,))
    add("search", "histogram", lambda d, a: (search.histogram(a, 37),
                                             search.histogram(a, 9, -1.0,
                                                              1.0)), (x,))
    add("search", "histogramdd", lambda d, a: search.histogramdd(
        a[:, :2], 5), (x,))
    # linalg: values and what is unique of each factorisation
    add("linalg", "norm", lambda d, a: (
        linalg.norm(a), linalg.norm(a, 1, 1), linalg.norm(a[:16, :16],
                                                          "nuc", (0, 1))),
        (x,), S)
    add("linalg", "vector_norm", lambda d, a: linalg.vector_norm(a, 3.0, 1),
        (x,))
    add("linalg", "matrix_norm", lambda d, a: linalg.matrix_norm(a), (x,))
    for n in ("cond", "det", "inv", "matrix_exp", "svdvals", "eigvalsh"):
        add("linalg", n, lambda d, a, n=n: getattr(linalg, n)(
            a if n != "matrix_exp" else a / 32), (spd,), S)
    add("linalg", "slogdet", lambda d, a: linalg.slogdet(a), (sq,), S)
    add("linalg", "pinv", lambda d, a: linalg.pinv(a[:20, :12]), (x,), S)
    add("linalg", "matrix_power", lambda d, a: linalg.matrix_power(a / 8, 3),
        (sq,), S)
    add("linalg", "matrix_rank", lambda d, a: (linalg.matrix_rank(a),
                                               linalg.matrix_rank(
                                                   a[:8] @ a[:8].T)), (x,))
    add("linalg", "multi_dot", lambda d, a, b: linalg.multi_dot(
        [a, b.T, a]), (x, y), S)
    for n in ("matmul", "dot", "cross"):
        add("linalg", n, lambda d, a, b, n=n: getattr(linalg, n)(
            a, b.T) if n == "matmul" else getattr(linalg, n)(
            a[:, :3], b[:, :3]), (x, y))
    add("linalg", "corrcoef", lambda d, a: linalg.corrcoef(a[:8]), (x,))
    add("linalg", "cov", lambda d, a: linalg.cov(a[:8], False), (x,))
    add("linalg", "cdist", lambda d, a, b: (linalg.cdist(a[:20], b[:30]),
                                            linalg.cdist(a[:20], b[:30], 1.0)),
        (x, y))
    add("linalg", "pdist", lambda d, a: linalg.pdist(a[:20]), (x,))
    add("linalg", "solve", lambda d, a, b: linalg.solve(a, b[:16, :5]),
        (sq, x), S)
    add("linalg", "triangular_solve", lambda d, a, b: (
        linalg.triangular_solve(a.triu(), b[:16, :5]),
        linalg.triangular_solve(a.tril(), b[:16, :5], False, True)),
        (sq, x), S)
    add("linalg", "cholesky", lambda d, a: linalg.cholesky(a), (spd,), S)
    add("linalg", "cholesky_solve", lambda d, a, b: linalg.cholesky_solve(
        b[:16, :4], linalg.cholesky(a)), (spd, x), S)

    def mt(a):
        return a.transpose(-1, -2)

    add("linalg", "svd", lambda d, a: (lambda u, s, vh: (
        s, (u * s[..., None, :]) @ vh, mt(u) @ u))(*linalg.svd(a[:20, :12])),
        (x,), S)
    add("linalg", "qr", lambda d, a: (lambda q, r: (q @ r, mt(q) @ q,
                                                    r.abs()))(
        *linalg.qr(a[:20, :12])), (x,), S)
    add("linalg", "eigh", lambda d, a: (lambda w, v: (
        w, (v * w[..., None, :]) @ mt(v)))(*linalg.eigh(a)), (spd,), S)
    add("linalg", "eig", lambda d, a: (lambda w, v: (
        torch.sort(w).values, torch.tensor(bool(
            (a @ v - v * w).abs().amax() < 1e-3 * a.abs().amax()))))(
        *linalg.eig(a)), (spd,), S)
    add("linalg", "eigvals", lambda d, a: torch.sort(
        linalg.eigvals(a)).values, (spd,), S)
    add("linalg", "lstsq", lambda d, a, b: linalg.lstsq(
        a[:20, :6] @ a[:6, :12] / 4, b[:20, :3]), (x, y), S)
    add("linalg", "lu", lambda d, a: (lambda lu, p: (
        (lambda P, L, U: P @ L @ U)(*linalg.lu_unpack(lu, p))))(
        *linalg.lu(a)), (sq,), S)
    add("linalg", "lu_unpack", lambda d, a: linalg.lu_unpack(
        *linalg.lu(a.tril() + 8 * torch.eye(16, device=a.device)))[1:],
        (sq,), S)
    add("linalg", "householder_product", lambda d, a, t: (
        linalg.householder_product(a[:8, :4], t[0, :4]),
        linalg.ormqr(a[:8, :4], t[0, :4], a[:8, :3])), (x, unit), S)
    add("linalg", "ormqr", lambda d, a, t: linalg.ormqr(
        a[:8, :4], t[0, :4], a[:3, :8], left=False, transpose=True),
        (x, unit), S)
    add("linalg", "pca_lowrank", lambda d, a: (lambda u, s, v: (
        s, (u * s[..., None, :]) @ mt(v)))(*linalg.pca_lowrank(
            a[:20, :6] @ a[:6, :12], 6, False)), (x,), S)
    add("linalg", "svd_lowrank", lambda d, a: (lambda u, s, v: (
        s, (u * s[..., None, :]) @ mt(v)))(*linalg.svd_lowrank(
            a[:20, :3] @ a[:3, :12], 3)), (x,), S)
    # random: shapes, dtypes and ranges (each device draws its own bits)

    def drawn(*outs):
        return [torch.tensor(list(o.shape) + [
            o.element_size(), int(o.is_floating_point()),
            int(bool(o.min() >= lo)), int(bool(o.max() < hi))])
            for o, lo, hi in outs]

    for n, call in {
            "rand": lambda d: drawn((R.rand([9, 7], device=d), 0, 1)),
            "randn": lambda d: drawn((R.randn([9], device=d), -9, 9)),
            "standard_normal": lambda d: drawn(
                (R.standard_normal([3, 3], device=d), -9, 9)),
            "normal": lambda d: drawn((R.normal(5.0, 0.1, [40], device=d),
                                       4, 6)),
            "uniform": lambda d: drawn((R.uniform([50], min=-3.0, max=-1.0,
                                                  device=d), -3, -1)),
            "randint": lambda d: drawn((R.randint(2, 9, [60], device=d),
                                        2, 9)),
            "randperm": lambda d: [R.randperm(40, device=d).sort().values],
            "multinomial": lambda d: drawn((R.multinomial(torch.tensor(
                [[0.0, 0.5, 0.5]], device=d), 20, True), 1, 3)),
            "bernoulli": lambda d: drawn((R.bernoulli(torch.full(
                [50], 0.5, device=d)), 0, 2)),
            "poisson": lambda d: drawn((R.poisson(torch.full(
                [50], 3.0, device=d)), 0, 99)),
            "rand_like": lambda d: drawn((R.rand_like(torch.zeros(
                4, device=d)), 0, 1)),
            "randn_like": lambda d: drawn((R.randn_like(torch.zeros(
                4, device=d)), -9, 9)),
            "randint_like": lambda d: drawn((R.randint_like(torch.zeros(
                5, dtype=torch.int32, device=d), 0, 3), 0, 3)),
            "uniform_": lambda d: drawn((R.uniform_(torch.zeros(
                30, device=d), 1.0, 2.0), 1, 2)),
            "bernoulli_": lambda d: drawn((R.bernoulli_(torch.zeros(
                30, device=d), 0.5), 0, 2)),
            "exponential_": lambda d: drawn((R.exponential_(torch.zeros(
                30, device=d)), 0, 99)),
            "normal_": lambda d: drawn((R.normal_(torch.zeros(
                30, device=d), 10.0, 0.1), 9, 11)),
            "gumbel_softmax": lambda d: drawn((R.gumbel_softmax(torch.zeros(
                5, 6, device=d), hard=True), 0, 1.01))}.items():
        add("random", n, call)
    # fft and signal
    for n in ("fft", "ifft", "hfft", "irfft"):
        add("fft", n, lambda d, c, n=n: tuple(
            getattr(FFT, n)(c, 40, 0, nm) for nm in ("backward", "ortho",
                                                     "forward")), (cplx,))
    for n in ("rfft", "ihfft"):
        add("fft", n, lambda d, a, n=n: tuple(
            getattr(FFT, n)(a, None, 1, nm) for nm in ("backward", "ortho",
                                                       "forward")), (x,))
    for n in ("fft2", "ifft2", "fftn", "ifftn", "irfft2", "irfftn"):
        add("fft", n, lambda d, c, n=n: getattr(FFT, n)(c), (cplx,))
    for n in ("rfft2", "rfftn"):
        add("fft", n, lambda d, a, n=n: getattr(FFT, n)(a, norm="ortho"),
            (x,))
    add("fft", "fftfreq", lambda d: FFT.fftfreq(64, 0.5, device=d))
    add("fft", "rfftfreq", lambda d: FFT.rfftfreq(64, device=d))
    add("fft", "fftshift", lambda d, a: FFT.fftshift(a), (x,))
    add("fft", "ifftshift", lambda d, a: FFT.ifftshift(a, [1]), (x,))
    add("signal", "stft", lambda d, a, w: (
        SIG.stft(a, 256, 64, window=w),
        SIG.stft(a, 256, 100, 200, w[28:228], pad_mode="constant",
                 normalized=True, onesided=False)), (sig, win))
    add("signal", "istft", lambda d, a, w: SIG.istft(
        SIG.stft(a, 256, 64, window=w), 256, 64, window=w, length=4000),
        (sig, win))
    add("nn.functional", "gather_tree", lambda d, i: F.gather_tree(
        i[:10, :32].reshape(10, 4, 8) % 50, i[:10, :32].reshape(
            10, 4, 8) % 8), (pints,))
    return cases


def surface_compare(torch, name, got, want, tol):
    """Exact for integers and bools; within ``tol`` of the CPU's largest
    magnitude for floats; NaNs where the CPU has them.  Returns the max
    abs difference of the floats."""
    if isinstance(want, (list, tuple)):
        if len(got) != len(want):
            raise AssertionError(f"tensor_surface {name}: {len(got)} "
                                 f"outputs, CPU {len(want)}")
        return max([surface_compare(torch, name, g, w, tol)
                    for g, w in zip(got, want)] + [0.0])
    got = got.detach().cpu()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"tensor_surface {name}: {tuple(got.shape)} "
                             f"{got.dtype}, CPU {tuple(want.shape)} "
                             f"{want.dtype}")
    if not (want.is_floating_point() or want.is_complex()):
        if not torch.equal(got, want):
            raise AssertionError(f"tensor_surface {name}: integer outputs "
                                 "differ from the CPU's")
        return 0.0
    g, w = torch.view_as_real(got) if got.is_complex() else got, \
        torch.view_as_real(want) if want.is_complex() else want
    g, w = g.double(), w.double()
    if not torch.equal(torch.isnan(g), torch.isnan(w)):
        raise AssertionError(f"tensor_surface {name}: NaNs differ")
    fin = torch.isfinite(w)
    if not torch.equal(g[~fin & ~torch.isnan(w)], w[~fin & ~torch.isnan(w)]):
        raise AssertionError(f"tensor_surface {name}: infinities differ")
    if not fin.any():
        return 0.0
    err = (g[fin] - w[fin]).abs().max().item()
    scale = max(w[fin].abs().max().item(), 1e-30)
    if not err <= tol * scale:
        raise AssertionError(f"tensor_surface {name}: |card - CPU| {err:.3e} "
                             f"> {tol} x {scale:.3e}")
    return err


def surface_timings(torch, dev):
    """CUDA-event ms of the slice's heavy calls at the issue's shapes."""
    from paddle_tpu_torch import fft as FFT
    from paddle_tpu_torch import signal as SIG
    from paddle_tpu_torch.tensor import linalg, random as R, search

    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, device=dev, dtype=dtype, generator=g)

    a = rnd(*SURFACE_LINALG_SHAPE)
    spd = a @ a.mT + SURFACE_LINALG_SHAPE[-1] * torch.eye(
        SURFACE_LINALG_SHAPE[-1], device=dev)
    b = rnd(*SURFACE_LINALG_SHAPE[:2], 8)
    e = rnd(*SURFACE_EIG_SHAPE)
    st = SURFACE_STFT
    sig = rnd(*st["shape"])
    win = torch.hann_window(st["n_fft"], device=dev)
    spec = SIG.stft(sig, st["n_fft"], st["hop"], window=win)
    c2 = torch.complex(rnd(*SURFACE_FFT2_SHAPE), rnd(*SURFACE_FFT2_SHAPE))
    big = rnd(*SURFACE_SORT_SHAPE)
    probs = torch.rand(SURFACE_MULTINOMIAL_SHAPE, device=dev, generator=g)
    calls = {
        "svd": (lambda: linalg.svd(a), 3),
        "eigh": (lambda: linalg.eigh(spd), 3),
        "qr": (lambda: linalg.qr(a), 5),
        "solve": (lambda: linalg.solve(a, b), 5),
        "inv": (lambda: linalg.inv(a), 5),
        "det": (lambda: linalg.det(a), 5),
        "lstsq_min_norm": (lambda: linalg.lstsq(a, b), 3),
        "eig": (lambda: linalg.eig(e), 3),
        "stft": (lambda: SIG.stft(sig, st["n_fft"], st["hop"], window=win),
                 5),
        "istft": (lambda: SIG.istft(spec, st["n_fft"], st["hop"],
                                    window=win), 5),
        "fft2": (lambda: FFT.fft2(c2), 5),
        "topk": (lambda: search.topk(big, 50), 5),
        "sort": (lambda: search.sort(big), 5),
        "argsort": (lambda: search.argsort(big, descending=True), 5),
        "multinomial": (lambda: R.multinomial(probs, 8), 10),
    }
    shapes = {"svd": SURFACE_LINALG_SHAPE, "eigh": SURFACE_LINALG_SHAPE,
              "qr": SURFACE_LINALG_SHAPE, "solve": SURFACE_LINALG_SHAPE,
              "inv": SURFACE_LINALG_SHAPE, "det": SURFACE_LINALG_SHAPE,
              "lstsq_min_norm": SURFACE_LINALG_SHAPE,
              "eig": SURFACE_EIG_SHAPE, "stft": st["shape"],
              "istft": st["shape"], "fft2": SURFACE_FFT2_SHAPE,
              "topk": SURFACE_SORT_SHAPE, "sort": SURFACE_SORT_SHAPE,
              "argsort": SURFACE_SORT_SHAPE,
              "multinomial": SURFACE_MULTINOMIAL_SHAPE}
    # one library call of the same function where torch has one (torch's
    # sorts and topk promise no order among ties; lstsq's gels driver
    # assumes full rank): timed here, used nowhere in the port
    library = {"topk": lambda: torch.topk(big, 50),
               "sort": lambda: torch.sort(big),
               "argsort": lambda: torch.argsort(big, descending=True),
               "lstsq_min_norm": lambda: torch.linalg.lstsq(a, b),
               "stft": lambda: torch.stft(sig, st["n_fft"], st["hop"],
                                          window=win, return_complex=True),
               "fft2": lambda: torch.fft.fft2(c2)}
    out = {n: {"shape": list(shapes[n]), "ms": cuda_ms(fn, reps)}
           for n, (fn, reps) in calls.items()}
    for n, fn in library.items():
        out[n]["library_ms"] = cuda_ms(fn, calls[n][1])
    return out


def tensor_surface_phase(torch, dev):
    """Every function of the slice's modules (creation, math, logic,
    attribute, stat, einsum, search, linalg, random, fft, signal,
    gather_tree) on the card against the CPU on the same inputs, one
    line per module (every exported name covered, or the phase raises);
    matmuls and cuSOLVER in f32 with TF32 off.  Then the CUDA-event ms
    of the heavy calls (surface_timings)."""
    import importlib

    cases = surface_cases(torch)
    mods = {"creation": "tensor.creation", "math": "tensor.math",
            "logic": "tensor.logic", "attribute": "tensor.attribute",
            "stat": "tensor.stat", "einsum": "tensor.einsum",
            "search": "tensor.search", "linalg": "tensor.linalg",
            "random": "tensor.random", "fft": "fft", "signal": "signal"}
    with backend_flags(torch, tf32=False) as flags:
        for mod, table in cases.items():
            if mod in mods:
                names = set(importlib.import_module(
                    "paddle_tpu_torch." + mods[mod]).__all__)
                if names != set(table):
                    raise AssertionError(
                        f"tensor_surface {mod}: not covered "
                        f"{sorted(names - set(table))}, unknown "
                        f"{sorted(set(table) - names)}")
            t0 = time.perf_counter()
            worst = 0.0
            for name, (fn, args, tol) in sorted(table.items()):
                want = fn("cpu", *args)
                got = fn(dev, *[a.to(dev) for a in args])
                torch.cuda.synchronize()
                worst = max(worst, surface_compare(torch, f"{mod}.{name}",
                                                   got, want, tol))
            emit({"phase": "tensor_surface", "module": mod,
                  "functions": len(table), "max_abs_diff": worst,
                  "tolerance": f"floats {SURFACE_TOL} of the CPU's largest "
                               f"magnitude ({SURFACE_SPECIAL_TOL} special "
                               "functions, decompositions); integers and "
                               "bools exact; random: shapes, dtypes, ranges",
                  "seconds": time.perf_counter() - t0})
        timings = surface_timings(torch, dev)
    emit({"phase": "tensor_surface_timings", "backend_flags": flags,
          "ms": timings})


# ------------------------------------------------------------ phase 31
# layer_api: BERT-base's four GEMMs at b 32 x 128 (rows, in, out) as
# paddle's F.linear on an [in, out] weight against torch's on the same
# values stored [out, in], forward + backward, in turns; and the head at
# 30,528 columns: an [in, out] row of 30,522 bf16 values is 61,044
# bytes, not a multiple of 16, and 30,528 makes it one
LAYER_GEMMS = (("attention_proj", 768, 768), ("ffn_in", 768, 3072),
               ("ffn_out", 3072, 768), ("vocab_head", 768, 30522),
               ("vocab_head_pad8", 768, 30528))
LAYER_GEMM_ORDER = ("paddle", "torch", "torch", "paddle", "paddle", "torch")
LAYER_GEMM_REPS = 20
# the card-against-CPU forward of the loaded start: b 2 x 128, eval
LAYER_PARITY_BATCH = (2, 128)
LAYER_BERT_WARMUP, LAYER_BERT_STEPS = BERT_WARMUP, BERT_TIMED
LAYER_BERT_LR = 1e-4
# PaddleClas's ResNet50 recipe: Momentum(0.1, 0.9), L2Decay(1e-4)
LAYER_RESNET_LR, LAYER_RESNET_DECAY = 0.1, 1e-4
LAYER_RESNET_STEPS = 4


def _max_diff(a, c):
    return (a.float() - c.float()).abs().max().item()


def layer_gemm_turns(torch, dev):
    """{gemm: figures}: paddle's ``nn.functional.linear(x, w, b)`` on a
    bf16 ``[in, out]`` weight against ``torch.nn.functional.linear`` on
    the same values ``[out, in]`` (a contiguous copy), forward and
    backward (gradients of x, w and b), CUDA-event ms of each in turns
    (LAYER_GEMM_ORDER, LAYER_GEMM_REPS calls a turn), the profiler's
    device ms of a call (device_ms) in the same order, and the largest
    difference of the output and of each gradient (dw compared in one
    layout)."""
    import torch.nn.functional as TF

    import paddle_tpu_torch as paddle

    rows = BERT_BATCH * BERT_SEQ
    g = torch.Generator(device="cpu").manual_seed(2121)
    out = {}
    for name, k, n in LAYER_GEMMS:
        x = torch.randn(rows, k, generator=g).to(dev, torch.bfloat16)
        w = (torch.randn(k, n, generator=g) * k ** -0.5).to(
            dev, torch.bfloat16)
        b = (torch.randn(n, generator=g) * 0.1).to(dev, torch.bfloat16)
        gy = torch.randn(rows, n, generator=g).to(dev, torch.bfloat16)
        leaves = {"paddle": [t.clone().requires_grad_() for t in (x, w, b)],
                  "torch": [t.clone().requires_grad_()
                            for t in (x, w.t().contiguous(), b)]}
        fns = {"paddle": paddle.nn.functional.linear, "torch": TF.linear}

        def run(who):
            for t in leaves[who]:
                t.grad = None
            y = fns[who](*leaves[who])
            y.backward(gy)
            return y

        ys = {who: run(who).detach() for who in fns}
        (xp, wp, bp), (xt, wt, bt) = leaves["paddle"], leaves["torch"]
        ms = {who: [] for who in fns}
        dev_ms = {who: [] for who in fns}
        for who in LAYER_GEMM_ORDER:
            ms[who].append(cuda_ms(lambda: run(who), LAYER_GEMM_REPS))
        for who in LAYER_GEMM_ORDER:
            dev_ms[who].append(device_ms(torch, lambda: run(who),
                                         LAYER_GEMM_REPS))
        flops = 6 * rows * k * n
        out[name] = {
            "rows": rows, "in": k, "out": n, "dtype": "bfloat16",
            "ms_fwd_bwd": ms,
            "ms_median": {who: statistics.median(v) for who, v in ms.items()},
            "paddle_over_torch": statistics.median(ms["paddle"])
            / statistics.median(ms["torch"]),
            "device_ms_fwd_bwd": dev_ms,
            "tflops_per_s_paddle": flops / statistics.median(ms["paddle"])
            / 1e9,
            "max_abs_diff": {"y": _max_diff(ys["paddle"], ys["torch"]),
                             "dx": _max_diff(xp.grad, xt.grad),
                             "dw": _max_diff(wp.grad, wt.grad.t()),
                             "db": _max_diff(bp.grad, bt.grad)}}
        del x, w, b, gy, leaves, ys
    return out


def layer_bert_step(torch, dev, model, cfg):
    """layer_api's BERT-base train step on ``model`` (bf16, put in train
    mode): a plain loop of ``backward``, ``AdamW(1e-4, weight_decay=0.01,
    grad_clip=ClipGradByGlobalNorm(1.0, group_name=...),
    multi_precision=True)``, ``step`` and ``clear_grad`` on one seeded
    b 32 x 128 MLM batch.  Returns ``train_step()`` -> the loss."""
    import paddle_tpu_torch as paddle

    model.train()
    opt = paddle.optimizer.AdamW(
        learning_rate=LAYER_BERT_LR, parameters=model.parameters(),
        weight_decay=0.01, multi_precision=True,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(
            1.0, group_name="default_group"))
    batch = bert_batch(torch, cfg, BERT_BATCH, BERT_SEQ, dev, 1234)

    def train_step():
        loss, _ = model(batch[0], batch[1], labels=batch[2])
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return train_step


def layer_api_phase(torch, dev, bert_figures):
    """A Paddle-style script through the root namespace alone (``import
    paddle_tpu_torch as paddle``): (0) before any ``set_device``, a
    ``Layer`` subclass (a ``Linear`` and a ``create_parameter``) lands on
    the card and takes an SGD step on ``to_tensor`` input; (1)
    ``paddle.set_device("gpu")``,
    ``get_device()`` "gpu:N", ``to_tensor`` on the card; (2) the [in,
    out] layout's cost (layer_gemm_turns); (3) BERT-base MLM
    (bert_train's config: b 32 x 128, dropout 0.1, bf16) built inside a
    ``paddle.nn.Layer`` subclass whose ``Linear`` and ``Embedding``
    weights are re-drawn from ``TruncatedNormal(std=0.02)`` through
    ``Layer.apply`` (PaddleNLP's ``init_weights``): the start built on the
    CPU, saved with ``paddle.save``, loaded on the card with
    ``set_state_dict``; one eval forward's logits on the card (f32, TF32
    off) against the CPU's, held as bert_parity holds its logits (the
    card's error from the CPU's f64 within GRAD_PARITY_FACTOR of the
    CPU's f32 own plus GRAD_PARITY_FLOOR); then ``astype("bfloat16")``
    and LAYER_BERT_STEPS timed steps of a plain loop (``backward``,
    ``AdamW(1e-4, weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0,
    group_name="default_group"), multi_precision=True)``, ``clear_grad``)
    with the LayerNorm kernels' launches asserted (26 forward and 26
    backward a step), the step seconds beside bert_train's from the same
    call, one profiled step's idle share; (4) ResNet-50 at b 64 x 224 in
    bf16 with PaddleClas's ``Momentum(0.1, 0.9,
    weight_decay=L2Decay(1e-4))`` against ``weight_decay=1e-4`` from the
    same start, LAYER_RESNET_STEPS steps each in turns with cuDNN's
    deterministic algorithms: every parameter and buffer bitwise equal
    (JAX maps L2Decay onto the coupled float path); then in f32 (TF32
    off) a copy whose ``fc`` has ``weight_attr=ParamAttr(learning_rate=
    0.5)`` and whose ``conv1`` has ``ParamAttr(trainable=False)``, one
    step against the default's: conv1 bitwise unchanged (no gradient),
    fc's update half the default's within f32 rounding.  Returns the
    LayerNorm kernels' launches of the timed BERT steps and the
    figures."""
    import tempfile

    import numpy as np

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.bert import BERT_BASE, BertForMaskedLM
    from paddle_tpu_torch.ops import kernel_launches, reset_kernel_launches

    nn = paddle.nn
    figures = {"phase": "layer_api"}
    # (0) no set_device yet: a Layer, its parameters, to_tensor and an
    # optimizer step all land on the card, as in a Paddle script
    if paddle.device._CURRENT[0] is not None:
        raise AssertionError("layer_api: set_device was called before")

    class Tiny(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(4, 3)
            self.scale = self.create_parameter(
                [3], default_initializer=nn.initializer.Constant(1.0))

        def forward(self, x):
            return self.fc(x) * self.scale

    tiny = Tiny()
    where = sorted({str(p.device) for p in tiny.parameters()})
    opt = paddle.optimizer.SGD(0.1, parameters=tiny.parameters())
    tiny(paddle.to_tensor(np.ones((2, 4), np.float32))).sum().backward()
    w0 = tiny.fc.weight.detach().clone()
    opt.step()
    if where != [str(dev)] or torch.equal(w0, tiny.fc.weight):
        raise AssertionError(f"layer_api: with no set_device the Layer's "
                             f"parameters are on {where}, not {dev}")
    figures["no_set_device"] = {"parameters_on": where,
                                "sgd_step": "moved fc.weight"}
    del tiny, opt
    # (1) the device
    paddle.set_device("gpu")
    want = f"gpu:{torch.cuda.current_device()}"
    if paddle.get_device() != want or paddle.device.resolve_device() != dev:
        raise AssertionError(f"layer_api: get_device {paddle.get_device()}"
                             f", want {want}")
    arr = np.arange(12, dtype=np.float64).reshape(3, 4)
    t = paddle.to_tensor(arr)
    if t.device != dev or t.dtype != torch.float32 or not torch.equal(
            t.cpu(), torch.from_numpy(arr).float()):
        raise AssertionError(f"layer_api: to_tensor gave {t.dtype} on "
                             f"{t.device}")
    figures["device"] = {"get_device": paddle.get_device(),
                         "to_tensor": [str(t.device), str(t.dtype)]}
    # (2) the layout's cost
    figures["gemm_layout"] = layer_gemm_turns(torch, dev)
    emit({"phase": "layer_api_gemm", **figures["gemm_layout"]})
    gc.collect()
    torch.cuda.empty_cache()

    # (3) BERT-base through the Layer API
    class BertPretrain(nn.Layer):
        def __init__(self, cfg):
            super().__init__()
            self.bert = BertForMaskedLM(cfg)      # on paddle's device
            self.apply(self.init_weights)

        @staticmethod
        def init_weights(layer):
            if isinstance(layer, (nn.Linear, nn.Embedding)):
                w = layer.weight
                with paddle.no_grad():
                    w.copy_(nn.initializer.TruncatedNormal(std=0.02)(
                        w.shape, w.dtype, device=w.device))

        def forward(self, ids, types, labels=None):
            return self.bert(ids, types, labels=labels)

    cfg = BERT_BASE
    paddle.set_device("cpu")
    paddle.seed(2121)
    cpu_model = BertPretrain(cfg)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bert_start.pdparams")
        paddle.save(cpu_model.state_dict(), path)
        paddle.set_device("gpu")
        model = BertPretrain(cfg)
        missing, unexpected = model.set_state_dict(paddle.load(path))
    if missing or unexpected or model.bert.bert.embeddings.word_embeddings \
            .weight.device != dev:
        raise AssertionError(f"layer_api: set_state_dict missing {missing}"
                             f", unexpected {unexpected}")
    std = model.bert.bert.encoder.layers[0].linear1.weight.float().std()
    ids, types, _ = bert_batch(torch, cfg, *LAYER_PARITY_BATCH, "cpu", 77)
    cpu_model.eval()
    model.eval()
    with torch.no_grad(), backend_flags(torch, tf32=False):
        l32 = cpu_model(ids, types)
        l64 = copy.deepcopy(cpu_model).double()(ids, types)
        reset_kernel_launches()
        lcard = model(ids.to(dev), types.to(dev)).cpu()
        eval_launches = kernel_launches()
    e_card = ((lcard.double() - l64).norm() / l64.norm()).item()
    e_cpu = ((l32.double() - l64).norm() / l64.norm()).item()
    tol = GRAD_PARITY_FACTOR * e_cpu + GRAD_PARITY_FLOOR
    if not e_card <= tol or eval_launches["layer_norm"] != \
            BERT_PER_STEP["layer_norm"]:
        raise AssertionError(f"layer_api: card logits rel err {e_card:.3e}"
                             f" > {tol:.3e} (CPU f32 {e_cpu:.3e}), launches "
                             f"{eval_launches}")
    figures["bert_start"] = {
        "saved_loaded_keys": len(model.state_dict()),
        "linear1_weight_std": std.item(),
        "logits_rel_err_card_f32_vs_cpu_f64": e_card,
        "logits_rel_err_cpu_f32_vs_cpu_f64": e_cpu, "tolerance": tol,
        "batch": list(LAYER_PARITY_BATCH)}
    del cpu_model, l32, l64, lcard
    gc.collect()
    model = model.astype("bfloat16")
    train_step = layer_bert_step(torch, dev, model, cfg)
    losses = [train_step().item() for _ in range(LAYER_BERT_WARMUP)]
    step_s = []
    reset_kernel_launches()
    for _ in range(LAYER_BERT_STEPS):
        t1 = time.perf_counter()
        losses.append(train_step().item())       # .item() synchronises
        step_s.append(time.perf_counter() - t1)
    launches = kernel_launches()
    for name in ("layer_norm", "layer_norm_bwd"):
        if launches[name] != BERT_PER_STEP[name] * LAYER_BERT_STEPS:
            raise AssertionError(f"layer_api: {name} launched "
                                 f"{launches[name]} times in "
                                 f"{LAYER_BERT_STEPS} steps")
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"layer_api: BERT losses {losses}")
    prof = profiled(torch, lambda: train_step().item())
    mean_s = sum(step_s) / len(step_s)
    figures["bert_train_layer_api"] = {
        "batch": BERT_BATCH, "seq": BERT_SEQ, "dtype": "bfloat16",
        "losses": losses, "step_s": step_s, "step_s_mean": mean_s,
        "bert_train_step_s_mean": bert_figures["step_s_mean"],
        "ratio_to_bert_train": mean_s / bert_figures["step_s_mean"],
        "device_idle_share": prof["device_idle_share"],
        "kernel_events": prof["kernel_events"],
        "launches": {k: launches[k] for k in ("layer_norm",
                                              "layer_norm_bwd")}}
    emit({"phase": "layer_api_bert", **figures["bert_train_layer_api"]})
    del model, train_step
    gc.collect()
    torch.cuda.empty_cache()

    # (4) the regularizers and ParamAttr on ResNet-50
    figures["resnet"] = layer_resnet_checks(torch, dev)
    emit(figures)
    return launches, figures


def layer_resnet_checks(torch, dev):
    """Step (4) of :func:`layer_api_phase`."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.regularizer import L2Decay

    nn = paddle.nn
    out = {}
    x, y = resnet_batch(torch, RESNET_BATCH, 31, dev, torch.bfloat16)
    paddle.seed(3131)
    nets = [paddle.vision.resnet50(num_classes=RESNET_CLASSES,
                                   dtype=torch.bfloat16)]
    nets.append(copy.deepcopy(nets[0]))
    fc0 = nets[0].fc.weight.detach().clone()
    decays = {"L2Decay": L2Decay(LAYER_RESNET_DECAY),
              "float": LAYER_RESNET_DECAY}
    opts = [paddle.optimizer.Momentum(LAYER_RESNET_LR, 0.9, net.parameters(),
                                      weight_decay=wd)
            for net, wd in zip(nets, decays.values())]
    ms = {k: [] for k in decays}
    with backend_flags(torch, deterministic=True, benchmark=False):
        for i in range(LAYER_RESNET_STEPS):
            order = (0, 1) if i % 2 == 0 else (1, 0)
            for j in order:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                resnet_loss(nets[j], x, y).backward()
                opts[j].step()
                opts[j].clear_grad()
                torch.cuda.synchronize()
                ms[list(decays)[j]].append((time.perf_counter() - t1) * 1e3)
    sd = [n.state_dict() for n in nets]
    differ = [k for k in sd[0] if not torch.equal(sd[0][k], sd[1][k])]
    if differ or len(sd[0]) != len(sd[1]) or torch.equal(sd[0]["fc.weight"],
                                                          fc0):
        raise AssertionError(f"layer_api: L2Decay and the float decay "
                             f"differ in {differ[:5]}")
    # the first step of each holds cuDNN's algorithm search
    out["l2decay_vs_float"] = {"steps": LAYER_RESNET_STEPS,
                               "tensors_bitwise_equal": len(sd[0]),
                               "step_ms": ms, "batch": RESNET_BATCH,
                               "step_ms_median": {
                                   k: statistics.median(v)
                                   for k, v in ms.items()}}
    del nets, opts, sd
    gc.collect()
    torch.cuda.empty_cache()
    # ParamAttr: fc at half the rate, conv1 frozen, in f32
    paddle.seed(3232)
    base = paddle.vision.resnet50(num_classes=RESNET_CLASSES)
    attr = copy.deepcopy(base)
    attr.fc = nn.Linear(2048, RESNET_CLASSES,
                        weight_attr=paddle.ParamAttr(learning_rate=0.5))
    attr.conv1 = nn.Conv2D(3, 64, 7, stride=2, padding=3, bias_attr=False,
                           weight_attr=paddle.ParamAttr(trainable=False))
    attr.fc.set_state_dict(base.fc.state_dict())
    attr.conv1.set_state_dict(base.conv1.state_dict())
    start = {k: v.clone() for k, v in base.state_dict().items()}
    x32 = x.float()
    with backend_flags(torch, deterministic=True, benchmark=False,
                       tf32=False):
        for net in (base, attr):
            opt = paddle.optimizer.Momentum(
                LAYER_RESNET_LR, 0.9, net.parameters(),
                weight_decay=L2Decay(LAYER_RESNET_DECAY))
            resnet_loss(net, x32, y).backward()
            opt.step()
    if attr.conv1.weight.grad is not None or not torch.equal(
            attr.conv1.weight, start["conv1.weight"]) or torch.equal(
            base.conv1.weight, start["conv1.weight"]):
        raise AssertionError("layer_api: the frozen conv1 moved, or the "
                             "default's did not")
    p0 = start["fc.weight"]
    d_half = attr.fc.weight.detach() - p0
    d_base = base.fc.weight.detach() - p0
    eps = torch.finfo(torch.float32).eps
    err = (d_half - 0.5 * d_base).abs()
    limit = 2 * eps * (p0.abs() + d_base.abs())
    if not (err <= limit).all() or not d_base.abs().max() > 0:
        raise AssertionError(f"layer_api: fc's update {err.max().item():.3e}"
                             " from half the default's")
    same = sum(torch.equal(a, b) for (k, a), b in zip(
        base.state_dict().items(), attr.state_dict().values())
        if not k.startswith(("fc.weight", "conv1.")))
    out["param_attr"] = {
        "conv1_frozen": "bitwise unchanged, no gradient",
        "fc_update_max_err_from_half": err.max().item(),
        "fc_update_max_abs": d_base.abs().max().item(),
        "other_tensors_bitwise_equal_to_default": same,
        "other_tensors": len(start) - 1 - sum(
            k.startswith("conv1.") for k in start)}
    del base, attr, start
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ phase 32
HOST_RMS_SHAPE = (8192, 4096)       # the serve shape of the RMSNorm rows
HOST_TURNS = ("pylayer", "kernel", "kernel", "pylayer", "pylayer", "kernel")
HOST_REPS = 10
HOST_JAC_SHAPE = (4, 64)            # the small function of the jacobian
HOST_PROFILE_STEPS, HOST_SCHEDULE = 4, (1, 3)
HOST_PROFILE_WINDOWS = 3
HOST_PROFILER_TURNS = ("none", "timer_only", "trace", "trace", "timer_only",
                       "none")
HOST_TURN_STEPS = 2
HOST_STREAM_GEMM = 8192
# a CRF tagger's batch: B 256 sentences of 128 tokens, 64 tags
HOST_VITERBI = (256, 128, 64)
HOST_VITERBI_REPS = 5
# LLaMA-2-7B's projections (q/k/v/o, gate/up, down, the head), decode's
# 8 rows and a 1,024-row prefill window
HOST_LAYOUT_GEMMS = (("qkvo_proj", 4096, 4096), ("gate_up_proj", 4096, 11008),
                     ("down_proj", 11008, 4096), ("lm_head", 4096, 32000))
HOST_LAYOUT_ROWS = (8, 1024)
HOST_LAYOUT_ORDER = ("in_out", "out_in", "out_in", "in_out", "in_out",
                     "out_in")
HOST_LAYOUT_REPS = 20


def host_rms_pylayer(torch, dev, figures):
    """Step (1) of :func:`host_api_phase`."""
    from paddle_tpu_torch import autograd as AG
    from paddle_tpu_torch.ops.rms_norm import (rms_norm, rms_norm_bwd,
                                               rms_norm_fwd,
                                               rms_norm_fwd_plain)

    class RMSNormLayer(AG.PyLayer):
        @staticmethod
        def forward(ctx, x, w, eps):
            y, rstd = rms_norm_fwd(x, w, eps)
            ctx.save_for_backward(x, w, rstd)
            return y

        @staticmethod
        def backward(ctx, dy):
            x, w, rstd = ctx.saved_tensor()
            return rms_norm_bwd(x, w, rstd, dy.contiguous())

    g = torch.Generator(device="cpu").manual_seed(2222)
    rows, h = HOST_RMS_SHAPE
    x0 = torch.randn(rows, h, generator=g).to(dev, torch.bfloat16)
    w0 = (1 + 0.1 * torch.randn(h, generator=g)).to(dev, torch.bfloat16)
    gy = torch.randn(rows, h, generator=g).to(dev, torch.bfloat16)
    fns = {"pylayer": lambda x, w: RMSNormLayer.apply(x, w, 1e-6),
           "kernel": lambda x, w: rms_norm(x, w, 1e-6)}
    leaves = {k: (x0.clone().requires_grad_(), w0.clone().requires_grad_())
              for k in fns}

    def run(who):
        x, w = leaves[who]
        x.grad = w.grad = None
        y = fns[who](x, w)
        y.backward(gy)
        return y

    outs = {who: (run(who).detach(), leaves[who][0].grad,
                  leaves[who][1].grad) for who in fns}
    equal = [torch.equal(a, b) for a, b in zip(outs["pylayer"],
                                               outs["kernel"])]
    if not all(equal):
        raise AssertionError(f"host_api: the RMSNorm PyLayer's y, dx, dw "
                             f"bitwise equal to the kernel path: {equal}")
    ms = {who: [] for who in fns}
    for who in HOST_TURNS:
        ms[who].append(cuda_ms(lambda: run(who), HOST_REPS))
    # jacobian and jvp of a small f32 function through the PyLayer on
    # the card against the plain formula's on the CPU
    xs = torch.randn(*HOST_JAC_SHAPE, generator=g)
    ws = 1 + 0.1 * torch.randn(HOST_JAC_SHAPE[1], generator=g)
    vs = torch.randn(*HOST_JAC_SHAPE, generator=g)
    wc = ws.to(dev)
    card = lambda t: RMSNormLayer.apply(t, wc, 1e-6)       # noqa: E731
    plain = lambda t: rms_norm_fwd_plain(t, ws, 1e-6)[0]   # noqa: E731
    jac = (AG.jacobian(card, xs.to(dev)).cpu(), AG.jacobian(plain, xs))
    jvp = (AG.jvp(card, xs.to(dev), vs.to(dev))[1].cpu(),
           AG.jvp(plain, xs, vs)[1])
    err = {k: ((a - b).abs().max() / b.abs().max()).item()
           for k, (a, b) in (("jacobian", jac), ("jvp", jvp))}
    if not max(err.values()) <= TOLERANCES["float32"][0]:
        raise AssertionError(f"host_api: jacobian/jvp through the PyLayer "
                             f"on the card vs the CPU's plain: {err}")
    figures["rms_pylayer"] = {
        "shape": list(HOST_RMS_SHAPE), "dtype": "bfloat16",
        "bitwise_equal_y_dx_dw": equal, "ms_fwd_bwd": ms,
        "ms_median": {k: statistics.median(v) for k, v in ms.items()},
        "pylayer_over_kernel": statistics.median(ms["pylayer"])
        / statistics.median(ms["kernel"]),
        "jacobian_jvp_rel_err_vs_cpu_plain": err,
        "jacobian_shape": list(jac[0].shape)}
    emit({"phase": "host_api_rms_pylayer", **figures["rms_pylayer"]})


def host_profiled_steps(torch, P, train_step, kernel_launches):
    """HOST_PROFILE_STEPS train steps, each in a ``RecordEvent``, under
    ``P.Profiler(scheduler=HOST_SCHEDULE)`` whose ``on_trace_ready``
    exports the window's chrome trace: (the profiler, the trace's
    events, the launch counters after each step, the exported paths)."""
    import tempfile

    launches, ready = [], []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bert.json")
        prof = P.Profiler(scheduler=HOST_SCHEDULE,
                          on_trace_ready=lambda p: ready.append(
                              p.export(path)))
        with prof:
            for i in range(HOST_PROFILE_STEPS):
                with P.RecordEvent(f"bert_step_{i}"):
                    train_step().item()
                launches.append(kernel_launches())
                prof.step(num_samples=BERT_BATCH)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return prof, events, launches, ready


def host_ln_by_step(events, kernels):
    """{step span: [LayerNorm forward, backward] kernels} of a trace, a
    kernel placed in the span whose device-side annotation covers it."""
    out = {}
    for e in events:
        if e.get("cat") == "gpu_user_annotation" and \
                str(e.get("name", "")).startswith("bert_step_"):
            lo, hi = e["ts"], e["ts"] + e.get("dur", 0)
            inside = [k["name"] for k in kernels if lo <= k["ts"] <= hi]
            out[e["name"]] = [sum("ln_fwd_" in n for n in inside),
                              sum("ln_bwd_" in n for n in inside)]
    return out


def host_profiler(torch, dev, figures):
    """Step (2) of :func:`host_api_phase`."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.bert import BERT_BASE, BertForMaskedLM
    from paddle_tpu_torch.ops import kernel_launches

    P = paddle.profiler
    paddle.seed(2222)
    model = BertForMaskedLM(BERT_BASE, device=dev).astype("bfloat16")
    train_step = layer_bert_step(torch, dev, model, BERT_BASE)
    for _ in range(BERT_WARMUP):
        train_step().item()
    first, last = HOST_SCHEDULE
    want_spans = [f"bert_step_{i}" for i in range(first, last)]
    windows = []
    # CUPTI can drop a kernel record (device_ms); a window whose trace
    # misses one is recorded and profiled again, and one window must
    # hold every launch
    for _ in range(HOST_PROFILE_WINDOWS):
        prof, events, launches, ready = host_profiled_steps(
            torch, P, train_step, kernel_launches)
        kernels = [e for e in events if e.get("cat") == "kernel"]
        in_trace = {"layer_norm": sum("ln_fwd_" in e["name"]
                                      for e in kernels),
                    "layer_norm_bwd": sum("ln_bwd_" in e["name"]
                                          for e in kernels)}
        counted = {k: launches[last - 1][k] - launches[first - 1][k]
                   for k in in_trace}
        spans = sorted({e["name"] for e in events
                        if str(e.get("name", "")).startswith("bert_step_")})
        windows.append({"layer_norm_in_trace": in_trace,
                        "layer_norm_launches": counted,
                        "in_trace_by_step": host_ln_by_step(events, kernels),
                        "trace_kernels": len(kernels)})
        if in_trace == counted:
            break
    summary = prof.summary()
    if len(ready) != 1 or in_trace != counted or spans != want_spans or \
            not counted["layer_norm"] or "steps: " not in summary:
        raise AssertionError(f"host_api: profiler windows {windows}, "
                             f"spans {spans}, ready {ready}, summary "
                             f"{summary[:200]!r}")
    print(summary, flush=True)
    step_s = {k: [] for k in ("none", "timer_only", "trace")}
    for turn in HOST_PROFILER_TURNS:
        p = None if turn == "none" else P.Profiler(
            timer_only=turn == "timer_only")
        if p is not None:
            p.start()
        for _ in range(HOST_TURN_STEPS):
            t0 = time.perf_counter()
            train_step().item()
            step_s[turn].append(time.perf_counter() - t0)
            if p is not None:
                p.step()
        if p is not None:
            p.stop()
    med = {k: statistics.median(v) for k, v in step_s.items()}
    figures["profiler"] = {
        "steps": HOST_PROFILE_STEPS, "scheduler": list(HOST_SCHEDULE),
        "windows": windows, "spans": spans,
        "summary": summary.splitlines()[0], "step_s": step_s,
        "step_s_median": med,
        "timer_only_over_none": med["timer_only"] / med["none"],
        "trace_over_none": med["trace"] / med["none"]}
    emit({"phase": "host_api_profiler", **figures["profiler"]})
    return model, train_step


def host_device(torch, dev, figures):
    """Step (3) of :func:`host_api_phase`."""
    import paddle_tpu_torch as paddle

    D = paddle.device
    g = torch.Generator(device="cpu").manual_seed(2223)
    n = HOST_STREAM_GEMM
    a = torch.randn(n, n, generator=g).to(dev, torch.bfloat16)
    b = torch.randn(n, n, generator=g).to(dev, torch.bfloat16)
    ref = a @ b
    side, main = D.Stream(), D.current_stream()
    side.wait_stream(main)
    with D.stream_guard(side):
        out = a @ b
        done = side.record_event()
    main.wait_event(done)
    equal = torch.equal(out, ref)
    ev = D.Event()
    ev.record()
    ev.synchronize()
    mem = {"max_memory_allocated": (D.cuda.max_memory_allocated(),
                                    torch.cuda.max_memory_allocated()),
           "memory_allocated": (D.cuda.memory_allocated(),
                                torch.cuda.memory_allocated())}
    if not equal or not ev.query() or any(x != y for x, y in mem.values()) \
            or side._stream == main._stream:
        raise AssertionError(f"host_api: side-stream product equal {equal},"
                             f" memory {mem}")
    figures["device"] = {"side_stream_gemm": [n, n, n],
                         "bitwise_equal": equal, "memory": mem,
                         "device_count": D.cuda.device_count(),
                         "available": D.get_available_device()}
    emit({"phase": "host_api_device", **figures["device"]})


def host_viterbi(torch, dev, figures):
    """Step (4) of :func:`host_api_phase`."""
    import paddle_tpu_torch as paddle

    b, t, n = HOST_VITERBI
    g = torch.Generator(device="cpu").manual_seed(2224)
    pot = torch.randn(b, t, n, generator=g)
    trans = torch.randn(n, n, generator=g)
    # planted ties: a quarter of the sentences in small integers
    pot[: b // 4] = torch.randint(0, 3, (b // 4, t, n), generator=g).float()
    lengths = torch.randint(1, t + 1, (b,), generator=g)
    lengths[:2] = t
    out = {}
    for bos_eos in (True, False):
        cpu = paddle.text.viterbi_decode(pot, trans, lengths, bos_eos)
        card = paddle.text.viterbi_decode(pot.to(dev), trans.to(dev),
                                          lengths.to(dev), bos_eos)
        eq = [torch.equal(c.cpu(), r) for c, r in zip(card, cpu)]
        if not all(eq):
            raise AssertionError(f"host_api: viterbi on the card equals "
                                 f"the CPU's: {eq} (bos_eos {bos_eos})")
        out[bos_eos] = eq
    args = (pot.to(dev), trans.to(dev), lengths.to(dev))
    ms = cuda_ms(lambda: paddle.text.viterbi_decode(*args), HOST_VITERBI_REPS)
    prof = profiled(torch, lambda: paddle.text.viterbi_decode(*args))
    figures["viterbi"] = {
        "batch": b, "seq": t, "tags": n, "dtype": "float32",
        "equal_scores_paths": {"bos_eos": out[True], "plain": out[False]},
        "ms_per_call": ms, "device_idle_share": prof["device_idle_share"],
        "kernel_events": prof["kernel_events"]}
    emit({"phase": "host_api_viterbi", **figures["viterbi"]})


def host_debugging(torch, dev, figures, train_step):
    """Step (5) of :func:`host_api_phase`."""
    import warnings

    import paddle_tpu_torch as paddle

    D = paddle.amp.debugging
    x = torch.zeros(*HOST_RMS_SHAPE, dtype=torch.bfloat16, device=dev)
    flat = x.view(-1)
    flat[::100003] = float("nan")
    flat[7::200003] = float("inf")
    flat[11::300007] = -float("inf")
    want = (len(range(0, flat.numel(), 100003)),
            len(range(7, flat.numel(), 200003))
            + len(range(11, flat.numel(), 300007)))
    n_nan, n_inf = D.check_numerics(x, "host_api", "x",
                                    debug_mode=D.DebugMode.CHECK_NAN_INF)
    got = (n_nan.item(), n_inf.item())

    class Net(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = paddle.nn.Linear(16, 16)

        def forward(self, t):
            return torch.sqrt(self.fc(t) - 1e3)

    net = Net()
    D.enable_tensor_checker(D.TensorCheckerConfig(True))
    try:
        net(torch.ones(4, 16, device=dev))
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    finally:
        D.disable_tensor_checker()
    if got != want or n_nan.device != x.device or raised is None or \
            "aten.sqrt" not in raised:
        raise AssertionError(f"host_api: check_numerics {got} of {want}, "
                             f"tensor checker raised {raised!r}")
    step_s = {"off": [], "checker": []}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for turn in ("off", "checker", "checker", "off"):
            if turn == "checker":
                D.enable_tensor_checker(D.TensorCheckerConfig(
                    True, debug_mode=D.DebugMode.CHECK_NAN_INF))
            try:
                t0 = time.perf_counter()
                train_step().item()
                step_s[turn].append(time.perf_counter() - t0)
            finally:
                D.disable_tensor_checker()
    found = [str(w.message) for w in caught
             if "tensor checker" in str(w.message)]
    figures["debugging"] = {
        "check_numerics": got, "planted": want, "raised": raised,
        "bert_step_s": step_s,
        "checker_over_off": statistics.mean(step_s["checker"])
        / statistics.mean(step_s["off"]),
        "checker_warnings_in_bert_steps": len(found),
        "first_warnings": found[:3]}
    emit({"phase": "host_api_debugging", **figures["debugging"]})


def host_utils(torch, dev, figures):
    """Step (6) of :func:`host_api_phase`."""
    import io
    import tempfile
    import textwrap

    import paddle_tpu_torch as paddle

    U = paddle.utils
    t = torch.randn(1024, 1024, device=dev)
    back = U.dlpack.from_dlpack(U.dlpack.to_dlpack(t))
    capsule = U.dlpack.from_dlpack(torch.utils.dlpack.to_dlpack(t))
    shared = back.data_ptr() == t.data_ptr() == capsule.data_ptr() and \
        back.device == t.device
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        U.run_check()
    printed = buf.getvalue().strip()
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "op.cc")
        with open(src, "w") as f:
            f.write(textwrap.dedent("""
                extern "C" void double_plus_one(const float* in, float* out,
                                                long n) {
                    for (long i = 0; i < n; ++i) out[i] = 2.0f * in[i] + 1.0f;
                }
            """))
        lib = U.cpp_extension.load("host_api_op", [src], build_directory=tmp)
        op = U.cpp_extension.host_op(lib, "double_plus_one", lambda s: s)
        x = torch.randn(64, 128, device=dev)
        y = op(x)
    host_ok = y.device == x.device and torch.equal(y, 2.0 * x + 1.0)
    name = torch.cuda.get_device_name(dev)
    if not shared or name not in printed or not host_ok:
        raise AssertionError(f"host_api: dlpack shares {shared}, run_check "
                             f"{printed!r}, host_op {host_ok}")
    figures["utils"] = {"dlpack_shares_storage": shared,
                        "run_check": printed, "host_op_equal": host_ok,
                        "version": paddle.__version__,
                        "cuda_version": paddle.version.cuda(),
                        "cudnn_version": paddle.version.cudnn()}
    emit({"phase": "host_api_utils", **figures["utils"]})


def host_layout(torch, dev, figures):
    """Step (7) of :func:`host_api_phase`: the serving path's
    ``tiled_linear`` over paddle's ``[in, out]`` weight against the same
    product over an ``[out, in]`` copy (the layout before the repair: the
    batch's B transposed), in turns; rows bitwise equal across window
    sizes."""
    from paddle_tpu_torch.models import gpt

    g = torch.Generator(device="cpu").manual_seed(2225)
    tile = gpt.ROW_TILE

    def out_in(rows, w_oi):
        n = rows.shape[0] // tile
        return torch.bmm(rows.view(n, tile, -1),
                         w_oi.t().expand(n, -1, -1)).view(n * tile, -1)

    out = {}
    for name, k, n in HOST_LAYOUT_GEMMS:
        w = (torch.randn(k, n, generator=g) * k ** -0.5).to(
            dev, torch.bfloat16)
        w_oi = w.t().contiguous()
        x = torch.randn(max(HOST_LAYOUT_ROWS), k, generator=g).to(
            dev, torch.bfloat16)
        full = gpt.tiled_linear(gpt.pad_rows(x), w)
        case = {}
        for m in HOST_LAYOUT_ROWS:
            rows = gpt.pad_rows(x[:m])
            fns = {"in_out": lambda: gpt.tiled_linear(rows, w),
                   "out_in": lambda: out_in(rows, w_oi)}
            y = fns["in_out"]()[:m]
            invariant = torch.equal(y, full[:m])
            diff = _max_diff(y, fns["out_in"]()[:m])
            ms = {who: [] for who in fns}
            for who in HOST_LAYOUT_ORDER:
                ms[who].append(cuda_ms(fns[who], HOST_LAYOUT_REPS))
            if not invariant:
                raise AssertionError(f"host_api: {name} rows {m}: the "
                                     f"[in, out] product's rows differ "
                                     f"from the {max(HOST_LAYOUT_ROWS)}-row "
                                     f"window's")
            med = {who: statistics.median(v) for who, v in ms.items()}
            case[m] = {"ms": ms, "ms_median": med,
                       "in_out_over_out_in": med["in_out"] / med["out_in"],
                       "rows_bitwise_equal_across_windows": invariant,
                       "max_abs_diff_vs_out_in": diff,
                       "tflops_per_s_in_out": 2 * rows.shape[0] * k * n
                       / med["in_out"] / 1e9}
        out[name] = {"in": k, "out": n, "rows": case}
        del w, w_oi, x, full
    figures["layout"] = out
    emit({"phase": "host_api_layout", **out})


def host_api_phase(torch, dev):
    """The small host modules on the card through ``import
    paddle_tpu_torch as paddle``: (1) a ``PyLayer`` whose forward and
    backward call the RMSNorm kernels (``rms_norm_fwd``/``rms_norm_bwd``)
    at [8192, 4096] bf16: y, dx, dw bitwise equal to ``rms_norm``'s own
    autograd path, forward + backward ms of both in turns; ``jacobian``
    and ``jvp`` of a small f32 function through it against the CPU's
    plain formula within TOLERANCES' f32 rtol; (2) ``profiler.Profiler``
    over 4 of layer_api's BERT-base steps (layer_bert_step) with a
    ``RecordEvent`` around each and ``scheduler=(1, 3)``: the exported
    chrome trace holds the spans of steps 1 and 2 and as many LayerNorm
    forward and backward kernels as the launch counters counted in those
    steps (a window whose trace lost a kernel record is kept in the
    figures and profiled again, up to HOST_PROFILE_WINDOWS windows);
    ``summary()`` printed; step seconds with no profiler,
    ``timer_only`` and tracing, in turns; (3) ``device``: a bf16 8192^3
    product on a side ``Stream`` under ``stream_guard``, joined by
    ``wait_stream``/``Event``, bitwise equal to the default stream's;
    ``cuda.max_memory_allocated``/``memory_allocated`` equal torch's;
    (4) ``text.viterbi_decode`` at B 256, T 128, 64 tags (f32, a quarter
    of the sentences in small integers for ties, ragged lengths):
    scores and paths equal the CPU's, ms per call and idle share; (5)
    ``amp.debugging``: ``check_numerics`` counts planted NaN/Inf in a
    bf16 card tensor, the tensor checker raises naming the operator
    that made a NaN in a layer's forward, and one BERT step with the
    checker (warning mode) against one without, in turns; (6)
    ``utils``: a dlpack round trip shares storage, ``run_check`` prints
    the card, a ``cpp_extension`` host op on a card tensor; (7) the
    layout repair: ``tiled_linear`` at LLaMA-2-7B's projections over
    ``[in, out]`` against ``[out, in]`` at 8 and 1,024 rows, in turns,
    rows bitwise equal across the two windows.  Returns the kernels'
    launches over the phase and the figures."""
    from paddle_tpu_torch.ops import kernel_launches, reset_kernel_launches

    figures = {"phase": "host_api"}
    reset_kernel_launches()
    host_rms_pylayer(torch, dev, figures)
    model, train_step = host_profiler(torch, dev, figures)
    host_debugging(torch, dev, figures, train_step)
    del model, train_step
    gc.collect()
    torch.cuda.empty_cache()
    host_device(torch, dev, figures)
    host_viterbi(torch, dev, figures)
    host_utils(torch, dev, figures)
    host_layout(torch, dev, figures)
    launches = kernel_launches()
    for name in ("rms_norm", "rms_norm_bwd", "layer_norm", "layer_norm_bwd"):
        if not launches[name]:
            raise AssertionError(f"host_api: {name} never launched")
    figures["launches"] = launches
    gc.collect()
    torch.cuda.empty_cache()
    return launches, figures


# ------------------------------------------------------------ jit_deploy
JIT_EVAL_BATCH = 32              # the to_static eval forward's [32, 128]
JIT_PREDICT_BATCHES = (1, 8, 32)
JIT_MANY_K = 8
#: the depth of parts 1 and 3, which compile with Inductor: BERT-base's
#: width, 2 of its 12 layers (the compile grows with depth: at 12 the eval
#: forward took 41-80 s and the training step 60-95 s); part 2 saves,
#: loads and serves all 12
JIT_CUT_LAYERS = 2
JIT_TURNS = ("graph", "eager", "eager", "graph")
#: the LayerNorm forward's and the flash forward's kernel names in the
#: profile, and what the library's LayerNorm and SDPA kernels are named
JIT_LN_FWD_KERNELS = ("ln_fwd_warp_kernel", "ln_fwd_cta_kernel",
                      "ln_fwd_row_kernel")
JIT_FLASH_FWD_KERNELS = ("FlashProblem",)
JIT_LIBRARY_KERNELS = ("layer_norm_kernel", "LayerNorm", "pytorch_flash",
                       "fmha", "efficient_attention", "flash_fwd_kernel")


def kernel_counts(prof, names):
    """How many kernel records of ``prof`` have one of ``names`` in
    their name."""
    from torch.autograd import DeviceType

    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
               and any(n in e.name for n in names))


def profile_run(torch, run, host=True, between=None):
    """``run()`` under torch.profiler, after a warm-up run in a window of
    its own (a cold window late in a long process has lost kernel
    records: PERF.md, Findings) -> (the profile, the figures of
    :func:`profile_figures` for the second run); ``between()``, if
    given, runs between the two (a reset of the launch counters);
    ``host=False`` records the device's kernels alone (a pack of steps
    makes ~500,000 host events)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host
                                      else [])
    torch.cuda.synchronize()
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        run()
        torch.cuda.synchronize()
        prof.step()
        if between is not None:
            between()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # (no step after the active run: leaving the block ends the window
    # and keeps its events, where a step would start a new cycle)
    return prof, profile_figures(prof, wall_us)


def jit_eval_bound(torch, model, ids):
    """bert_parity's eval bound at this batch: twice the plain bf16
    path's relative error against an f32 copy, plus the floor."""
    model32 = copy.deepcopy(model).float()
    with torch.no_grad(), functional_plain_path(torch):
        lp = model(ids).float()
        l32 = model32(ids)
    e_p = ((lp - l32).norm() / l32.norm()).item()
    del model32, lp, l32
    return GRAD_PARITY_FACTOR * e_p + GRAD_PARITY_FLOOR, e_p


def rel_err(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def jit_to_static_eval(torch, dev, model, ids, out):
    """Part 1, on a model of ``JIT_CUT_LAYERS`` layers: the to_static
    eval forward against eager (bert_parity's eval bound), the first
    call's seconds, ms per call in turns, and the profile's flash and
    LayerNorm forward records against the counters."""
    from paddle_tpu_torch import jit

    tol, e_p = jit_eval_bound(torch, model, ids)
    with torch.no_grad():
        ref = model(ids)
        static = jit.to_static(model)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = static(ids)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
    err = rel_err(got, ref)
    if not err <= tol:
        raise AssertionError(f"jit_deploy to_static eval: logits rel err "
                             f"{err:.3e} > {tol:.3e}")
    fwd = static.forward
    eager_fwd = fwd._orig
    times = {"to_static": [], "eager": []}
    with torch.no_grad():
        for turn in ("to_static", "eager", "eager", "to_static"):
            fn = fwd if turn == "to_static" else eager_fwd
            times[turn].append(cuda_ms(lambda: fn(ids), 10))
        _, recs, fig, _ = profiled_launches(
            torch, "to_static eval", lambda: fwd(ids),
            eval_launches(model), host=True)
    out["to_static_eval"] = {
        "layers": model.config.num_hidden_layers,
        "batch": list(ids.shape), "logit_rel_err": err, "bound": tol,
        "plain_bf16_rel_err": e_p, "first_call_s": compile_s,
        "ms": times, "profile_records": recs, "profile": fig}
    # back to the eager forward for what follows
    del model.forward
    return ref


def jit_save_predict(torch, dev, model, tmp, out):
    """Part 2, on the whole model: jit.save with a dynamic batch,
    jit.load and a Predictor, batches 1, 8 and 32 against eager; one
    predictor.run profiled: its flash and LayerNorm forward records
    equal to the counters (12 and 26 at BERT-base), no library
    LayerNorm or SDPA kernel."""
    from paddle_tpu_torch import inference, jit

    prefix = os.path.join(tmp, "bert_mlm")
    t0 = time.perf_counter()
    jit.save(model, prefix, input_spec=[
        jit.InputSpec([None, BERT_SEQ], "int64", "input_ids")])
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = jit.load(prefix)
    pred = inference.create_predictor(inference.Config(
        prefix + ".pdmodel", prefix + ".pdiparams"))
    load_s = time.perf_counter() - t0
    if pred.get_input_names() != ["input_ids"]:
        raise AssertionError(f"jit_deploy: predictor inputs "
                             f"{pred.get_input_names()}")
    g = torch.Generator(device="cpu").manual_seed(77)
    errs = {}
    for b in JIT_PREDICT_BATCHES:
        ids = torch.randint(0, model.config.vocab_size, (b, BERT_SEQ),
                            generator=g)
        with torch.no_grad():
            ref = model(ids.to(dev))
            tol, _ = jit_eval_bound(torch, model, ids.to(dev))
            via_load = loaded(ids.to(dev))
        h = pred.get_input_handle("input_ids")
        h.copy_from_cpu(ids.numpy())
        pred.run()
        via_pred = torch.from_numpy(pred.get_output_handle(
            pred.get_output_names()[0]).copy_to_cpu()).to(dev)
        e_l, e_p = rel_err(via_load, ref), rel_err(via_pred, ref)
        if not (e_l <= tol and e_p <= tol):
            raise AssertionError(f"jit_deploy predict b{b}: rel err load "
                                 f"{e_l:.3e} predictor {e_p:.3e} > "
                                 f"{tol:.3e}")
        errs[b] = {"jit_load": e_l, "predictor": e_p, "bound": tol}
    prof, recs, fig, _ = profiled_launches(
        torch, "predictor", pred.run, eval_launches(model), host=True)
    recs["library_norm_or_sdpa"] = kernel_counts(prof, JIT_LIBRARY_KERNELS)
    if recs["library_norm_or_sdpa"]:
        raise AssertionError(f"jit_deploy predictor profile: {recs}")
    out["save_predict"] = {
        "save_s": save_s, "load_s": load_s,
        "pdmodel_bytes": os.path.getsize(prefix + ".pdmodel"),
        "pdiparams_bytes": os.path.getsize(prefix + ".pdiparams"),
        "rel_err_by_batch": errs, "profile_records": recs,
        "profile": fig}


def jit_train_through_to_static(torch, dev, cfg, batch, out):
    """Part 3, at ``JIT_CUT_LAYERS`` layers of ``cfg``'s width: one
    training step's loss and gradients with a to_static forward and
    eager ``loss.backward()`` against an f32 copy's plain step, within
    bert_parity's bound (GRAD_PARITY_FACTOR times the eager
    kernel path's own error plus the floor: at BERT's initial weights
    the q and k gradients are a small difference that rounding swamps,
    so two bf16 paths that round differently are not held to each
    other); the step launches the LayerNorm backward, dQ and dK/dV."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.models.bert import BertForMaskedLM
    from paddle_tpu_torch.ops import kernel_launches, reset_kernel_launches

    cfg = dataclasses.replace(cfg, num_hidden_layers=JIT_CUT_LAYERS)
    model = BertForMaskedLM(cfg, device=dev, dtype=torch.bfloat16, seed=3)
    model.train()
    model32 = copy.deepcopy(model).float()

    def grads(m):
        m.zero_grad(set_to_none=True)
        loss = bert_loss(m, *batch)
        loss.backward()
        res = {n: p.grad.float() for n, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
        return loss.item(), res

    eager = grads(model)
    with functional_plain_path(torch):
        f32 = grads(model32)
    del model32
    jit.to_static(model)
    t0 = time.perf_counter()
    grads(model)                          # the capture (forward + backward)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    reset_kernel_launches()
    static = grads(model)
    launches = kernel_launches()
    n = JIT_CUT_LAYERS
    per_step = dict(BERT_FLASH_PER_STEP, flash_fwd=n, flash_bwd_dq=n,
                    flash_bwd_dkv=n, layer_norm=2 * n + 2,
                    layer_norm_bwd=2 * n + 2)
    if {k: launches[k] for k in per_step} != per_step:
        raise AssertionError(f"jit_deploy train: launches {launches}, want "
                             f"{per_step}")
    worst, report = grad_parity("jit_deploy train", static, eager, f32,
                                loss_floor=bf16_ulp(f32[0]),
                                zero_truth=("self_attn.k_proj.bias",))
    out["train_to_static"] = {
        "layers": n, "loss_eager": eager[0], "loss_to_static": static[0],
        "loss_f32": f32[0], "first_step_s": compile_s,
        "worst_err_over_tol": worst,
        "largest_grad_rel_err_to_static_vs_eager": sorted(
            report.items(), key=lambda kv: -kv[1][0])[:5],
        "launches": launches}
    del model


def jit_train_step(torch, dev, cfg):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.bert import BertForMaskedLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    model = BertForMaskedLM(cfg, device=dev, dtype=torch.bfloat16, seed=5)
    model.train()
    opt = AdamW(learning_rate=BERT_LR, parameters=model.named_parameters(),
                weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0),
                multi_precision=True, device=dev)
    return model, opt, TrainStep(model, bert_loss, opt, device=dev)


#: each counted kernel's records in a profile: one record per launch
#: (the dK/dV reduction kernel is left out: it follows the dK/dV kernel
#: and is not counted on its own)
JIT_STEP_KERNELS = {
    "flash_fwd": JIT_FLASH_FWD_KERNELS,
    "flash_bwd_dq": ("flash_bwd_dq_kernel", "flash_bwd_dq_sm90_kernel"),
    "flash_bwd_dkv": ("flash_bwd_dkv_kernel", "flash_bwd_dkv_sm90_kernel"),
    "layer_norm": JIT_LN_FWD_KERNELS,
    "layer_norm_bwd": ("ln_bwd_warp_kernel", "ln_bwd_row_kernel"),
}


def eval_launches(model):
    """The counted launches of one eval forward of a BertForMaskedLM: a
    flash forward a layer, two LayerNorms a layer and two more."""
    n = model.config.num_hidden_layers
    return {"flash_fwd": n, "layer_norm": 2 * n + 2}


def profiled_launches(torch, what, run, want, windows=3, host=False):
    """``run()`` profiled (:func:`profile_run`; device events only unless
    ``host``): the counters' rise over the profiled run must equal
    ``want`` and the profile's kernel records, for each kernel of
    ``want`` -> (profile, records, figures, windows used).  For a replayed CUDA graph the rise is what
    ``TrainStep`` adds per replay, so this holds that tally to what the
    card ran.  The profiler can lose a record late in a long process
    (PERF.md, Findings), never add one: a window with more records than
    the rise fails at once, one with fewer is profiled again, up to
    ``windows`` times, and the first window that matches passes."""
    from paddle_tpu_torch.ops import kernel_launches

    seen = []
    for used in range(1, windows + 1):
        base = {}
        prof, fig = profile_run(
            torch, run, host=host,
            between=lambda: base.update(kernel_launches()))
        now = kernel_launches()
        recs = {n: kernel_counts(prof, JIT_STEP_KERNELS[n]) for n in want}
        rise = {n: now[n] - base[n] for n in want}
        seen.append(recs)
        if rise != want or any(recs[n] > rise[n] for n in rise):
            break
        if recs == rise:
            return prof, recs, fig, used
    raise AssertionError(f"jit_deploy {what}: profile records {seen}, "
                         f"counters {rise}, want {want}")


def train_state(model, opt, scaler=None):
    """A step's whole state: parameters, buffers, optimizer and scaler."""
    st = dict(model.state_dict())
    st.update({f"opt.{n}": v for n, v in opt.state_dict().items()})
    if scaler is not None:
        st.update({f"scaler.{n}": v for n, v in scaler.state_dict().items()})
    return st


def differing(torch, a, b):
    """The names whose values differ (tensors bitwise)."""
    return [n for n in a if not (
        torch.equal(a[n], b[n]) if isinstance(a[n], torch.Tensor)
        else a[n] == b[n])]


def jit_many(torch, dev, cfg, out):
    """Part 4: TrainStep.many(K) as one CUDA graph against K eager steps:
    after three packs (the first eager, then captured; two replays)
    every loss, parameter and optimizer state bitwise equal to 3K eager
    steps'; then replays and eager packs in turns, sequences/s and the
    idle share of each, one replay and each step of one eager pack
    profiled with the counters' rise held to the profile's kernel
    records; then the loss
    scaler under replay (:func:`jit_many_scaler`); then with hidden
    dropout 0.1 the losses are finite and the masks differ from step to
    step and pack to pack."""
    from paddle_tpu_torch import random as prandom

    k = JIT_MANY_K
    packs = [[bert_batch(torch, cfg, BERT_BATCH, BERT_SEQ, dev, 500 + 10 * j
                         + i) for i in range(k)] for j in range(3)]
    prandom.seed(11)
    m_g, o_g, s_g = jit_train_step(torch, dev, cfg)
    prandom.seed(11)
    m_e, o_e, s_e = jit_train_step(torch, dev, cfg)
    t0 = time.perf_counter()
    got = [s_g.many(packs[0])]
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    got += [s_g.many(p) for p in packs[1:]]
    eager = [s_e(*b) for p in packs for b in p]
    if not torch.equal(torch.cat(got), torch.stack(eager)):
        raise AssertionError("jit_deploy many: losses differ from eager")
    differ = differing(torch, train_state(m_g, o_g),
                       train_state(m_e, o_e))
    if differ:
        raise AssertionError(f"jit_deploy many: state differs from eager "
                             f"steps: {differ[:5]}")
    times = {"graph": [], "eager": []}
    for turn in JIT_TURNS:
        t1 = time.perf_counter()
        if turn == "graph":
            s_g.many(packs[0]).sum().item()
        else:
            torch.stack([s_e(*b) for b in packs[0]]).sum().item()
        times[turn].append(time.perf_counter() - t1)
    want = {n: BERT_FLASH_PER_STEP[n] * k for n in JIT_STEP_KERNELS}
    _, recs_g, fig_g, win_g = profiled_launches(
        torch, "many replay", lambda: s_g.many(packs[1]).sum().item(), want)
    # the eager pack step by step: each step's records held to its own
    # rise, the pack's to their sum (a ~56,000-kernel window late in the
    # script lost records in all of its windows in one run)
    step_want = {n: BERT_FLASH_PER_STEP[n] for n in JIT_STEP_KERNELS}
    recs_e, win_e = dict.fromkeys(want, 0), []
    for b in packs[1]:
        _, r, fig_e, w = profiled_launches(
            torch, "many eager step", lambda b=b: s_e(*b).item(), step_want)
        recs_e = {n: recs_e[n] + r[n] for n in want}
        win_e.append(w)
    if recs_e != want:
        raise AssertionError(f"jit_deploy many eager: records {recs_e}, "
                             f"want {want}")
    rate = {t: BERT_BATCH * k / statistics.median(v)
            for t, v in times.items()}
    del s_g, s_e
    gc.collect()
    torch.cuda.empty_cache()
    # the profiles may have run one side more packs: the eager side
    # takes the captured side's state, in place
    m_e.set_state_dict(m_g.state_dict())
    o_e.set_state_dict(o_g.state_dict())
    scaler = jit_many_scaler(torch, dev, ((m_g, o_g), (m_e, o_e)), packs)
    del m_g, o_g, m_e, o_e
    gc.collect()
    torch.cuda.empty_cache()
    # dropout 0.1: each step draws its own masks
    drop_cfg = dataclasses.replace(cfg, hidden_dropout_prob=0.1)
    prandom.seed(12)
    m_d, _, s_d = jit_train_step(torch, dev, drop_cfg)
    masks = []
    hook = m_d.bert.embeddings.dropout.register_forward_hook(
        lambda mod, inp, res: masks.append(res.detach() == 0))
    s_d.many(packs[0])                        # eager, then the capture
    captured = masks[k:]                      # refreshed on each replay
    losses, seen = [], []
    for j in range(2):
        losses.append(s_d.many(packs[0]).tolist())
        seen.append([m.clone() for m in captured])
    hook.remove()
    if not all(math.isfinite(x) for ls in losses for x in ls):
        raise AssertionError(f"jit_deploy many dropout: losses {losses}")
    same_step = sum(torch.equal(seen[0][i], seen[0][i + 1])
                    for i in range(k - 1))
    same_pack = sum(torch.equal(seen[0][i], seen[1][i]) for i in range(k))
    if same_step or same_pack:
        raise AssertionError(f"jit_deploy many dropout: {same_step} equal "
                             f"masks between steps, {same_pack} between "
                             "packs")
    del m_d, s_d, masks, captured, seen
    out["many"] = {
        "k": k, "batch": BERT_BATCH, "seq": BERT_SEQ,
        "first_pack_and_capture_s": capture_s,
        "bitwise_equal_to_eager": "losses, parameters, optimizer state "
                                  "after 3 packs (2 replays)",
        "replay_profile_records": recs_g, "eager_profile_records": recs_e,
        "profile_windows": {"replay": win_g, "eager": win_e},
        "pack_s": times, "seqs_per_s": rate, "graph_profile": fig_g,
        "eager_profile": fig_e, "scaler": scaler,
        "dropout_losses": losses,
        "dropout_masks": "differ between all steps and packs"}


def jit_many_scaler(torch, dev, pairs, packs):
    """``many`` with a GradScaler against eager steps, on two equal
    (model, optimizer) ``pairs`` (those the steps without a scaler
    left), over three packs of 2 steps (the first eager, then captured;
    two replays): before the first replay the scale is set to +inf
    (every step overflows and is skipped), before the second the state
    is loaded back at 2**12.  A replay that read the scale it captured
    would update where the eager steps skip.  Losses, parameters,
    optimizer and scaler state bitwise equal to the eager steps'."""
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.jit import TrainStep

    scalers = [GradScaler(init_loss_scaling=2.0 ** 15, device=dev)
               for _ in pairs]
    (m_g, o_g), (m_e, o_e) = pairs
    s_g, s_e = (TrainStep(m, bert_loss, o, scaler=sc, device=dev)
                for (m, o), sc in zip(pairs, scalers))
    k = 2
    got, eager = [], []
    for j, pack in enumerate(p[:k] for p in packs):
        if j == 1:
            for sc in scalers:
                sc.set_init_loss_scaling(float("inf"))
            held = [p.clone() for p in m_g.parameters()]
        if j == 2:
            moved = sum(not torch.equal(a, p)
                        for a, p in zip(held, m_g.parameters()))
            if moved:
                raise AssertionError(f"jit_deploy many scaler: {moved} "
                                     f"parameters moved at scale inf")
            del held
            for sc in scalers:
                sc.load_state_dict(dict(sc.state_dict(), scale=2.0 ** 12))
        got.append(s_g.many(pack))
        eager += [s_e(*b) for b in pack]
    if not torch.equal(torch.cat(got), torch.stack(eager)):
        raise AssertionError("jit_deploy many scaler: losses differ")
    differ = differing(torch, train_state(m_g, o_g, scalers[0]),
                       train_state(m_e, o_e, scalers[1]))
    if differ:
        raise AssertionError(f"jit_deploy many scaler: state differs from "
                             f"eager steps: {differ[:5]}")
    return {"k": k, "packs": 3, "replay_at_inf_scale": "every step skipped",
            "final_scale": scalers[0].get_loss_scaling().item(),
            "bitwise_equal_to_eager": "losses, parameters, optimizer and "
                                      "scaler state"}


def jit_dy2static_decode(torch, dev, tmp, out):
    """Part 5: the JAX test's greedy decode with a data-dependent early
    exit (``tests/test_jit_io_amp.py:684``), saved and loaded on the
    card, equal to eager; both exits taken."""
    from paddle_tpu_torch import jit, nn
    import paddle_tpu_torch as paddle

    class Dec(nn.Layer):
        def __init__(self):
            super().__init__()
            self.lin = nn.Linear(4, 4, device=dev)

        def forward(self, h):
            n = 0
            while n < 8:
                h = self.lin(h)
                if paddle.max(paddle.abs(h)) < 0.05:
                    return h * 0.0
                n = n + 1
            return h

    m = Dec()
    m.eval()
    with torch.no_grad():
        m.lin.weight.copy_(torch.eye(4, device=dev) * 0.1)
        m.lin.bias.zero_()
    path = os.path.join(tmp, "dec")
    jit.save(m, path, input_spec=[jit.InputSpec([1, 4])])
    if "forward" in m.__dict__:
        raise AssertionError("jit_deploy decode: the export's forward was "
                             "left on the instance")
    loaded = jit.load(path)
    res = {}
    # h shrinks 10x a step: from 1 it falls under 0.05 at the second step
    # (the early return); from 1e8 it is still 1 after the eighth
    for name, start in (("early_exit", 1.0), ("runs_out", 1e8)):
        x = torch.full((1, 4), start, device=dev)
        with torch.no_grad():
            ref, got = m(x), loaded(x)
        if not torch.equal(ref, got):
            raise AssertionError(f"jit_deploy decode {name}: {got} vs {ref}")
        res[name] = got.tolist()
    out["dy2static_decode"] = res


def jit_deploy_phase(torch, dev):
    """``to_static`` -> ``jit.save`` -> ``inference.create_predictor`` on
    BERT-base bf16 at full width (PaddleNLP's deployment flow), training
    through ``to_static``, ``TrainStep.many`` as one CUDA graph, and the
    dy2static decode (see the five parts above)."""
    import tempfile

    from paddle_tpu_torch import random as prandom
    from paddle_tpu_torch.models.bert import BERT_BASE, BertForMaskedLM
    from paddle_tpu_torch.ops import kernel_launches, reset_kernel_launches

    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(BERT_BASE, hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    out = {"phase": "jit_deploy", "model": "BERT_BASE", "dtype": "bfloat16",
           "seq": BERT_SEQ}
    reset_kernel_launches()
    prandom.seed(2024)
    g = torch.Generator(device="cpu").manual_seed(31)
    ids = torch.randint(0, cfg.vocab_size, (JIT_EVAL_BATCH, BERT_SEQ),
                        generator=g).to(dev)
    parts = {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        fn(*args)
        parts[name] = time.perf_counter() - t0
        emit({"phase": f"jit_deploy/{name}", "seconds": parts[name],
              **{k: v for k, v in out[name].items() if k != "profile"}})
        gc.collect()
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        small = BertForMaskedLM(
            dataclasses.replace(cfg, num_hidden_layers=JIT_CUT_LAYERS),
            device=dev, dtype=torch.bfloat16, seed=9).eval()
        part("to_static_eval", jit_to_static_eval, torch, dev, small, ids,
             out)
        del small
        model = BertForMaskedLM(cfg, device=dev, dtype=torch.bfloat16,
                                seed=9).eval()
        part("save_predict", jit_save_predict, torch, dev, model, tmp, out)
        del model
        batch = bert_batch(torch, cfg, BERT_BATCH, BERT_SEQ, dev, 4321)
        part("train_to_static", jit_train_through_to_static, torch, dev,
             cfg, batch, out)
        part("many", jit_many, torch, dev, cfg, out)
        part("dy2static_decode", jit_dy2static_decode, torch, dev, tmp, out)
    out["part_seconds"] = parts
    emit(out)
    launches = kernel_launches()
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ phase 34
STATIC_STEPS = 4
STATIC_AMP_FINITE_RUNS = 4


def static_state_equal(torch, smodel, sopt, emodel, eopt):
    """The names of the parameters (and AdamW moments) of a static model
    and an eager one that differ bitwise, pairing them in module order."""
    bad = []
    for (n, sp), ep in zip(smodel.named_parameters(), emodel.parameters()):
        if not torch.equal(sp, ep):
            bad.append(n)
        s_st = sopt._accumulators.get(id(sp), {})
        e_st = eopt._accumulators.get(id(ep), {})
        if set(s_st) != set(e_st) or any(
                not torch.equal(s_st[k], e_st[k]) for k in s_st):
            bad.append(n + ".moments")
    return bad


def static_bert_program(torch, dev, cfg, dtype, seed, batch_shape,
                        checkpoints=False):
    """BertForMaskedLM's MLM loss recorded as a static program ->
    (program, startup, model, feeds (ids, types, labels), loss, logits,
    each layer's output, record seconds).  The forward is the model's
    own, layer by layer, so that each layer's output can be a recompute
    checkpoint."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    from paddle_tpu_torch.models.bert import BertForMaskedLM
    from paddle_tpu_torch.nn import functional as F

    main, startup = static.Program(), static.Program()
    paddle.enable_static()
    try:
        with static.program_guard(main, startup):
            model = BertForMaskedLM(cfg, device=dev, dtype=dtype, seed=seed)
            t0 = time.perf_counter()
            ids = static.data("input_ids", batch_shape, "int64")
            types = static.data("token_type_ids", batch_shape, "int64")
            labels = static.data("labels", batch_shape, "int64")
            x = model.bert.embeddings(ids, types)
            outs = []
            for layer in model.bert.encoder.layers:
                x = layer(x, None)
                outs.append(x)
            logits = model.cls(x)
            loss = F.cross_entropy(logits.reshape(-1, cfg.vocab_size),
                                   labels.reshape(-1), ignore_index=-100)
            record_s = time.perf_counter() - t0
    finally:
        paddle.disable_static()
    return (main, startup, model, (ids, types, labels), loss, logits, outs,
            record_s)


def static_feed(batch):
    return dict(zip(("input_ids", "token_type_ids", "labels"), batch))


def static_train(torch, dev, cfg, batches, out):
    """Part 1: the program trained by AdamW(1e-4) through ``minimize``
    against an identical eager model's steps, in turns, bitwise; the
    counters' rise of one run against one eager step's and a profile's
    records."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    from paddle_tpu_torch.models.bert import BertForMaskedLM
    from paddle_tpu_torch.ops import kernel_launches
    from paddle_tpu_torch.optimizer import AdamW

    t0 = time.perf_counter()
    main, startup, smodel, feeds, loss, logits, _, record_s = \
        static_bert_program(torch, dev, cfg, torch.bfloat16, 9,
                            [BERT_BATCH, BERT_SEQ])
    paddle.enable_static()
    try:
        with static.program_guard(main, startup):
            sopt = AdamW(learning_rate=1e-4)        # parameters=None
            sopt.minimize(loss)
    finally:
        paddle.disable_static()
    build_s = time.perf_counter() - t0
    emodel = BertForMaskedLM(cfg, device=dev, dtype=torch.bfloat16, seed=9)
    eopt = AdamW(learning_rate=1e-4, parameters=emodel.parameters(),
                 device=dev)
    if static_state_equal(torch, smodel, sopt, emodel, eopt):
        raise AssertionError("static_graph: the two models start apart")
    exe = static.Executor()
    exe.run(startup)

    def static_run(batch):
        return exe.run(main, feed=static_feed(batch), fetch_list=[loss],
                       return_numpy=False)[0]

    def eager_step(batch):
        el = bert_loss(emodel, *batch)
        el.backward()
        eopt.step()
        eopt.clear_grad()
        return el

    s_losses, e_losses, s_times, e_times = [], [], [], []
    rises = {}
    for i, batch in enumerate(batches):
        for kind in (("static", "eager") if i % 2 == 0
                     else ("eager", "static")):
            base = kernel_launches()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if kind == "static":
                v = static_run(batch)
            else:
                v = eager_step(batch)
            torch.cuda.synchronize()
            (s_times if kind == "static" else e_times).append(
                time.perf_counter() - t1)
            (s_losses if kind == "static" else e_losses).append(v.detach())
            rises.setdefault(kind, []).append(
                {k: n - base[k] for k, n in kernel_launches().items()
                 if n != base[k]})
    differ = [i for i, (a, b) in enumerate(zip(s_losses, e_losses))
              if not torch.equal(a, b)]
    state = static_state_equal(torch, smodel, sopt, emodel, eopt)
    if differ or state:
        raise AssertionError(f"static_graph: static steps {differ} and "
                             f"state {state[:6]} differ from eager")
    want = dict(BERT_FLASH_PER_STEP)
    for kind in ("static", "eager"):
        for r in rises[kind]:
            if r != want:
                raise AssertionError(f"static_graph {kind} run launched {r}"
                                     f", want {want}")
    batch = batches[0]
    prof, recs, fig, windows = profiled_launches(
        torch, "static run", lambda: static_run(batch), want)
    out["train"] = {
        "build_s": build_s, "record_s": record_s,
        "nodes": len(main.nodes),
        "params": len(sopt._parameter_list),
        "losses": [x.float().item() for x in s_losses],
        "static_run_s": s_times, "eager_step_s": e_times,
        "static_run_s_median": statistics.median(s_times),
        "eager_step_s_median": statistics.median(e_times),
        "static_over_eager": (statistics.median(s_times)
                              / statistics.median(e_times)),
        "launches_per_run": rises["static"][0],
        "profile_records": recs, "profile_windows": windows,
        "device_idle_share": fig["device_idle_share"], "profile": fig}
    return main, feeds, logits, smodel, exe


def static_inference(torch, dev, tmp, main, feeds, logits, model, exe,
                     batch, out):
    """Part 2: the test clone's logits through ``save_inference_model``
    and ``inference.create_predictor``, bitwise against ``Executor.run``
    of the same program; one predictor.run profiled."""
    from paddle_tpu_torch import inference, static

    test_prog = main.clone(for_test=True)
    feed = static_feed(batch[:2])
    want = exe.run(test_prog, feed=feed, fetch_list=[logits],
                   return_numpy=False)[0]
    prefix = os.path.join(tmp, "static_bert")
    t0 = time.perf_counter()
    static.save_inference_model(prefix, list(feeds[:2]), [logits], exe)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = inference.create_predictor(inference.Config(
        prefix + ".pdmodel", prefix + ".pdiparams"))
    load_s = time.perf_counter() - t0
    if pred.get_input_names() != ["input_ids", "token_type_ids"]:
        raise AssertionError(f"static_graph: predictor inputs "
                             f"{pred.get_input_names()}")
    for name in ("input_ids", "token_type_ids"):
        pred.get_input_handle(name).copy_from_cpu(feed[name].cpu().numpy())
    pred.run()
    got = torch.from_numpy(pred.get_output_handle(
        pred.get_output_names()[0]).copy_to_cpu())
    if not torch.equal(got, want.float().cpu()):
        raise AssertionError(
            f"static_graph: predictor logits differ from Executor.run's "
            f"(max {(got - want.float().cpu()).abs().max().item():.3e})")
    prof, recs, fig, windows = profiled_launches(
        torch, "static predictor", pred.run, eval_launches(model),
        host=True)
    recs["library_norm_or_sdpa"] = kernel_counts(prof, JIT_LIBRARY_KERNELS)
    if recs["library_norm_or_sdpa"]:
        raise AssertionError(f"static_graph predictor profile: {recs}")
    out["inference"] = {
        "save_s": save_s, "load_s": load_s,
        "pdmodel_bytes": os.path.getsize(prefix + ".pdmodel"),
        "pdiparams_bytes": os.path.getsize(prefix + ".pdiparams"),
        "bitwise_equal_to_executor": True, "profile_records": recs,
        "profile_windows": windows,
        "device_idle_share": fig["device_idle_share"]}


def static_amp_recompute(torch, dev, cfg, batches, out):
    """Part 3, at JIT_CUT_LAYERS layers of full width: float16
    ``static.amp.decorate`` (two runs at the largest f32 scale skip
    bitwise and shrink it by decr_ratio; then finite runs, a
    white-listed op's output float16, the loss float32), and recompute
    at each layer's output bitwise against no recompute."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    from paddle_tpu_torch.distributed.fleet import (
        DistributedStrategy, StaticMetaOptimizer,
    )
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.static.graph import SymbolicTensor

    small = dataclasses.replace(cfg, num_hidden_layers=JIT_CUT_LAYERS)
    main, startup, model, feeds, loss, logits, _, amp_record_s = \
        static_bert_program(torch, dev, small, torch.float32, 21,
                            [BERT_BATCH, BERT_SEQ])
    paddle.enable_static()
    try:
        with static.program_guard(main, startup):
            opt = static.amp.decorate(AdamW(learning_rate=1e-4),
                                      dtype="float16")
            opt.minimize(loss)
    finally:
        paddle.disable_static()
    # the first white-listed node (the first layer's q/k/v product)
    node = next(n for n in main.nodes if n.op_name == "linear"
                and n.n_out == 1 and n.out_fakes[0].dim() == 3)
    white = SymbolicTensor(node.out_fakes[0], node, 0)
    exe = static.Executor()
    scaler = opt._static_amp_scaler
    cfg_amp = scaler["cfg"]
    params = list(opt._parameter_list)
    before = [p.detach().clone() for p in params]
    fmax = torch.tensor(torch.finfo(torch.float32).max, device=dev)
    scaler["state"]["scale"] = fmax.clone()
    inf_losses = []
    for batch in batches[:2]:
        inf_losses.append(exe.run(main, feed=static_feed(batch),
                                  fetch_list=[loss],
                                  return_numpy=False)[0].item())
    moved = [i for i, (p, b) in enumerate(zip(params, before))
             if not torch.equal(p, b)]
    fresh = [i for i, p in enumerate(params) if any(
        not torch.equal(v, w) for v, w in zip(
            opt._accumulators[id(p)].values(),
            opt.inner_opt._init_state(p).values()))]
    scale = scaler["state"]["scale"]
    want_scale = fmax * float(cfg_amp["decr_ratio"])
    if moved or fresh or not torch.equal(scale, want_scale):
        raise AssertionError(
            f"static_graph amp: the +inf runs moved params {moved[:4]} or "
            f"moments {fresh[:4]}, or the scale is {scale.item()} (want "
            f"{want_scale.item()})")
    scaler["state"]["scale"] = torch.tensor(
        float(cfg_amp["init_loss_scaling"]), device=dev)
    finite = []
    for i in range(STATIC_AMP_FINITE_RUNS):
        lv, wv = exe.run(main, feed=static_feed(batches[i % len(batches)]),
                         fetch_list=[loss, white], return_numpy=False)
        finite.append(lv.item())
        if wv.dtype != torch.float16 or lv.dtype != torch.float32:
            raise AssertionError(f"static_graph amp: white op {wv.dtype}, "
                                 f"loss {lv.dtype}")
    if not all(math.isfinite(x) for x in finite) or all(
            torch.equal(p, b) for p, b in zip(params, before)):
        raise AssertionError(f"static_graph amp: finite runs {finite}")
    amp = {"record_s": amp_record_s, "nodes": len(main.nodes),
           "inf_scale_losses": inf_losses,
           "scale_after_inf_runs": scale.item(),
           "finite_losses": finite,
           "scale_after": opt.get_loss_scaling(),
           "white_op": node.op_name, "white_dtype": "float16",
           "loss_dtype": "float32"}
    del main, startup, model, opt, exe, white, node
    gc.collect()
    torch.cuda.empty_cache()

    runs = {}
    for remat in (False, True):
        main, startup, model, feeds, loss, logits, outs, _ = \
            static_bert_program(torch, dev, small, torch.bfloat16, 23,
                                [BERT_BATCH, BERT_SEQ])
        strat = DistributedStrategy()
        if remat:
            strat.recompute = True
            strat.recompute_configs = {"checkpoints": outs}
        paddle.enable_static()
        try:
            with static.program_guard(main, startup):
                opt = StaticMetaOptimizer(AdamW(learning_rate=1e-4), strat)
                _, pairs = opt.minimize(loss)
        finally:
            paddle.disable_static()
        exe = static.Executor()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        losses, grads = [], None
        for batch in batches[:2]:
            res = exe.run(main, feed=static_feed(batch),
                          fetch_list=[loss] + [g for _, g in pairs],
                          return_numpy=False)
            losses.append(res[0])
            grads = res[1:]
        runs[remat] = {"losses": losses, "grads": grads,
                       "state": [p.detach().clone() for p in
                                 opt._parameter_list],
                       "peak_gb": (torch.cuda.max_memory_allocated()
                                   - base) / 1e9}
        del main, startup, model, opt, exe, pairs, feeds, loss, logits, outs
        gc.collect()
        torch.cuda.empty_cache()
    a, b = runs[False], runs[True]
    same = (all(torch.equal(x, y) for x, y in zip(a["losses"], b["losses"]))
            and all(torch.equal(x, y) for x, y in zip(a["grads"], b["grads"]))
            and all(torch.equal(x, y) for x, y in zip(a["state"],
                                                      b["state"])))
    if not same:
        raise AssertionError("static_graph: recompute differs from no "
                             "recompute")
    out["amp_recompute"] = {
        "layers": JIT_CUT_LAYERS, "amp": amp,
        "recompute": {"losses": [x.float().item() for x in a["losses"]],
                      "bitwise_equal": True,
                      "peak_gb_above_start": {"plain": a["peak_gb"],
                                              "recompute": b["peak_gb"]}}}


def static_graph_phase(torch, dev):
    """``paddle.static`` on BERT-base bf16 at full width, dropout 0,
    fixed feeds [BERT_BATCH, BERT_SEQ] (the three parts above)."""
    import tempfile

    from paddle_tpu_torch import random as prandom
    from paddle_tpu_torch.models.bert import BERT_BASE
    from paddle_tpu_torch.ops import kernel_launches, reset_kernel_launches

    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(BERT_BASE, hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    out = {"phase": "static_graph", "model": "BERT_BASE",
           "dtype": "bfloat16", "batch": BERT_BATCH, "seq": BERT_SEQ}
    reset_kernel_launches()
    prandom.seed(2024)
    # int32 ids and labels: a placeholder asked for as int64 is int32 (x64
    # off), and the eager steps take the same tensors
    batches = [tuple(t.int() for t in bert_batch(
        torch, cfg, BERT_BATCH, BERT_SEQ, dev, 500 + i))
        for i in range(STATIC_STEPS)]
    parts = {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        parts[name] = time.perf_counter() - t0
        emit({"phase": f"static_graph/{name}", "seconds": parts[name],
              **{k: v for k, v in out[name].items() if k != "profile"}})
        return res

    main, feeds, logits, model, exe = part(
        "train", static_train, torch, dev, cfg, batches, out)
    with tempfile.TemporaryDirectory() as tmp:
        part("inference", static_inference, torch, dev, tmp, main, feeds,
             logits, model, exe, batches[0], out)
    del main, feeds, logits, model, exe
    gc.collect()
    torch.cuda.empty_cache()
    part("amp_recompute", static_amp_recompute, torch, dev, cfg, batches,
         out)
    launches = kernel_launches()
    out["part_seconds"] = parts
    out["kernel_launches"] = launches
    emit(out)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def static_phases_main(torch):
    """``--static-phases``: static_graph alone; the kernels are built."""
    from paddle_tpu_torch import _build, resolve_device

    smi = nvidia_smi()
    t0 = time.perf_counter()
    built = _build.build_all(verbose=False)
    emit({"phase": "environment", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": time.perf_counter() - t0, "built": sorted(built)})
    dev = resolve_device()
    t0 = time.perf_counter()
    launches = static_graph_phase(torch, dev)
    emit({"phase_seconds": "static_graph",
          "seconds": time.perf_counter() - t0, "launches": launches})
    print(smi)
    return 0


def jit_phases_main(torch):
    """``--jit-phases``: jit_deploy alone; the kernels are built."""
    from paddle_tpu_torch import _build, resolve_device

    smi = nvidia_smi()
    t0 = time.perf_counter()
    built = _build.build_all(verbose=False)
    emit({"phase": "environment", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": time.perf_counter() - t0, "built": sorted(built)})
    dev = resolve_device()
    t0 = time.perf_counter()
    launches = jit_deploy_phase(torch, dev)
    emit({"phase_seconds": "jit_deploy", "seconds": time.perf_counter() - t0,
          "launches": launches})
    print(smi)
    return 0


def host_phases_main(torch):
    """``--host-phases``: host_api alone; the kernels are built (its
    PyLayer runs the RMSNorm kernels, its BERT steps the LayerNorm
    ones)."""
    from paddle_tpu_torch import _build, resolve_device

    smi = nvidia_smi()
    t0 = time.perf_counter()
    built = _build.build_all(verbose=False)
    emit({"phase": "environment", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "cudnn": torch.backends.cudnn.version(),
          "build_s": time.perf_counter() - t0, "built": sorted(built)})
    dev = resolve_device()
    t0 = time.perf_counter()
    launches, figures = host_api_phase(torch, dev)
    emit({"phase_seconds": "host_api", "seconds": time.perf_counter() - t0,
          "launches": launches})
    print(smi)
    return 0


def zoo_phases_main(torch):
    """``--zoo-phases``: zoo_train, zoo_forward, zoo_parity and
    vision_ops alone (no CUDA kernel of the port lies on their path, so
    none is built), each with its own checks."""
    from paddle_tpu_torch import resolve_device

    smi = nvidia_smi()
    emit({"phase": "environment", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "cudnn": torch.backends.cudnn.version()})
    dev = resolve_device()
    for name, fn in (("zoo_train", zoo_train_phase),
                     ("zoo_forward", zoo_forward_phase),
                     ("zoo_parity", zoo_parity_phase),
                     ("vision_ops", vision_ops_phase)):
        t0 = time.perf_counter()
        fn(torch, dev)
        emit({"phase_seconds": name, "seconds": time.perf_counter() - t0})
    print(smi)
    return 0


def seq2seq_phases_main(torch):
    """``--seq2seq-phases``: seq2seq_train, seq2seq_decode,
    seq2seq_parity and tensor_surface alone (no CUDA kernel of the port
    lies on their path, so none is built), each with its own checks."""
    from paddle_tpu_torch import resolve_device

    smi = nvidia_smi()
    emit({"phase": "environment", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "cudnn": torch.backends.cudnn.version()})
    dev = resolve_device()
    for name, fn in (("seq2seq_train", seq2seq_train_phase),
                     ("seq2seq_decode", seq2seq_decode_phase),
                     ("seq2seq_parity", seq2seq_parity_phase),
                     ("tensor_surface", tensor_surface_phase)):
        t0 = time.perf_counter()
        fn(torch, dev)
        emit({"phase_seconds": name, "seconds": time.perf_counter() - t0})
    print(smi)
    return 0


def hapi_phases_main(torch):
    """``--hapi-phases``: hapi_fit and hapi_fit_bert alone; the kernels
    are built because hapi_fit_bert's BERT runs the LayerNorm and flash
    kernels."""
    from paddle_tpu_torch import _build, resolve_device

    smi = nvidia_smi()
    t0 = time.perf_counter()
    built = _build.build_all(verbose=False)
    emit({"phase": "environment", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "cudnn": torch.backends.cudnn.version(),
          "build_s": time.perf_counter() - t0, "built": sorted(built)})
    dev = resolve_device()
    t0 = time.perf_counter()
    hapi_fit_phase(torch, dev)
    hapi_fit_bert_phase(torch, dev)
    emit({"phase": "hapi_seconds", "seconds": time.perf_counter() - t0})
    print(smi)
    return 0


def layer_phases_main(torch):
    """``--layer-phases``: bert_train (whose step seconds layer_api sets
    its own beside) and layer_api alone; the kernels are built because
    both run BERT's LayerNorm kernels."""
    from paddle_tpu_torch import _build, resolve_device

    smi = nvidia_smi()
    t0 = time.perf_counter()
    built = _build.build_all(verbose=False)
    emit({"phase": "environment", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "cudnn": torch.backends.cudnn.version(),
          "build_s": time.perf_counter() - t0, "built": sorted(built)})
    dev = resolve_device()
    for name, fn, args in (("bert_train", bert_train_phase, ()),
                           ("layer_api", layer_api_phase, None)):
        t0 = time.perf_counter()
        if args is None:
            fn(torch, dev, bert_figures)
        else:
            _, bert_figures = fn(torch, dev)
        emit({"phase_seconds": name, "seconds": time.perf_counter() - t0})
    print(smi)
    return 0


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
    serving phases' model (:func:`serve_model`) and run only the named
    serve phases (``serve_structured``, ``serve_tier``), each with its
    own checks; for iterating on a phase without the whole script."""
    from paddle_tpu_torch import _build, resolve_device

    names = args[args.index("--serve-phases") + 1].split(",")
    smi = nvidia_smi()
    built = _build.build_all(verbose=False)
    emit({"phase": "environment", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "built": sorted(built)})
    dev = resolve_device()
    model = serve_model(torch, dev)
    phases = {"serve_structured": serve_structured_phase,
              "serve_tier": serve_tier_phase}
    for name in names:
        t0 = time.perf_counter()
        launches = phases[name](torch, dev, model)
        emit({"phase": name, "seconds": time.perf_counter() - t0,
              "launches": launches})
    print(smi)
    return 0


def resnet_phases_main(torch):
    """``--resnet-phases``: resnet_train, resnet_amp and resnet_parity
    alone (no CUDA kernel of the port lies on their path, so none is
    built), each with its own checks."""
    from paddle_tpu_torch import resolve_device

    smi = nvidia_smi()
    emit({"phase": "environment", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "cudnn": torch.backends.cudnn.version()})
    dev = resolve_device()
    t0 = time.perf_counter()
    _, figures = resnet_train_phase(torch, dev)
    resnet_amp_phase(torch, dev, figures)
    resnet_parity_phase(torch, dev)
    emit({"phase": "resnet_seconds", "seconds": time.perf_counter() - t0})
    print(smi)
    return 0


def fp16_phases_main(torch):
    """``--fp16-phases``: the float16 checks alone: the flash backward's
    determinism and the paged row invariance (both 16-bit types),
    unsupported_raises, then bert_train_flash (bert_amp's yardstick),
    bert_amp, serve_fp16, transformer_mt and lbfgs."""
    from paddle_tpu_torch import _build, resolve_device

    smi = nvidia_smi()
    t0 = time.perf_counter()
    built = _build.build_all(verbose=False)
    emit({"phase": "environment", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": time.perf_counter() - t0, "built": sorted(built)})
    dev = resolve_device()
    seconds = {}
    for name, fn in (
            ("flash_bwd_determinism",
             lambda: flash_bwd_determinism_check(torch, dev, 0)),
            ("paged_invariance", lambda: paged_invariance_check(torch, dev)),
            ("unsupported_raises", lambda: unsupported_check(torch, dev)),
            ("bert_amp", lambda: bert_amp_phase(
                torch, dev, bert_train_flash_phase(torch, dev)[1])),
            ("serve_fp16", lambda: serve_fp16_phase(torch, dev)),
            ("transformer_mt", lambda: transformer_mt_phase(torch, dev)),
            ("lbfgs", lambda: lbfgs_phase(torch, dev))):
        t1 = time.perf_counter()
        fn()
        seconds[name] = time.perf_counter() - t1
        emit({"phase_seconds": name, "seconds": seconds[name]})
    print(smi)
    return 0


def fused_phases_main(torch):
    """``--fused-phases``: fused_decode, fused_rotary and fused_layers
    alone (the kernels built: they run the flash, LayerNorm and RMSNorm
    kernels), each with its kernel launches."""
    from paddle_tpu_torch import _build, resolve_device

    smi = nvidia_smi()
    t0 = time.perf_counter()
    built = _build.build_all(verbose=False)
    emit({"phase": "environment", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": time.perf_counter() - t0, "built": sorted(built)})
    dev = resolve_device()
    for name, fn in (("fused_decode", fused_decode_phase),
                     ("fused_rotary", fused_rotary_phase),
                     ("fused_layers", fused_layers_phase)):
        t1 = time.perf_counter()
        launches = fn(torch, dev)
        emit({"phase_seconds": name, "seconds": time.perf_counter() - t1,
              "kernel_launches": launches})
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
    if "--resnet-phases" in sys.argv[1:]:
        return resnet_phases_main(torch)
    if "--hapi-phases" in sys.argv[1:]:
        return hapi_phases_main(torch)
    if "--fp16-phases" in sys.argv[1:]:
        return fp16_phases_main(torch)
    if "--fused-phases" in sys.argv[1:]:
        return fused_phases_main(torch)
    if "--zoo-phases" in sys.argv[1:]:
        return zoo_phases_main(torch)
    if "--seq2seq-phases" in sys.argv[1:]:
        return seq2seq_phases_main(torch)
    if "--layer-phases" in sys.argv[1:]:
        return layer_phases_main(torch)
    if "--host-phases" in sys.argv[1:]:
        return host_phases_main(torch)
    if "--jit-phases" in sys.argv[1:]:
        return jit_phases_main(torch)
    if "--static-phases" in sys.argv[1:]:
        return static_phases_main(torch)
    from paddle_tpu_torch import _build, resolve_device

    dev = resolve_device()
    smi = nvidia_smi()
    t_start = t0 = time.perf_counter()
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

    seconds = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        emit({"phase_seconds": name, "seconds": seconds[name]})
        return out

    seconds["build"] = build_s
    summary = kernel_phase(torch, dev, phase)
    serve, model, engine_figures = phase("engine", engine_phase, torch, dev)
    del model
    free_device_memory(torch)
    model = phase("serve_model", serve_model, torch, dev)
    serve_prefix = phase("serve_prefix", serve_prefix_phase, torch, dev,
                         model)
    serve_spec = phase("serve_spec", serve_spec_phase, torch, dev, model)
    serve_quant = phase("serve_quant", serve_quant_phase, torch, dev, model)
    serve_gateway = phase("serve_gateway", serve_gateway_phase, torch, dev,
                          model, engine_figures)
    serve_structured = phase("serve_structured", serve_structured_phase,
                             torch, dev, model)
    serve_tier = phase("serve_tier", serve_tier_phase, torch, dev, model)
    del model
    torch.cuda.empty_cache()
    serve_fp16 = phase("serve_fp16", serve_fp16_phase, torch, dev)
    fused_decode = phase("fused_decode", fused_decode_phase, torch, dev)
    fused_rotary = phase("fused_rotary", fused_rotary_phase, torch, dev)
    fused_layers = phase("fused_layers", fused_layers_phase, torch, dev)
    train = phase("train", train_phase, torch, dev)
    phase("train_parity", train_parity_phase, torch, dev)
    unet = phase("unet_train", unet_train_phase, torch, dev)
    phase("unet_train_parity", unet_train_parity_phase, torch, dev)
    bert, bert_figures = phase("bert_train", bert_train_phase, torch, dev)
    bert_flash, flash_figures = phase("bert_train_flash",
                                      bert_train_flash_phase, torch, dev)
    emit({"phase": "bert_attention_dropout_cost",
          "step_s_mean": {"bert_train": bert_figures["step_s_mean"],
                          "bert_train_flash": flash_figures["step_s_mean"]},
          "turns_step_s": flash_figures["turns_step_s"],
          "turns_median_ratio": flash_figures["turns_median_ratio"],
          "peak_memory_gb": {
              "bert_train": bert_figures["peak_memory_gb"],
              "bert_train_flash": flash_figures["peak_memory_gb"]}})
    bert_amp = phase("bert_amp", bert_amp_phase, torch, dev, flash_figures)
    phase("bert_parity", bert_parity_phase, torch, dev)
    phase("train_recompute", train_recompute_phase, torch, dev)
    phase("optimizers", optimizers_phase, torch, dev)
    phase("lbfgs", lbfgs_phase, torch, dev)
    transformer_mt = phase("transformer_mt", transformer_mt_phase, torch,
                           dev)
    resnet, resnet_figures = phase("resnet_train", resnet_train_phase,
                                   torch, dev)
    phase("resnet_amp", resnet_amp_phase, torch, dev, resnet_figures)
    phase("resnet_parity", resnet_parity_phase, torch, dev)
    hapi_fit = phase("hapi_fit", hapi_fit_phase, torch, dev)
    hapi_fit_bert = phase("hapi_fit_bert", hapi_fit_bert_phase, torch, dev,
                          flash_figures)
    zoo_train = phase("zoo_train", zoo_train_phase, torch, dev)
    phase("zoo_forward", zoo_forward_phase, torch, dev)
    phase("zoo_parity", zoo_parity_phase, torch, dev)
    phase("vision_ops", vision_ops_phase, torch, dev)
    seq2seq = phase("seq2seq_train", seq2seq_train_phase, torch, dev)
    phase("seq2seq_decode", seq2seq_decode_phase, torch, dev)
    phase("seq2seq_parity", seq2seq_parity_phase, torch, dev)
    phase("tensor_surface", tensor_surface_phase, torch, dev)
    layer_api, _ = phase("layer_api", layer_api_phase, torch, dev,
                         bert_figures)
    host_api, _ = phase("host_api", host_api_phase, torch, dev)
    jit_deploy = phase("jit_deploy", jit_deploy_phase, torch, dev)
    static_graph = phase("static_graph", static_graph_phase, torch, dev)
    emit({"phase": "seconds", "by_phase": seconds,
          "total": time.perf_counter() - t_start})

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
        # the float16 variants: the same sources at E = F16
        "paged_attention/float16": ("cuda",
                                    "paddle_tpu_torch/csrc/attention_sm90.cuh",
                                    "paddle_tpu/serving/paged_attention.py"
                                    ":284", "serve_fp16"),
        "flash_fwd/float16": ("cuda",
                              "paddle_tpu_torch/csrc/attention_sm90.cuh",
                              "paddle_tpu/ops/pallas/flash.py:132",
                              "bert_amp"),
        "flash_bwd_dq/float16": ("cuda",
                                 "paddle_tpu_torch/csrc/flash_bwd_sm90.cuh",
                                 "paddle_tpu/ops/pallas/flash.py:255",
                                 "bert_amp"),
        "flash_bwd_dkv/float16": ("cuda",
                                  "paddle_tpu_torch/csrc/flash_bwd_sm90.cuh",
                                  "paddle_tpu/ops/pallas/flash.py:277",
                                  "bert_amp"),
    }
    runs = {"serve": serve, "serve_prefix": serve_prefix,
            "serve_spec": serve_spec, "serve_quant": serve_quant,
            "serve_gateway": serve_gateway,
            "serve_structured": serve_structured, "serve_tier": serve_tier,
            "train": train, "unet_train": unet, "bert_train": bert,
            "bert_train_flash": bert_flash, "resnet_train": resnet,
            "hapi_fit": hapi_fit, "hapi_fit_bert": hapi_fit_bert,
            "serve_fp16": serve_fp16, "bert_amp": bert_amp,
            "transformer_mt": transformer_mt, "fused_decode": fused_decode,
            "fused_rotary": fused_rotary, "fused_layers": fused_layers,
            "zoo_train": zoo_train, "seq2seq_train": seq2seq,
            "layer_api": layer_api, "host_api": host_api,
            "jit_deploy": jit_deploy, "static_graph": static_graph}
    kernels = []
    for name, (route, source, replaces, path) in sources.items():
        c = summary[name]
        counter = name.split("/")[0]     # a dtype variant's kernel counter
        files = (source,) if isinstance(source, str) else source
        entry = {"name": name, "route": route, "source": files[0],
                 "source_files": list(files), "replaces": replaces,
                 "launches": runs[path][counter],
                 "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                 "device_ms": c.get("device_ms"), "plain_ms": c["plain_ms"],
                 "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                 "library_ms": c["library_ms"], "case": c["name"],
                 "path": path,
                 "launches_by_path": {p: r.get(counter, 0)
                                      for p, r in runs.items()}}
        for tag in ("bert", "fused"):   # the same kernel at BERT's shape
            bc = summary.get(f"{tag}/{name}")   # or fused_decode's prefill
            if bc is not None:
                entry[f"{tag}_case"] = {k: bc.get(k) for k in (
                    "name", "max_abs_err", "ms", "device_ms", "plain_ms",
                    "bound_ms", "bound_by", "library_ms",
                    "library_device_ms")}
        kernels.append(entry)
    print(smi)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
