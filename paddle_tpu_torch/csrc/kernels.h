// Plain C interface of the port's CUDA kernels, loaded with ctypes by
// paddle_tpu_torch/_build.py.  Every entry point launches on the given
// stream, allocates nothing, does not synchronise, and returns the
// cudaError_t of the launch (0 on success).
#pragma once

#ifdef __cplusplus
extern "C" {
#endif

// Ragged paged attention (see paged_attention.cu).
//   q, out    [batch, q_len, q_heads, head_dim]
//             dtype: 0 = f32, 1 = bf16, 2 = f16
//   k/v_pool  [num_blocks, block_size, kv_heads, head_dim]
//             the q dtype, or int8 when quantized != 0
//   k/v_scale [num_blocks, block_size] f32, read only when quantized
//   tables    [batch, nb] int32,  pos [batch] int32
// A bf16 or f16 q runs the wgmma kernel over a pool of its dtype or an int8
// pool (head_dim 64 or 128, q_heads / kv_heads <= 64; the scales 16-byte
// aligned), an f32 q the FMA kernel.
int paged_attention_fwd(const void* q, const void* k_pool, const void* v_pool,
                        const float* k_scale, const float* v_scale,
                        const int* tables, const int* pos, void* out,
                        int batch, int q_len, int q_heads, int kv_heads,
                        int head_dim, int block_size, int nb, int num_blocks,
                        int dtype, int quantized, void* stream);

// Flash attention forward / backward (see flash_attention.cu).
//   q, out, dout, dq  [batch, q_len, q_heads, head_dim]
//                     dtype: 0 = f32, 1 = bf16, 2 = f16
//   k, v, dk, dv      [batch, kv_len, kv_heads, head_dim]
//   head_dim 64 or 128 for f32; 48, 64, 80, 128 or 160 for bf16 and f16
//   lse, delta        [batch, q_heads, q_len] f32
// causal != 0 masks key j from query i unless i + (kv_len - q_len) >= j.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                        float* lse, int batch, int q_len, int kv_len,
                        int q_heads, int kv_heads, int head_dim, float scale,
                        int causal, int dtype, void* stream);
int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, void* dq, int batch, int q_len,
                           int kv_len, int q_heads, int kv_heads, int head_dim,
                           float scale, int causal, int dtype, void* stream);
// dK/dV: splits >= 1 contiguous query ranges (bf16 and f16; f32 takes 1);
// splits > 1 needs workspace, f32 [2, splits, batch, kv_len, kv_heads,
// head_dim], which the call overwrites.
int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dk, void* dv,
                            float* workspace, int batch, int q_len, int kv_len,
                            int q_heads, int kv_heads, int head_dim,
                            float scale, int causal, int dtype, int splits,
                            void* stream);

// LayerNorm and GroupNorm backward (see norms.cu).  dtype and wdtype (x's
// and the weight's): 0 = f32, 1 = bf16, 2 = f16.  mean, rstd are f32, one
// per normalised row; dx is x's dtype, dw and db the weight's.  ticket is
// an int that is 0 before the launch and that the launch leaves at 0.
// LayerNorm: x, g, dx [n, h]; k = 0 runs the CTA-per-row kernel, k in
// 1..6 the warp-per-row kernel with k 16-byte vectors a lane (h % (16 /
// itemsize) == 0, h <= 32 k 16 / itemsize, 16-byte aligned rows); ctas is
// a multiple of 8 (clusters of 8); ws holds ws_floats f32, at least
// [ctas / 8 (+ ctas when k = 0), 2 h] (a smaller one is refused).
// layer_norm_bwd_max_ctas gives the most CTAs of the (dtype, h, k) kernel
// the device holds at once.
int layer_norm_bwd_max_ctas(int dtype, int h, int k, int* ctas);
int layer_norm_bwd(const void* x, const void* w, const float* mean,
                   const float* rstd, const void* g, void* dx, void* dw,
                   void* db, float* ws, int ws_floats, int* ticket, int n,
                   int h, int dtype, int wdtype, int k, int ctas,
                   void* stream);
// GroupNorm: x, g, dx [n, c, hw] with c % groups == 0; `clusters`
// clusters of `cluster` CTAs (1..8, at most c / groups), each walking the
// (sample, group) rows cluster id, + clusters, ...; mode 0 = chunks in
// shared memory (hw * itemsize % 16 == 0, 16-byte aligned tensors), 1 =
// streamed 16-byte vectors (the same alignment), 2 = streamed scalars;
// smem_bytes the dynamic shared memory a CTA asks for (at least what the
// mode needs); ws is f32 [n, 2, c].  group_norm_bwd_max_clusters gives the
// most clusters of that kernel the device holds at once.
int group_norm_bwd_max_clusters(int dtype, int mode, int cluster,
                                int smem_bytes, int* clusters);
int group_norm_bwd(const void* x, const void* w, const float* mean,
                   const float* rstd, const void* g, void* dx, void* dw,
                   void* db, float* ws, int* ticket, int n, int c, int groups,
                   int hw, int dtype, int wdtype, int mode, int cluster,
                   int clusters, int smem_bytes, void* stream);

// LayerNorm forward (see norms.cu): x, y [n, h], w and b [h] (wdtype,
// bdtype: 0 = f32, 1 = bf16, 2 = f16, each its own); stats f32 [2, n]: each
// row's mean, then its rstd.  k = 0 (threads 0, warps 8) runs the
// CTA-per-row kernel; k in 1..4 holds a row in registers, `threads`
// threads a row holding k 16-byte vectors each (h % (16 / itemsize) == 0,
// h <= threads k 16 / itemsize, 16-byte aligned x, y, w and b): 8, 16 or
// 32 lanes of a warp (CTAs of `warps` warps, 1..8, whose ctas CTAs walk
// the rows), or a CTA of threads = 32 warps (2..8).  A row a CTA (k = 0, or
// threads > 32) takes ctas = n.  layer_norm_fwd_max_ctas gives the most
// CTAs of a kernel the device holds at once.  w and b both in x's dtype
// take kernels that load them as x; other affine dtypes convert at run
// time.
int layer_norm_fwd_max_ctas(int dtype, int wdtype, int bdtype, int k,
                            int threads, int warps, int* ctas);
int layer_norm_fwd(const void* x, const void* w, const void* b, void* y,
                   float* stats, int n, int h, int dtype, int wdtype,
                   int bdtype, int k, int threads, int warps, int ctas,
                   float eps, void* stream);

// GroupNorm forward (see norms.cu): x, y [n, c, hw] with c % groups == 0,
// w and b [c] (wdtype, bdtype: 0 = f32, 1 = bf16, 2 = f16, each its own);
// stats f32 [2, n * groups]: each (sample, group) row's mean, then its
// rstd.  n * groups clusters of `cluster` CTAs (1..8, at most c / groups),
// one a row; mode 0 = each CTA's channels staged in shared memory
// (hw * itemsize % 16 == 0, 16-byte aligned x and y; hold 1), 1 =
// streamed 16-byte vectors (the same alignment; hold 4, 8 or 10
// vectors a thread, held in registers where the chunk fits), 2 = streamed
// scalars (hold 4); smem_bytes the dynamic shared memory a CTA asks for
// (at least what the mode needs).
int group_norm_fwd(const void* x, const void* w, const void* b, void* y,
                   float* stats, int n, int c, int groups, int hw, int dtype,
                   int wdtype, int bdtype, int mode, int hold, int cluster,
                   int smem_bytes, float eps, void* stream);

#ifdef __cplusplus
}
#endif
