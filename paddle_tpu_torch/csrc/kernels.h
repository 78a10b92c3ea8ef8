// Plain C interface of the port's CUDA kernels, loaded with ctypes by
// paddle_tpu_torch/_build.py.  Every entry point launches on the given
// stream, allocates nothing, does not synchronise, and returns the
// cudaError_t of the launch (0 on success).
#pragma once

#ifdef __cplusplus
extern "C" {
#endif

// Ragged paged attention (see paged_attention.cu).
//   q, out    [batch, q_len, q_heads, head_dim]      dtype: 0 = f32, 1 = bf16
//   k/v_pool  [num_blocks, block_size, kv_heads, head_dim]
//             the q dtype, or int8 when quantized != 0
//   k/v_scale [num_blocks, block_size] f32, read only when quantized
//   tables    [batch, nb] int32,  pos [batch] int32
// bf16 runs the wgmma kernel (head_dim 64 or 128, q_heads / kv_heads <= 64),
// f32 and int8 pools the FMA kernel.
int paged_attention_fwd(const void* q, const void* k_pool, const void* v_pool,
                        const float* k_scale, const float* v_scale,
                        const int* tables, const int* pos, void* out,
                        int batch, int q_len, int q_heads, int kv_heads,
                        int head_dim, int block_size, int nb, int num_blocks,
                        int dtype, int quantized, void* stream);

// Flash attention forward / backward (see flash_attention.cu).
//   q, out, dout, dq  [batch, q_len, q_heads, head_dim]    dtype: 0 = f32, 1 = bf16
//   k, v, dk, dv      [batch, kv_len, kv_heads, head_dim]
//   head_dim 64 or 128 for f32; 48, 64, 80, 128 or 160 for bf16
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
// dK/dV: splits >= 1 contiguous query ranges (bf16 only; f32 takes 1);
// splits > 1 needs workspace, f32 [2, splits, batch, kv_len, kv_heads,
// head_dim], which the call overwrites.
int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dk, void* dv,
                            float* workspace, int batch, int q_len, int kv_len,
                            int q_heads, int kv_heads, int head_dim,
                            float scale, int causal, int dtype, int splits,
                            void* stream);

#ifdef __cplusplus
}
#endif
