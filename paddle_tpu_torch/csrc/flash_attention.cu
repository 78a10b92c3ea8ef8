// Flash attention forward and backward (recompute form), for sm_90a.
//
// Replaces the three Pallas TPU kernels of paddle_tpu/ops/pallas/flash.py:
//   forward  <- _fwd_kernel  (:74, launched by _flash_fwd :132)
//   dq       <- _dq_kernel   (:163, launched by _flash_bwd :255)
//   dk, dv   <- _dkv_kernel  (:197, launched by _flash_bwd :277)
// and computes what they compute: S = Q K^T * scale under the causal mask
// q_idx + (kv_len - q_len) >= k_idx (flash.py:29-45), an f32 online softmax
// with O and lse = m + log(l) saved, and the backward from lse and
// delta = rowsum(dO * O) alone:
//   P = exp(S - lse),  dS = P * (dO V^T - delta) * scale,
//   dQ = dS K,  dK = dS^T Q,  dV = P^T dO.
//
// Layout.  q, out, dout, dq are [B, Sq, H, D]; k, v, dk, dv [B, Sk, KH, D]
// (the port's [batch, seq, heads, head_dim], read in place: no transposes);
// lse and delta are [B, H, Sq] f32.  GQA: query head h reads kv head
// h / (H / KH), and K/V are never repeated in memory.
//
// Design.  The TPU kernels walk the k (or q) blocks as a sequential grid
// axis and carry m, l and acc (or dq, dk, dv) in VMEM scratch.  Here a
// thread block owns its output tiles and loops over the other axis itself,
// so there are no atomics and the result is deterministic:
//   bf16 and fp16 forward: the Hopper mainloop of attention_sm90.cuh
//     (TMA-fed K/V ring, wgmma, warp-specialised), with the contiguous loader below: a
//     block owns 128 query rows (two 64-row tiles) of one (q head, batch);
//   f32 forward and dq: one block per (64-row q tile, q head, batch),
//     looping over the k tiles in order, m/l/acc (or dq) in f32 registers;
//   dkv: one block per (64-row k tile, kv head, batch), looping over the
//     q_per_kv query heads of its group and their q tiles (the sum that
//     _dkv_kernel accumulates over grid axes), dk/dv in f32 registers.
// Three arithmetic paths:
//   the bf16 and fp16 forward on the tensor cores with wgmma
//     (attention_sm90.cuh; the element type is a template parameter);
//   the bf16 and fp16 backward on the tensor cores with wgmma
//     (flash_bwd_sm90.cuh):
//     dQ as the forward, a block of two 64-row query tiles with a TMA-fed
//     K/V ring; dK/dV a block of 128 keys (64 at D 160) with a TMA-fed
//     ring of Q / dO tiles, split over query ranges into f32 partials
//     and a second summing kernel where the key tiles alone cannot fill
//     the card (the wrapper chooses the split from the shape);
//   f32 inputs: plain FMA on the CUDA cores (f32 products have no tensor
//     core path that keeps f32 precision).  256 threads as a 16 x 16 grid;
//     a thread computes a 4 x 4 piece of each 64 x 64 score tile (rows
//     ty + 16 i, columns tx + 16 j) and D/16 columns of its 4 output rows.
//     Tiles are staged in shared memory as f32 with one word of row
//     padding, so the column reads of K, V, Q and dO hit 16 distinct
//     banks.  Score-row max and sum are shuffles over the 16 lanes that
//     share ty.
// K tiles wholly above the causal diagonal are never loaded (the pl.when
// skip of the TPU kernels); ragged edges are masked in the kernel (rows
// past the end load as 0 and are not stored).  A query row
// with no visible key (q_len > kv_len under the causal mask) keeps l = 0:
// it outputs 0 with lse = -inf, and its probabilities are a literal 0 in
// the backward, so it has zero gradients (the flash-attn convention; the
// TPU kernel's finite NEG_INF instead gives such rows mean(v)).
//
// Bound.  Each kernel is bounded by operations at these sizes: per visible
// (q, k) pair and query head, 4 D flops forward (QK^T, PV) and 10 D
// backward (five products; the dq and dkv kernels each recompute QK^T and
// dO V^T, so they do 14 D together), over 989 TFLOP/s for bf16 and fp16
// (tensor cores) or 67 TFLOP/s for f32 (CUDA cores) on an H100 SXM.  The
// 16-bit kernels' second products take P (and dS) as hi and lo terms (see
// attention_sm90.cuh and flash_bwd_sm90.cuh): the forward issues 1.5x its
// bound's tensor work, dQ 4/3 and dK/dV 3/2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_sm90.cuh"
#include "flash_bwd_sm90.cuh"
#include "kernels.h"

namespace {

constexpr float NEG_INF = -1e30f;  // running-max floor: exp(m - m_new) stays finite
constexpr int BQ = 64;             // q rows per tile
constexpr int BK = 64;             // keys per tile
constexpr int NT = 256;            // threads per block (16 x 16)
constexpr int LDP = BK + 1;        // padded row stride of a [BQ, BK] tile

// reduce over the 16 lanes that share ty (lanes 0-15 and 16-31 of a warp)
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage rows [r0, r0 + 64) of one head into dst[64][D + 1], with 16-byte
// loads; rows at or past n load as 0.  src points at row 0 of the head and
// rows are `stride` elements apart.
template <int D>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          size_t stride, int r0, int n) {
  constexpr int CPR = D / 4;  // 16-byte chunks per row
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x; idx < 64 * CPR; idx += NT) {
    const int r = idx / CPR, ch = idx % CPR;
    float* d = dst + r * LD + ch * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n)
      v = reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * stride)[ch];
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
}

// s[i][j] += A[ty + 16 i] . B[tx + 16 j] over D (A, B padded [64][D + 1])
template <int D>
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* A,
                                         const float* B, int ty, int tx) {
  constexpr int LD = D + 1;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// number of k tiles that rows [q0, q0 + 64) can see
__device__ __forceinline__ int k_tiles(int q0, int Sq, int Sk, int causal) {
  int k_end = Sk;
  if (causal) k_end = min(Sk, min(q0 + BQ, Sq) - 1 + (Sk - Sq) + 1);
  return k_end > 0 ? (k_end + BK - 1) / BK : 0;
}

__device__ __forceinline__ bool visible(int qi, int kj, int Sq, int Sk,
                                        int causal) {
  return qi < Sq && kj < Sk && (!causal || qi + (Sk - Sq) >= kj);
}

// ---------------------------------------------------------------- forward
template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, int H, int KH,
                 float scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int E = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = qt * BQ;

  load_tile<D>(sQ, q + ((size_t)b * Sq * H + h) * D, (size_t)H * D, q0, Sq);
  const float* kb = k + ((size_t)b * Sk * KH + kh) * D;
  const float* vb = v + ((size_t)b * Sk * KH + kh) * D;

  float m[4], l[4], acc[4][E];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }

  const int n_k = k_tiles(q0, Sq, Sk, causal);
  for (int jt = 0; jt < n_k; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();  // the previous tile's sK, sV, sP are consumed
    load_tile<D>(sK, kb, (size_t)KH * D, k0, Sk);
    load_tile<D>(sV, vb, (size_t)KH * D, k0, Sk);
    __syncthreads();

    float s[4][4] = {};
    tile_dot<D>(s, sQ, sK, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      bool vis[4];
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        vis[j] = visible(qi, k0 + tx + 16 * j, Sq, Sk, causal);
        s[i][j] *= scale;
        if (vis[j]) mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max16(mx);
      const float alpha = expf(m[i] - mx);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = vis[j] ? expf(s[i][j] - mx) : 0.f;
        sP[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        ps += p;
      }
      l[i] = l[i] * alpha + row_sum16(ps);
      m[i] = mx;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float vv = sV[c * LD + tx + 16 * e];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][e] = fmaf(p[i], vv, acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    const bool any = l[i] > 0.f;
    float* op = out + (((size_t)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int e = 0; e < E; ++e)
      op[tx + 16 * e] = (any ? acc[i][e] / l[i] : 0.f);
    if (tx == 0)
      lse[((size_t)b * H + h) * Sq + qi] = any ? m[i] + logf(l[i]) : -INFINITY;
  }
}

// --------------------------------------------------------------- backward
template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int Sq, int Sk, int H, int KH, float scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int E = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sO = sQ + BQ * LD;  // dO
  float* sK = sO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sS = sV + BK * LD;  // dS

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = qt * BQ;
  const size_t qoff = ((size_t)b * Sq * H + h) * D;

  load_tile<D>(sQ, q + qoff, (size_t)H * D, q0, Sq);
  load_tile<D>(sO, dout + qoff, (size_t)H * D, q0, Sq);
  const float* kb = k + ((size_t)b * Sk * KH + kh) * D;
  const float* vb = v + ((size_t)b * Sk * KH + kh) * D;

  float rl[4], rd[4], acc[4][E];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    const size_t at = ((size_t)b * H + h) * Sq + qi;
    rl[i] = qi < Sq ? lse[at] : 0.f;
    rd[i] = qi < Sq ? delta[at] : 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }

  const int n_k = k_tiles(q0, Sq, Sk, causal);
  for (int jt = 0; jt < n_k; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();
    load_tile<D>(sK, kb, (size_t)KH * D, k0, Sk);
    load_tile<D>(sV, vb, (size_t)KH * D, k0, Sk);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    tile_dot<D>(s, sQ, sK, ty, tx);
    tile_dot<D>(dp, sO, sV, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool vis = visible(qi, k0 + tx + 16 * j, Sq, Sk, causal);
        const float p = vis ? expf(s[i][j] * scale - rl[i]) : 0.f;
        sS[(ty + 16 * i) * LDP + tx + 16 * j] = p * (dp[i][j] - rd[i]) * scale;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = sS[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float kv = sK[c * LD + tx + 16 * e];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][e] = fmaf(ds[i], kv, acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    float* op = dq + (((size_t)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int e = 0; e < E; ++e) op[tx + 16 * e] = acc[i][e];
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int Sq, int Sk, int H, int KH,
                     float scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int E = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sO = sQ + BQ * LD;  // dO
  float* sP = sO + BQ * LD;
  float* sS = sP + BQ * LDP;  // dS
  float* sL = sS + BQ * LDP;  // lse of the q tile's rows
  float* sD = sL + BQ;        // delta of the q tile's rows

  const int kt = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / KH;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int k0 = kt * BK;
  const size_t koff = ((size_t)b * Sk * KH + kh) * D;

  load_tile<D>(sK, k + koff, (size_t)KH * D, k0, Sk);
  load_tile<D>(sV, v + koff, (size_t)KH * D, k0, Sk);

  // rows c = ty + 16 i of the k tile, columns tx + 16 e
  float ak[4][E], av[4][E];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) ak[i][e] = av[i][e] = 0.f;

  const int n_q = (Sq + BQ - 1) / BQ;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const size_t qoff = ((size_t)b * Sq * H + h) * D;
    const float* lrow = lse + ((size_t)b * H + h) * Sq;
    const float* drow = delta + ((size_t)b * H + h) * Sq;
    for (int it = 0; it < n_q; ++it) {
      const int q0 = it * BQ;
      // q tiles wholly below-left of the diagonal see none of these keys
      if (causal && min(q0 + BQ, Sq) - 1 + (Sk - Sq) < k0) continue;
      __syncthreads();
      load_tile<D>(sQ, q + qoff, (size_t)H * D, q0, Sq);
      load_tile<D>(sO, dout + qoff, (size_t)H * D, q0, Sq);
      if (threadIdx.x < BQ) {
        const int qi = q0 + threadIdx.x;
        sL[threadIdx.x] = qi < Sq ? lrow[qi] : 0.f;
        sD[threadIdx.x] = qi < Sq ? drow[qi] : 0.f;
      }
      __syncthreads();

      float s[4][4] = {}, dp[4][4] = {};
      tile_dot<D>(s, sQ, sK, ty, tx);
      tile_dot<D>(dp, sO, sV, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool vis = visible(q0 + r, k0 + tx + 16 * j, Sq, Sk, causal);
          const float p = vis ? expf(s[i][j] * scale - sL[r]) : 0.f;
          sP[r * LDP + tx + 16 * j] = p;
          sS[r * LDP + tx + 16 * j] = p * (dp[i][j] - sD[r]) * scale;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = sP[r * LDP + ty + 16 * i];
          ds[i] = sS[r * LDP + ty + 16 * i];
        }
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float o = sO[r * LD + tx + 16 * e];
          const float qq = sQ[r * LD + tx + 16 * e];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            av[i][e] = fmaf(p[i], o, av[i][e]);
            ak[i][e] = fmaf(ds[i], qq, ak[i][e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= Sk) continue;
    const size_t at = (((size_t)b * Sk + kj) * KH + kh) * D;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dk[at + tx + 16 * e] = ak[i][e];
      dv[at + tx + 16 * e] = av[i][e];
    }
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int Sq, int Sk, int H, int KH, float scale,
                int causal, cudaStream_t st) {
  const size_t smem = (size_t)(BQ * (D + 1) + 2 * BK * (D + 1) + BQ * LDP) * 4;
  auto kernel = flash_fwd_kernel<D>;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, NT, smem, st>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                 static_cast<const float*>(v), static_cast<float*>(out),
                                 lse, Sq, Sk, H, KH, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int B, int Sq, int Sk, int H, int KH, float scale,
                   int causal, cudaStream_t st) {
  const size_t smem = (size_t)(2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * LDP) * 4;
  auto kernel = flash_bwd_dq_kernel<D>;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, NT, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), Sq, Sk, H, KH,
      scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, int B, int Sq, int Sk, int H, int KH,
                    float scale, int causal, cudaStream_t st) {
  const size_t smem =
      (size_t)(2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BQ * LDP + 2 * BQ) * 4;
  auto kernel = flash_bwd_dkv_kernel<D>;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sk + BK - 1) / BK, KH, B);
  kernel<<<grid, NT, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), Sq, Sk, H, KH, scale, causal);
  return cudaGetLastError();
}

// The contiguous K/V loader of the Hopper mainloop: a block owns the 64-row
// q tiles tile0, tile0 + 1 of one (q head h, batch b), K/V tiles are TMA
// boxes of 64 keys of kv head h / (H / KH), and rows past Sk (and columns
// past D) arrive as zeros.  E: bf16 or fp16 (sm90::BF16, sm90::F16).
template <class E_>
struct FlashProblem {
  typedef E_ E;
  CUtensorMap tq, tk, tv;  // q [B, Sq, H, D]; k, v [B, Sk, KH, D]
  typename E::T* out;
  float* lse;
  int Sq, Sk, H, KH, causal;
  float sl2;  // scale * log2 e
  static constexpr bool kOverlap = true;  // see attention_sm90.cuh
  static constexpr bool kZeroRing = false;
  static constexpr bool kInt8 = false;

  struct Cta {
    int b, h, kh, tile0;
  };
  __device__ Cta cta(int nc) const {
    Cta c;
    c.b = blockIdx.z;
    c.h = blockIdx.y;
    c.kh = c.h / (H / KH);
    c.tile0 = (gridDim.x - 1 - blockIdx.x) * nc;  // the longest causal rows first
    return c;
  }
  __device__ int n_valid(const Cta&, int tile) const {
    return max(0, min(sm90::BM, Sq - tile * sm90::BM));
  }
  __device__ int diag(const Cta&, int tile, int i) const {
    return causal ? tile * sm90::BM + i + (Sk - Sq) : sm90::NO_LIMIT;
  }
  __device__ int klim(const Cta&) const { return Sk; }
  __device__ uint32_t q_box_bytes() const { return sm90::ATOM_BYTES; }
  __device__ void load_q(const Cta& c, int tile, uint8_t* dst, uint64_t* bar,
                         int a) const {
    sm90::tma_load_4d(dst, &tq, bar, a * sm90::ATOM, c.h, tile * sm90::BM, c.b);
  }
  template <int DA>
  __device__ void load_kv(const Cta& c, int kt, uint8_t* k, uint8_t* v,
                          uint64_t* bar, int lane, int&) const {
    if (lane != 0) return;
    sm90::mbar_expect_tx(bar, 2 * DA * sm90::ATOM_BYTES);
    for (int a = 0; a < DA; ++a) {
      sm90::tma_load_4d(k + a * sm90::ATOM_BYTES, &tk, bar, a * sm90::ATOM, c.kh,
                        kt * sm90::BN, c.b);
      sm90::tma_load_4d(v + a * sm90::ATOM_BYTES, &tv, bar, a * sm90::ATOM, c.kh,
                        kt * sm90::BN, c.b);
    }
  }
  template <int D>
  __device__ typename E::T* out_row(const Cta& c, int tile, int i) const {
    return out + (((size_t)c.b * Sq + tile * sm90::BM + i) * H + c.h) * D;
  }
  __device__ void store_lse(const Cta& c, int tile, int i, float x) const {
    lse[((size_t)c.b * H + c.h) * Sq + tile * sm90::BM + i] = x;
  }
};

template <class E, int D>
cudaError_t fwd_sm90(const void* q, const void* k, const void* v, void* out,
                     float* lse, int B, int Sq, int Sk, int H, int KH,
                     float scale, int causal, cudaStream_t st) {
  constexpr int NC = 2;
  FlashProblem<E> p;
  const uint64_t row = (uint64_t)D * sizeof(typename E::T);
  const uint64_t sk = Sk > 0 ? Sk : 1;
  if (!sm90::make_map<E>(&p.tq, q, D, H, Sq, B, row, row * H, row * H * Sq, 1,
                      sm90::BM, 1) ||
      !sm90::make_map<E>(&p.tk, k, D, KH, sk, B, row, row * KH, row * KH * sk, 1,
                      sm90::BN, 1) ||
      !sm90::make_map<E>(&p.tv, v, D, KH, sk, B, row, row * KH, row * KH * sk, 1,
                      sm90::BN, 1))
    return cudaErrorInvalidValue;
  p.out = static_cast<typename E::T*>(out);
  p.lse = lse;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.KH = KH;
  p.causal = causal;
  p.sl2 = scale * sm90::LOG2E;
  const dim3 grid((Sq + NC * sm90::BM - 1) / (NC * sm90::BM), H, B);
  return sm90::launch<D, NC>(p, grid, st);
}

template <class E, int D>
cudaError_t bwd_dq_sm90(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, const float* delta,
                        void* dq, int B, int Sq, int Sk, int H, int KH,
                        float scale, int causal, cudaStream_t st) {
  sm90::BwdArgs a{};
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.B = B;
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.KH = KH;
  a.causal = causal;
  a.splits = 1;
  a.scale = scale;
  a.sl2 = scale * sm90::LOG2E;
  if (!sm90::bwd_maps<E>(a, q, k, v, dout, D)) return cudaErrorInvalidValue;
  return sm90::launch_bwd_dq<E, D>(a, st);
}

template <class E, int D>
cudaError_t bwd_dkv_sm90(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dk, void* dv, int B, int Sq,
                         int Sk, int H, int KH, float scale, int causal,
                         int splits, float* ws, cudaStream_t st) {
  if (splits < 1 || (splits > 1 && ws == nullptr)) return cudaErrorInvalidValue;
  sm90::BwdArgs a{};
  a.lse = lse;
  a.delta = delta;
  a.dk = dk;
  a.dv = dv;
  a.ws = ws;
  a.B = B;
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.KH = KH;
  a.causal = causal;
  a.splits = splits;
  a.scale = scale;
  a.sl2 = scale * sm90::LOG2E;
  if (!sm90::bwd_maps<E>(a, q, k, v, dout, D)) return cudaErrorInvalidValue;
  return sm90::launch_bwd_dkv<E, D>(a, st);
}

bool bad_shape(int B, int Sq, int Sk, int H, int KH) {
  return B < 0 || Sq < 0 || Sk < 0 || KH <= 0 || H % KH != 0;
}

}  // namespace

// f32 inputs take the FMA kernels (head dims 64 and 128), bf16 and fp16
// inputs the tensor-core kernels (48, 64, 80, 128 and 160: the LLaMA head
// and the SD UNet's 40 (padded to 48 by the caller), 80 and 160), forward
// and backward on wgmma.  Any other (dtype, head_dim) is refused.
#define FA_SM90_DIMS(CALL_SM90, E)                                         \
  if (head_dim == 128) return CALL_SM90(E, 128);                           \
  if (head_dim == 64) return CALL_SM90(E, 64);                             \
  if (head_dim == 48) return CALL_SM90(E, 48);                             \
  if (head_dim == 80) return CALL_SM90(E, 80);                             \
  if (head_dim == 160) return CALL_SM90(E, 160);
#define FA_DISPATCH(CALL, CALL_SM90)                                       \
  if (dtype == 0 && head_dim == 128) return CALL(128);                     \
  if (dtype == 0 && head_dim == 64) return CALL(64);                       \
  if (dtype == 1) { FA_SM90_DIMS(CALL_SM90, sm90::BF16) }                  \
  if (dtype == 2) { FA_SM90_DIMS(CALL_SM90, sm90::F16) }                   \
  return cudaErrorInvalidValue;

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, float* lse, int batch, int q_len,
                                   int kv_len, int q_heads, int kv_heads,
                                   int head_dim, float scale, int causal,
                                   int dtype, void* stream) {
  if (bad_shape(batch, q_len, kv_len, q_heads, kv_heads))
    return cudaErrorInvalidValue;
  if (batch == 0 || q_len == 0 || q_heads == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_FWD(D) \
  fwd<D>(q, k, v, out, lse, batch, q_len, kv_len, q_heads, kv_heads, scale, causal, st)
#define FA_FWD_SM90(E, D) \
  fwd_sm90<E, D>(q, k, v, out, lse, batch, q_len, kv_len, q_heads, kv_heads, scale, causal, st)
  FA_DISPATCH(FA_FWD, FA_FWD_SM90)
#undef FA_FWD
#undef FA_FWD_SM90
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* delta,
                                      void* dq, int batch, int q_len,
                                      int kv_len, int q_heads, int kv_heads,
                                      int head_dim, float scale, int causal,
                                      int dtype, void* stream) {
  if (bad_shape(batch, q_len, kv_len, q_heads, kv_heads))
    return cudaErrorInvalidValue;
  if (batch == 0 || q_len == 0 || q_heads == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_DQ(D)                                                           \
  bwd_dq<D>(q, k, v, dout, lse, delta, dq, batch, q_len, kv_len, q_heads, \
            kv_heads, scale, causal, st)
#define FA_DQ_SM90(E, D)                                                       \
  bwd_dq_sm90<E, D>(q, k, v, dout, lse, delta, dq, batch, q_len, kv_len, q_heads, \
                 kv_heads, scale, causal, st)
  FA_DISPATCH(FA_DQ, FA_DQ_SM90)
#undef FA_DQ
#undef FA_DQ_SM90
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse, const float* delta,
                                       void* dk, void* dv, float* workspace,
                                       int batch, int q_len, int kv_len,
                                       int q_heads, int kv_heads, int head_dim,
                                       float scale, int causal, int dtype,
                                       int splits, void* stream) {
  if (bad_shape(batch, q_len, kv_len, q_heads, kv_heads))
    return cudaErrorInvalidValue;
  if (dtype == 0 && splits != 1) return cudaErrorInvalidValue;
  if (batch == 0 || kv_len == 0 || kv_heads == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_DKV(D)                                                          \
  bwd_dkv<D>(q, k, v, dout, lse, delta, dk, dv, batch, q_len, kv_len, \
             q_heads, kv_heads, scale, causal, st)
#define FA_DKV_SM90(E, D)                                                      \
  bwd_dkv_sm90<E, D>(q, k, v, dout, lse, delta, dk, dv, batch, q_len, kv_len, \
                  q_heads, kv_heads, scale, causal, splits, workspace, st)
  FA_DISPATCH(FA_DKV, FA_DKV_SM90)
#undef FA_DKV
#undef FA_DKV_SM90
}
