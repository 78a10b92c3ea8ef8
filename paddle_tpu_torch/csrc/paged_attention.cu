// Ragged paged attention over the unified KV block pool, for sm_90a.
//
// Replaces the Pallas TPU kernel _paged_attn_kernel, launched by
// _pallas_paged_attention (paddle_tpu/serving/paged_attention.py:160 and
// :284), and computes exactly its reference _xla_paged_attention (:106):
// query row r of lane b (absolute position pos[b] + r) attends over the
// keys 0 .. pos[b] + r that the lane's block table maps, with query head h
// reading kv head h / G (GQA), an f32 online softmax, and the output in
// q's dtype.  An int8 pool carries one f32 scale per token ([NB, bs]) and
// is dequantized right after each block load.
//
// The TPU kernel walks grid axis i (table columns) in order and carries m,
// l and acc in VMEM scratch across it.  Here the column walk runs inside a
// thread block that owns (tile of query vectors, kv head, lane); a query
// vector is one (row r, group head g) pair, ordered by r then g, so a
// decode step (s = 1) of a GQA model puts all G heads that share a kv head
// in one tile.  The block reads pos[b] and tables[b, i] itself and stops at
// the first column past its deepest visible key (the ragged skip of the
// TPU kernel's pl.when at :193): a short lane's tail columns, and scratch
// block 0 past them, are never read.  Masked scores never enter the max,
// masked probabilities are a literal 0 (never exp(NEG_INF - m)), and acc
// is divided by l once, at the end.  Two kernels:
//
// bf16 pools: the Hopper mainloop of attention_sm90.cuh (wgmma on the
//   tensor cores, K/V by TMA) with the paged loader below.  A tile is 64
//   query vectors; a block owns one tile (decode: one tile holds every
//   vector of a (lane, kv head)) or two.  The loader views the pool as
//   rows of KH * D elements and issues one TMA box of 16 tokens per table
//   column, four columns per 64-key tile; the producer warp reads the
//   table, 32 columns at a time, itself.  Every bf16 window (decode, spec
//   verify, prefill) takes this one path and walks the same fixed 64-key
//   tiles from key 0, so each output row's bits depend only on its q
//   vector and its visible keys: not on s, the lane count, nb, or the
//   row's place in its tile (no split-KV).
// f32 and int8 pools: plain f32 FMA on the CUDA cores (f32 is the
//   precision check; the int8 pool waits for its engine knob).  A block
//   owns up to 16 query vectors; each warp takes up to 4 vectors and, when
//   the tile has fewer than 16 vectors, the warps also split the columns
//   round robin and merge their (m, l, acc) in fixed warp order at the end.
//   A warp stages one pool block of K and V (bs = 16 tokens x D) in its own
//   shared memory with 16-byte loads, then scores its vectors against it:
//   each lane holds D/32 dimensions of q and acc in registers, the dot
//   products are warp-shuffle sums, and m, l, acc stay in registers across
//   columns.
//
// Bound.  The function must read, for every lane, the table-mapped blocks
// up to its last visible key, for every kv head, k and v:
//   bytes = sum_b ceil((pos_b + s) / bs) * bs * KH * D * 2 * itemsize
//           (+ 2 * 4 bytes of scale per token when quantized)
//           + q bytes + out bytes,
// over 3.35 TB/s of HBM on an H100 SXM, or its operations, 4 D per visible
// (row, key) pair and query head, over the card's peak for the dtype
// (989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32 on FMA),
// whichever is larger: decode is bounded by bytes, long prefill windows by
// operations.  A block re-reads its lane's blocks once per tile, from L2
// for all but the first; the bf16 kernel's P V product runs twice (hi and
// lo terms of P), 1.5x the bound's tensor work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_sm90.cuh"
#include "kernels.h"

namespace {

constexpr float NEG_INF = -1e30f;  // the masking floor of the reference
constexpr int BS = 16;             // pool block size (tokens)
constexpr int NW = 4;              // warps per thread block
constexpr int VPW = 4;             // query vectors per warp
constexpr int TILE = NW * VPW;     // query vectors per thread block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// QT: q/out type; PT: pool type (QT, or int8_t when QUANT); D: head dim.
template <typename QT, typename PT, int D, bool QUANT>
__global__ void __launch_bounds__(NW * 32)
paged_attn_kernel(const QT* __restrict__ q, const PT* __restrict__ k_pool,
                  const PT* __restrict__ v_pool,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  const int* __restrict__ tables, const int* __restrict__ pos,
                  QT* __restrict__ out, int S, int QH, int KH, int nb,
                  float scale) {
  constexpr int DPL = D / 32;                   // dims held by each lane
  constexpr int CPR = D * sizeof(PT) / 16;      // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem[];

  const int tile = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = QH / KH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int v_begin = tile * TILE;
  const int tile_n = min(TILE, S * G - v_begin);
  const int WQ = (tile_n + VPW - 1) / VPW;      // warps over vectors
  const int WC = NW / WQ;                       // warps over columns
  const int wq = warp / WC, wc = warp % WC;
  const bool working = wq < WQ;                 // WQ == 3 idles one warp
  const int wv0 = v_begin + wq * VPW;
  const int wn = working ? max(0, min(VPW, v_begin + tile_n - wv0)) : 0;
  const int p_b = pos[b];

  float qr[VPW][DPL], acc[VPW][DPL], m[VPW], l[VPW];
  int row[VPW];
#pragma unroll
  for (int i = 0; i < VPW; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
    row[i] = 0;
#pragma unroll
    for (int t = 0; t < DPL; ++t) {
      qr[i][t] = 0.f;
      acc[i][t] = 0.f;
    }
    if (i < wn) {
      const int v = wv0 + i, r = v / G, h = kh * G + v % G;
      row[i] = r;
      const QT* qp = q + ((size_t)(b * S + r) * QH + h) * D + lane * DPL;
#pragma unroll
      for (int t = 0; t < DPL; ++t) qr[i][t] = to_f(qp[t]) * scale;
    }
  }

  // vectors are ordered by row, so the warp's deepest row is its last
  const int r_last = wn ? (wv0 + wn - 1) / G : 0;
  const int n_cols = wn ? min(nb, (p_b + r_last) / BS + 1) : 0;

  PT* ks = reinterpret_cast<PT*>(smem) + (size_t)warp * 2 * BS * D;
  PT* vs = ks + BS * D;
  float* scs = reinterpret_cast<float*>(smem + (size_t)NW * 2 * BS * D * sizeof(PT)) +
               warp * 2 * BS;
  const int* trow = tables + (size_t)b * nb;
  const size_t tok_stride = (size_t)KH * D;     // elements between tokens

  for (int c = wc; c < n_cols; c += WC) {
    const int blk = trow[c];
    const PT* kb = k_pool + ((size_t)blk * BS * KH + kh) * D;
    const PT* vb = v_pool + ((size_t)blk * BS * KH + kh) * D;
    for (int idx = lane; idx < BS * CPR; idx += 32) {
      const int j = idx / CPR, ch = idx % CPR;
      reinterpret_cast<uint4*>(ks + j * D)[ch] =
          reinterpret_cast<const uint4*>(kb + j * tok_stride)[ch];
      reinterpret_cast<uint4*>(vs + j * D)[ch] =
          reinterpret_cast<const uint4*>(vb + j * tok_stride)[ch];
    }
    if (QUANT && lane < BS) {
      scs[lane] = k_scale[(size_t)blk * BS + lane];
      scs[BS + lane] = v_scale[(size_t)blk * BS + lane];
    }
    __syncwarp();

    const int key0 = c * BS;
#pragma unroll
    for (int i = 0; i < VPW; ++i) {
      if (i < wn) {
        float s[BS];
#pragma unroll
        for (int j = 0; j < BS; ++j) {
          const PT* kr = ks + j * D + lane * DPL;
          const float ksc = QUANT ? scs[j] : 1.f;
          float part = 0.f;
#pragma unroll
          for (int t = 0; t < DPL; ++t) part += qr[i][t] * (to_f(kr[t]) * ksc);
          s[j] = warp_sum(part);
        }
        const int last_key = p_b + row[i];     // row i sees keys <= this
        float mx = m[i];
#pragma unroll
        for (int j = 0; j < BS; ++j)
          if (key0 + j <= last_key) mx = fmaxf(mx, s[j]);
        const float alpha = expf(m[i] - mx);
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < BS; ++j) {
          s[j] = key0 + j <= last_key ? expf(s[j] - mx) : 0.f;
          psum += s[j];
        }
        l[i] = l[i] * alpha + psum;
#pragma unroll
        for (int t = 0; t < DPL; ++t) {
          float a = 0.f;
#pragma unroll
          for (int j = 0; j < BS; ++j) {
            const float vsc = QUANT ? scs[BS + j] : 1.f;
            a += s[j] * (to_f(vs[j * D + lane * DPL + t]) * vsc);
          }
          acc[i][t] = acc[i][t] * alpha + a;
        }
        m[i] = mx;
      }
    }
    __syncwarp();
  }

  if (WC > 1) {
    // merge the column-split partial states in fixed warp order; the
    // merge area reuses the staging memory once every warp is done
    float* mg = reinterpret_cast<float*>(smem);
    __syncthreads();
    if (working) {
#pragma unroll
      for (int i = 0; i < VPW; ++i) {
        float* slot = mg + (size_t)(warp * VPW + i) * (D + 2);
#pragma unroll
        for (int t = 0; t < DPL; ++t) slot[lane * DPL + t] = acc[i][t];
        if (lane == 0) {
          slot[D] = m[i];
          slot[D + 1] = l[i];
        }
      }
    }
    __syncthreads();
    if (working && wc == 0) {
#pragma unroll
      for (int i = 0; i < VPW; ++i) {
        if (i < wn) {
          float mx = NEG_INF;
          for (int w = 0; w < WC; ++w)
            mx = fmaxf(mx, mg[(size_t)((wq * WC + w) * VPW + i) * (D + 2) + D]);
          float lt = 0.f, at[DPL];
#pragma unroll
          for (int t = 0; t < DPL; ++t) at[t] = 0.f;
          for (int w = 0; w < WC; ++w) {
            const float* slot = mg + (size_t)((wq * WC + w) * VPW + i) * (D + 2);
            const float f = expf(slot[D] - mx);
            lt += slot[D + 1] * f;
#pragma unroll
            for (int t = 0; t < DPL; ++t) at[t] += slot[lane * DPL + t] * f;
          }
          l[i] = lt;
#pragma unroll
          for (int t = 0; t < DPL; ++t) acc[i][t] = at[t];
        }
      }
    }
  }

  if (working && wc == 0) {
#pragma unroll
    for (int i = 0; i < VPW; ++i) {
      if (i < wn) {
        const int v = wv0 + i, r = v / G, h = kh * G + v % G;
        QT* op = out + ((size_t)(b * S + r) * QH + h) * D + lane * DPL;
        // every row sees key 0, so l > 0
#pragma unroll
        for (int t = 0; t < DPL; ++t) op[t] = from_f<QT>(acc[i][t] / l[i]);
      }
    }
  }
}

// The paged K/V loader of the Hopper mainloop (bf16 pools).  A block owns
// tiles tile0, tile0 + 1 of one (kv head kh, lane b); tile t holds rows
// t TR .. t TR + TR - 1 of the window, G vectors each (TR = 64 / G).  The
// Q tile is one TMA box {D, G heads, TR rows}; a K/V tile is four boxes of
// 16 tokens, one per table column, and the columns past the block's
// deepest visible key are not loaded (their ring rows keep finite values
// from earlier tiles or the initial zeros, under probability 0).
struct PagedProblem {
  CUtensorMap tq, tk, tv;  // q [B, S, QH, D]; pools [NB, 16, KH, D]
  const int* tables;
  const int* pos;
  sm90::bf16* out;
  int S, QH, KH, G, TR, nb;
  float sl2;  // log2 e / sqrt(D)
  static constexpr bool kOverlap = false;  // see attention_sm90.cuh
  static constexpr bool kZeroRing = true;

  struct Cta {
    int b, kh, tile0, pos, ncols;
  };
  __device__ Cta cta(int nc) const {
    Cta c;
    c.b = blockIdx.z;
    c.kh = blockIdx.y;
    c.tile0 = blockIdx.x * nc;
    c.pos = pos[c.b];
    const int r_last = min(S, (c.tile0 + nc) * TR) - 1;
    c.ncols = min(nb, (c.pos + r_last) / BS + 1);
    return c;
  }
  __device__ int n_valid(const Cta&, int tile) const {
    return max(0, min(TR, S - tile * TR)) * G;
  }
  __device__ int diag(const Cta& c, int tile, int i) const {
    return c.pos + tile * TR + i / G;
  }
  __device__ int klim(const Cta&) const { return nb * BS; }
  __device__ uint32_t q_box_bytes() const { return 128u * G * TR; }
  __device__ void load_q(const Cta& c, int tile, uint8_t* dst, uint64_t* bar,
                         int a) const {
    sm90::tma_load_4d(dst, &tq, bar, a * sm90::ATOM, c.kh * G, tile * TR, c.b);
  }
  // the whole producer warp: lane l holds table column 32 j + l of the
  // current run of 8 tiles; lane 0 issues the boxes
  template <int DA>
  __device__ void load_kv(const Cta& c, int kt, uint8_t* k, uint8_t* v,
                          uint64_t* bar, int lane, int& tab) const {
    constexpr int BOX = sm90::ATOM_BYTES / 4;  // 16 tokens x 128 bytes
    if ((kt & 7) == 0) {
      const int col = kt * 4 + lane;
      tab = col < c.ncols ? tables[(size_t)c.b * nb + col] : 0;
    }
    int blk[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      blk[j] = __shfl_sync(0xffffffffu, tab, (kt & 7) * 4 + j);
    if (lane == 0) {
      const int n = min(4, c.ncols - kt * 4);
      sm90::mbar_expect_tx(bar, 2 * n * DA * BOX);
      for (int j = 0; j < n; ++j)
        for (int a = 0; a < DA; ++a) {
          const int off = a * sm90::ATOM_BYTES + j * BOX;
          sm90::tma_load_4d(k + off, &tk, bar, a * sm90::ATOM, c.kh, 0, blk[j]);
          sm90::tma_load_4d(v + off, &tv, bar, a * sm90::ATOM, c.kh, 0, blk[j]);
        }
    }
    __syncwarp();
  }
  template <int D>
  __device__ sm90::bf16* out_row(const Cta& c, int tile, int i) const {
    const int r = tile * TR + i / G;
    return out + (((size_t)c.b * S + r) * QH + c.kh * G + i % G) * D;
  }
  __device__ void store_lse(const Cta&, int, int, float) const {}
};

template <int D>
cudaError_t launch_bf16(const void* q, const void* k_pool, const void* v_pool,
                        const int* tables, const int* pos, void* out, int batch,
                        int q_len, int q_heads, int kv_heads, int nb,
                        int num_blocks, cudaStream_t stream) {
  PagedProblem p;
  p.G = q_heads / kv_heads;
  p.TR = sm90::BM / p.G;
  if (p.TR < 1) return cudaErrorInvalidValue;
  const uint64_t row = (uint64_t)D * sizeof(sm90::bf16);
  if (!sm90::make_map(&p.tq, q, D, q_heads, q_len, batch, row, row * q_heads,
                      row * q_heads * q_len, p.G, p.TR, 1) ||
      !sm90::make_map(&p.tk, k_pool, D, kv_heads, BS, num_blocks, row,
                      row * kv_heads, row * kv_heads * BS, 1, BS, 1) ||
      !sm90::make_map(&p.tv, v_pool, D, kv_heads, BS, num_blocks, row,
                      row * kv_heads, row * kv_heads * BS, 1, BS, 1))
    return cudaErrorInvalidValue;
  p.tables = tables;
  p.pos = pos;
  p.out = static_cast<sm90::bf16*>(out);
  p.S = q_len;
  p.QH = q_heads;
  p.KH = kv_heads;
  p.nb = nb;
  p.sl2 = sm90::LOG2E / sqrtf(static_cast<float>(D));
  const int tiles = (q_len + p.TR - 1) / p.TR;
  if (tiles == 1)
    return sm90::launch<D, 1>(p, dim3(1, kv_heads, batch), stream);
  return sm90::launch<D, 2>(p, dim3((tiles + 1) / 2, kv_heads, batch), stream);
}

template <typename QT, typename PT, int D, bool QUANT>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const float* k_scale, const float* v_scale,
                   const int* tables, const int* pos, void* out, int batch,
                   int q_len, int q_heads, int kv_heads, int nb,
                   cudaStream_t stream) {
  const int groups = q_heads / kv_heads;
  const int tiles = (q_len * groups + TILE - 1) / TILE;
  const size_t stage =
      (size_t)NW * (2 * BS * D * sizeof(PT) + (QUANT ? 2 * BS * sizeof(float) : 0));
  const size_t merge = (size_t)NW * VPW * (D + 2) * sizeof(float);
  const size_t smem = stage > merge ? stage : merge;
  auto kernel = paged_attn_kernel<QT, PT, D, QUANT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(tiles, kv_heads, batch);
  kernel<<<grid, NW * 32, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const PT*>(k_pool),
      static_cast<const PT*>(v_pool), k_scale, v_scale, tables, pos,
      static_cast<QT*>(out), q_len, q_heads, kv_heads, nb,
      1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(const void* q, const void* k_pool, const void* v_pool,
                     const float* k_scale, const float* v_scale,
                     const int* tables, const int* pos, void* out, int batch,
                     int q_len, int q_heads, int kv_heads, int nb,
                     int num_blocks, int dtype, int quantized,
                     cudaStream_t stream) {
#define PA_ARGS q, k_pool, v_pool, k_scale, v_scale, tables, pos, out, batch, \
                q_len, q_heads, kv_heads, nb, stream
  if (dtype == 0 && !quantized) return launch<float, float, D, false>(PA_ARGS);
  if (dtype == 1 && !quantized)
    return launch_bf16<D>(q, k_pool, v_pool, tables, pos, out, batch, q_len,
                          q_heads, kv_heads, nb, num_blocks, stream);
  if (dtype == 0 && quantized) return launch<float, int8_t, D, true>(PA_ARGS);
  if (dtype == 1 && quantized)
    return launch<__nv_bfloat16, int8_t, D, true>(PA_ARGS);
#undef PA_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int paged_attention_fwd(const void* q, const void* k_pool,
                                   const void* v_pool, const float* k_scale,
                                   const float* v_scale, const int* tables,
                                   const int* pos, void* out, int batch,
                                   int q_len, int q_heads, int kv_heads,
                                   int head_dim, int block_size, int nb,
                                   int num_blocks, int dtype, int quantized,
                                   void* stream) {
  if (block_size != BS || kv_heads <= 0 || q_heads % kv_heads != 0 || nb < 1 ||
      num_blocks < 1)
    return cudaErrorInvalidValue;
  if (batch == 0 || q_len == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 128)
    return dispatch<128>(q, k_pool, v_pool, k_scale, v_scale, tables, pos, out,
                         batch, q_len, q_heads, kv_heads, nb, num_blocks, dtype,
                         quantized, st);
  if (head_dim == 64)
    return dispatch<64>(q, k_pool, v_pool, k_scale, v_scale, tables, pos, out,
                        batch, q_len, q_heads, kv_heads, nb, num_blocks, dtype,
                        quantized, st);
  return cudaErrorInvalidValue;
}
