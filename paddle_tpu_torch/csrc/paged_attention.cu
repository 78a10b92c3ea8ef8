// Ragged paged attention over the unified KV block pool, for sm_90a.
//
// Replaces the Pallas TPU kernel _paged_attn_kernel, launched by
// _pallas_paged_attention (paddle_tpu/serving/paged_attention.py:160 and
// :284), and computes exactly its reference _xla_paged_attention (:106):
// query row r of lane b (absolute position pos[b] + r) attends over the
// keys 0 .. pos[b] + r that the lane's block table maps, with query head h
// reading kv head h / G (GQA), an f32 online softmax, and the output in
// q's dtype.  An int8 pool carries one f32 scale per token ([NB, bs]); the
// TPU kernel dequantizes each block right after its DMA (:199-203, k =
// k.astype(f32) * k_scale), and the kernels here fold the scales into the
// f32 softmax instead (below).
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
// bf16 or fp16 q over a pool of its dtype or an int8 pool: the Hopper
//   mainloop of attention_sm90.cuh (wgmma on the tensor cores, K/V by
//   TMA; the element type a template parameter) with the paged loaders
//   below.  A tile is 64 query vectors; a block owns one
//   tile (decode: one tile holds every vector of a (lane, kv head)) or
//   two.  The loader views the pool as
//   rows of KH * D elements and issues one TMA box of 16 tokens per table
//   column, four columns per 64-key tile; the producer warp reads the
//   table, 32 columns at a time, itself.  Every 16-bit window (decode, spec
//   verify, prefill) takes this one path and walks the same fixed 64-key
//   tiles from key 0, so each output row's bits depend only on its q
//   vector and its visible keys: not on s, the lane count, nb, or the
//   row's place in its tile (no split-KV).  An int8 pool (the engine's
//   kv_cache_dtype="int8") takes the mainloop's int8 policy: per table
//   column the producer warp issues two TMA boxes of 16 tokens x D int8
//   bytes and two 64-byte bulk copies of the 16 + 16 scales into a
//   staging slot, three converter warps turn the slot into the query's
//   16-bit K/V stage (exact: int8 values are bf16 and fp16 integers), and
//   the consumers
//   multiply S's columns by the K scales and P's by the V scales in f32.
//   So int8 decode, verify, chunk and prefill windows run on the tensor
//   cores along the same fixed tiles, and keep the row invariance above.
// f32 pools, and f32 q over an int8 pool: plain f32 FMA on the CUDA cores
//   (the precision check).  A block owns a tile of up to 8 query vectors,
//   and all four warps hold every vector of the tile: table column c goes
//   to warp c % 4, for every window alike, and a warp skips, vector by
//   vector, the columns past that vector's last visible key.  At the end the four partial (m, l, acc)
//   states of each vector merge in warp order.  So a row is always summed
//   as the same four column classes, each in ascending column order, and
//   its bits depend only on its q vector and its visible keys: not on s,
//   the lane count, nb, or its place in the tile (a decode row, a spec
//   verify window and a prefill window give the same bits).  The products
//   are explicit fmaf, so no contraction choice of the compiler differs
//   between the unrolled copies of a vector's code.  A warp stages one pool
//   block of K and V (bs = 16 tokens x D, plus the 16 + 16 scales of an
//   int8 pool) in its own shared memory with 16-byte loads, then scores
//   the tile's vectors against it: each lane holds D/32 dimensions of q and
//   acc in registers, the dot products are warp-shuffle sums, and m, l, acc
//   stay in registers across columns.
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
// lo terms of P), 1.5x the bound's tensor work.  An int8 pool halves the
// K/V bytes (plus 8 bytes of scale a token), so int8 decode is bounded by
// half of bf16's bytes; the design keeps HBM reads int8 (the conversion
// happens in shared memory, never in HBM), keeps three slots of int8
// tiles in flight a CTA with two CTAs a multiprocessor at decode, and
// leaves the consumers' tensor work that of bf16, which bounds long
// prefill windows; the conversion (~2 integer / bf16 instructions a value
// in otherwise idle warps) and its shared-memory traffic are the cost.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_sm90.cuh"
#include "kernels.h"

namespace {

constexpr float NEG_INF = -1e30f;  // the masking floor of the reference
constexpr int BS = 16;             // pool block size (tokens)
constexpr int NW = 4;              // warps per thread block (FMA kernel)
constexpr int TILE = 8;            // query vectors per thread block (FMA)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// QT: q/out type (f32); PT: pool type (QT, or int8_t when QUANT); D: head
// dim.
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
  const int p_b = pos[b];

  float qr[TILE][DPL], acc[TILE][DPL], m[TILE], l[TILE];
  int last_key[TILE];                           // vector i sees keys <= this
#pragma unroll
  for (int i = 0; i < TILE; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
    last_key[i] = -1;
#pragma unroll
    for (int t = 0; t < DPL; ++t) {
      qr[i][t] = 0.f;
      acc[i][t] = 0.f;
    }
    if (i < tile_n) {
      const int v = v_begin + i, r = v / G, h = kh * G + v % G;
      last_key[i] = p_b + r;
      const QT* qp = q + ((size_t)(b * S + r) * QH + h) * D + lane * DPL;
#pragma unroll
      for (int t = 0; t < DPL; ++t) qr[i][t] = to_f(qp[t]) * scale;
    }
  }

  // vectors are ordered by row, so the tile's deepest row is its last
  const int n_cols = min(nb, (p_b + (v_begin + tile_n - 1) / G) / BS + 1);

  PT* ks = reinterpret_cast<PT*>(smem) + (size_t)warp * 2 * BS * D;
  PT* vs = ks + BS * D;
  float* scs = reinterpret_cast<float*>(smem + (size_t)NW * 2 * BS * D * sizeof(PT)) +
               warp * 2 * BS;
  const int* trow = tables + (size_t)b * nb;
  const size_t tok_stride = (size_t)KH * D;     // elements between tokens

  for (int c = warp; c < n_cols; c += NW) {
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
    for (int i = 0; i < TILE; ++i) {
      // a column wholly past the vector's last key is skipped, not
      // applied as a no-op: the vector's ops never depend on the tile
      if (key0 <= last_key[i]) {
        float s[BS];
#pragma unroll
        for (int j = 0; j < BS; ++j) {
          const PT* kr = ks + j * D + lane * DPL;
          const float ksc = QUANT ? scs[j] : 1.f;
          float part = 0.f;
#pragma unroll
          for (int t = 0; t < DPL; ++t)
            part = fmaf(qr[i][t], to_f(kr[t]) * ksc, part);
          s[j] = warp_sum(part);
        }
        float mx = m[i];
#pragma unroll
        for (int j = 0; j < BS; ++j)
          if (key0 + j <= last_key[i]) mx = fmaxf(mx, s[j]);
        const float alpha = expf(m[i] - mx);
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < BS; ++j) {
          s[j] = key0 + j <= last_key[i] ? expf(s[j] - mx) : 0.f;
          psum += s[j];
        }
        l[i] = fmaf(l[i], alpha, psum);
#pragma unroll
        for (int t = 0; t < DPL; ++t) {
          float a = 0.f;
#pragma unroll
          for (int j = 0; j < BS; ++j) {
            const float vsc = QUANT ? scs[BS + j] : 1.f;
            a = fmaf(s[j], to_f(vs[j * D + lane * DPL + t]) * vsc, a);
          }
          acc[i][t] = fmaf(acc[i][t], alpha, a);
        }
        m[i] = mx;
      }
    }
    __syncwarp();
  }

  // merge the four column classes of each vector in warp order; the merge
  // area reuses the staging memory once every warp is done
  float* mg = reinterpret_cast<float*>(smem);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TILE; ++i) {
    if (i < tile_n) {
      float* slot = mg + (size_t)(warp * TILE + i) * (D + 2);
#pragma unroll
      for (int t = 0; t < DPL; ++t) slot[lane * DPL + t] = acc[i][t];
      if (lane == 0) {
        slot[D] = m[i];
        slot[D + 1] = l[i];
      }
    }
  }
  __syncthreads();
  for (int i = warp; i < tile_n; i += NW) {
    float mx = NEG_INF;
    for (int w = 0; w < NW; ++w)
      mx = fmaxf(mx, mg[(size_t)(w * TILE + i) * (D + 2) + D]);
    float lt = 0.f, at[DPL];
#pragma unroll
    for (int t = 0; t < DPL; ++t) at[t] = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float* slot = mg + (size_t)(w * TILE + i) * (D + 2);
      const float f = expf(slot[D] - mx);
      lt = fmaf(slot[D + 1], f, lt);
#pragma unroll
      for (int t = 0; t < DPL; ++t) at[t] = fmaf(slot[lane * DPL + t], f, at[t]);
    }
    const int v = v_begin + i, r = v / G, h = kh * G + v % G;
    QT* op = out + ((size_t)(b * S + r) * QH + h) * D + lane * DPL;
    // every row sees key 0 (warp 0's first column), so lt > 0
#pragma unroll
    for (int t = 0; t < DPL; ++t) op[t] = at[t] / lt;
  }
}

// The paged K/V loader of the Hopper mainloop (bf16 pools).  A block owns
// tiles tile0, tile0 + 1 of one (kv head kh, lane b); tile t holds rows
// t TR .. t TR + TR - 1 of the window, G vectors each (TR = 64 / G).  The
// Q tile is one TMA box {D, G heads, TR rows}; a K/V tile is four boxes of
// 16 tokens, one per table column, and the columns past the block's
// deepest visible key are not loaded (their ring rows keep finite values
// from earlier tiles or the initial zeros, under probability 0).  E: the
// query's element type, bf16 or fp16 (sm90::BF16, sm90::F16).
template <class E_>
struct PagedProblem {
  typedef E_ E;
  CUtensorMap tq, tk, tv;  // q [B, S, QH, D]; pools [NB, 16, KH, D]
  const int* tables;
  const int* pos;
  typename E::T* out;
  int S, QH, KH, G, TR, nb;
  float sl2;  // log2 e / sqrt(D)
  static constexpr bool kOverlap = false;  // see attention_sm90.cuh
  static constexpr bool kZeroRing = true;
  static constexpr bool kInt8 = false;

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
  __device__ typename E::T* out_row(const Cta& c, int tile, int i) const {
    const int r = tile * TR + i / G;
    return out + (((size_t)c.b * S + r) * QH + c.kh * G + i % G) * D;
  }
  __device__ void store_lse(const Cta&, int, int, float) const {}
};

// The int8 pool's loader (the mainloop's kInt8 policy): the same Cta,
// tiles and table walk, but a K/V tile lands in a staging slot
// (sm90::Staged): per table column j one TMA box of 16 tokens x D int8
// bytes of K at j 16 D and of V at KV + j 16 D (unswizzled rows: the
// converters read them), and the column's 16 K and 16 V scales, 64 bytes
// each, by bulk copy after them.  The converters write E (int8 values
// are exact in bf16 and in fp16).
template <class E_>
struct PagedInt8Problem : PagedProblem<E_> {
  using typename PagedProblem<E_>::Cta;
  using PagedProblem<E_>::tk;
  using PagedProblem<E_>::tv;
  using PagedProblem<E_>::tables;
  using PagedProblem<E_>::nb;
  const float* k_scale;  // [NB, 16]
  const float* v_scale;
  static constexpr bool kZeroRing = false;  // every stage is converted whole
  static constexpr bool kInt8 = true;

  template <int DA>
  __device__ void load_kv(const Cta& c, int kt, uint8_t* stage, uint64_t* bar,
                          int lane, int& tab) const {
    constexpr int D = DA * sm90::ATOM, KV = sm90::Staged<D>::KV;
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
      sm90::mbar_expect_tx(bar, n * (2 * BS * D + 2 * BS * 4));
      for (int j = 0; j < n; ++j) {
        sm90::tma_load_4d(stage + j * BS * D, &tk, bar, 0, c.kh, 0, blk[j]);
        sm90::tma_load_4d(stage + KV + j * BS * D, &tv, bar, 0, c.kh, 0, blk[j]);
        sm90::bulk_load(stage + 2 * KV + j * BS * 4, k_scale + (size_t)blk[j] * BS,
                        BS * 4, bar);
        sm90::bulk_load(stage + 2 * KV + (sm90::BN + j * BS) * 4,
                        v_scale + (size_t)blk[j] * BS, BS * 4, bar);
      }
    }
    __syncwarp();
  }
};

// a bf16 or fp16 q over a pool of its dtype (Prob = PagedProblem<E>) or
// an int8 pool (PagedInt8Problem<E>, whose scales the caller has set)
template <int D, class Prob>
cudaError_t launch_paged(Prob& p, const void* q, const void* k_pool,
                         const void* v_pool, const int* tables, const int* pos,
                         void* out, int batch, int q_len, int q_heads,
                         int kv_heads, int nb, int num_blocks,
                         cudaStream_t stream) {
  p.G = q_heads / kv_heads;
  p.TR = sm90::BM / p.G;
  if (p.TR < 1) return cudaErrorInvalidValue;
  using E = typename Prob::E;
  const uint64_t row = (uint64_t)D * sizeof(typename E::T);
  bool ok = sm90::make_map<E>(&p.tq, q, D, q_heads, q_len, batch, row,
                           row * q_heads, row * q_heads * q_len, p.G, p.TR, 1);
  if constexpr (Prob::kInt8) {
    const uint64_t r8 = D;  // an int8 pool row: D bytes
    ok = ok &&
         sm90::encode_map(&p.tk, CU_TENSOR_MAP_DATA_TYPE_UINT8, k_pool, D,
                          kv_heads, BS, num_blocks, r8, r8 * kv_heads,
                          r8 * kv_heads * BS, D, 1, BS, 1,
                          CU_TENSOR_MAP_SWIZZLE_NONE) &&
         sm90::encode_map(&p.tv, CU_TENSOR_MAP_DATA_TYPE_UINT8, v_pool, D,
                          kv_heads, BS, num_blocks, r8, r8 * kv_heads,
                          r8 * kv_heads * BS, D, 1, BS, 1,
                          CU_TENSOR_MAP_SWIZZLE_NONE);
  } else {
    ok = ok &&
         sm90::make_map<E>(&p.tk, k_pool, D, kv_heads, BS, num_blocks, row,
                        row * kv_heads, row * kv_heads * BS, 1, BS, 1) &&
         sm90::make_map<E>(&p.tv, v_pool, D, kv_heads, BS, num_blocks, row,
                        row * kv_heads, row * kv_heads * BS, 1, BS, 1);
  }
  if (!ok) return cudaErrorInvalidValue;
  p.tables = tables;
  p.pos = pos;
  p.out = static_cast<typename E::T*>(out);
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
  const size_t merge = (size_t)NW * TILE * (D + 2) * sizeof(float);
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
#define PAGED_ARGS q, k_pool, v_pool, tables, pos, out, batch, q_len, \
                   q_heads, kv_heads, nb, num_blocks, stream
  if (dtype == 1 && !quantized) {
    PagedProblem<sm90::BF16> p;
    return launch_paged<D>(p, PAGED_ARGS);
  }
  if (dtype == 2 && !quantized) {
    PagedProblem<sm90::F16> p;
    return launch_paged<D>(p, PAGED_ARGS);
  }
  if (dtype == 0 && quantized) return launch<float, int8_t, D, true>(PA_ARGS);
  if (dtype == 1 && quantized) {
    PagedInt8Problem<sm90::BF16> p;
    p.k_scale = k_scale;
    p.v_scale = v_scale;
    return launch_paged<D>(p, PAGED_ARGS);
  }
  if (dtype == 2 && quantized) {
    PagedInt8Problem<sm90::F16> p;
    p.k_scale = k_scale;
    p.v_scale = v_scale;
    return launch_paged<D>(p, PAGED_ARGS);
  }
#undef PAGED_ARGS
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
