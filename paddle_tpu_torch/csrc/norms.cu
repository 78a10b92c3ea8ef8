// LayerNorm and GroupNorm, forward and backward, for sm_90a.
//
// Replaces four Pallas TPU kernels of paddle_tpu/ops/pallas/norms.py:
//   LayerNorm  <- _ln_fwd_kernel (:32, launched by _ln_call_fwd :79)
//   LayerNorm  <- _ln_bwd_kernel (:44, launched by _ln_vjp_bwd :141)
//   GroupNorm  <- _gn_bwd_kernel (:318, launched by _gn_vjp_bwd :424)
//   GroupNorm  <- _gn_fwd_kernel (:304, launched by _gn_call_fwd :366)
// The backwards compute what their TPU kernels compute, in f32 from the
// saved f32 mean and rstd of each normalised row (xhat = (x - mean) * rstd):
//   dx = rstd * (g w - mean(g w) - xhat * mean(g w xhat)),
//   dw = sum of g xhat and db = sum of g over every row a weight scales,
// dx in x's dtype, dw and db in the weight's (f32, bf16 or f16).
//
// Bound.  Both backwards move x and g in and dx out once (3 elements of x's dtype
// per element) against ~12 operations: bytes bound them, 4.7 us at
// [4096, 640] and 28 us at [4, 960, 64, 64] in bf16 on an H100 (3.35
// TB/s).  The TPU kernels walk the rows as a sequential grid and carry
// dw and db in VMEM from one step to the next; blocks here run in no
// order, so each launch reduces dw and db itself, in a fixed order (no
// floating-point atomics: the result is bitwise the same run to run), and
// writes them in the weight's dtype.  One launch a call, no torch op after.
//
// LayerNorm ([N, H] rows).  A persistent grid of 8-warp CTAs in clusters of
// 8, as many as the card holds at once (the wrapper asks the occupancy API).
//   ln_bwd_warp_kernel<T, K>: one warp per row, the row in registers: a
//     lane holds K 16-byte vectors of x and of g (columns (k 32 + lane)
//     VW ...), so H <= 32 K VW (H <= 1536 in 2-byte types, 768 in f32).
//     A warp walks rows warp, warp + total warps, ...; before it reduces
//     a row it issues the next row's loads (two rows in flight a warp).
//     The row sums are xor-shuffle butterflies (every lane ends with the
//     same bits, no __syncthreads); dw and db accumulate in f32 registers
//     across the warp's rows and are summed over the CTA's 8 warps in
//     warp order through shared memory.
//   ln_bwd_row_kernel<T>: any H and any alignment: a CTA per row, scalar
//     loads, block sums in warp order; the CTA's dw and db accumulate in
//     its own f32 row of the workspace.
//   Across CTAs (ln_tail): rank r of a cluster sums column slice r of the
//     cluster's 8 CTA partials (distributed shared memory, or the
//     workspace rows) in rank order into the cluster's partial row; the
//     last cluster to take a ticket splits the columns again and sums
//     the cluster partials (at most ~34 rows, 1/8 of the columns a CTA)
//     in cluster order.  The ticket is an int the last cluster resets.
//
// GroupNorm ([N, C, HW], G groups of Cg = C / G channels: a row is one
// (sample, group), Cg HW contiguous elements).  Persistent clusters of S
// CTAs (S <= 8), as many as the card holds, each walking rows cluster id,
// + clusters, ...; rank r takes the whole channels [r Cg / S, (r + 1) Cg /
// S) of a row.  Per row: each channel's sum(g) and sum(g xhat) (split
// over warps when the chunk has fewer channels than warps; parts summed
// in order) are the [N, C] dw/db partials; the CTA's sums of w sum(g) and
// w sum(g xhat) go to every rank by st.async into its shared memory,
// completing there on a barrier (no fence waits on earlier stores), and
// each rank adds them in rank order; dx is written one row behind the
// sums, while the pushes land.
//   MODE 0 (x and g over 32 MiB, the wrapper decides): a producer warp
//     loads each row's chunk once into a 3-stage shared-memory ring by TMA
//     bulk copies (cp.async.bulk of whole channels, >= 8 KB a copy, one
//     mbarrier per copy), refilling a stage once its dx is written, and
//     dx is computed from shared memory: x and g leave device memory once.
//   MODE 1: the chunk streams from device memory twice (sums, then dx) in
//     16-byte vectors; where x and g fit the 50 MB L2 the second pass is
//     served from it, and one CTA a row is then faster than a cluster.
//   MODE 2: as MODE 1 with scalar loads, where HW * sizeof(T) is not a
//     multiple of 16 (no 16-byte vectors, no bulk copies).
//   The [N, C] partials are summed over N in sample order by the last
//   cluster to take the ticket, which resets it.
//
// GroupNorm forward (same rows): y = (x - mean) rstd w[c] + b[c] with the
// row's f32 mean and rstd = rsqrt(mean((x - mean)^2) + eps), y in x's
// dtype, mean and rstd f32 [N G].  Bound by bytes: x in and y out once,
// 19 us at [4, 960, 64, 64] in bf16 on an H100.  The TPU kernel holds a
// block of rows in VMEM; here the problem is parallelism: the SD UNet has
// only N G = 128 rows of up to 240 KB, so one CTA a row streams 128 rows
// with a few KB in flight each.  A row is split instead over a cluster of
// S <= 8 CTAs (the wrapper's plan sizes S from the shape alone), one CTA
// for each rank's whole channels [r Cg / S, (r + 1) Cg / S), one launch
// of rows x S CTAs, no persistence and no tail.  A CTA takes its chunk's
// sum, then M2 about the chunk's own mean (two passes, never E[x^2] -
// mean^2); the ranks push (sum, M2) to every rank by st.async, and each
// merges them in rank order (Chan: M2 = sum of M2_r + n_r (mean_r -
// mean)^2), so every rank holds the same bits and the result is bitwise
// the same run to run.  y is then written from the chunk.
//   MODE 0: the chunk lands once in shared memory by bulk copies of
//     GNF_PIECE bytes, each on its own barrier, and the sum starts on the
//     first piece; the second pass and y read shared memory: x leaves
//     device memory once.
//   MODE 1: the chunk streams from device memory (16-byte vectors): a
//     row of at most 10 vectors a thread (40 KB) is loaded once and held
//     in registers through the passes, which beats the bulk copies and
//     the shared-memory passes there; a chunk too large for shared memory
//     is read in every pass, the later passes hitting the L2.
//   MODE 2: as MODE 1 with scalar loads, where HW * sizeof(T) is not a
//     multiple of 16.
//
// LayerNorm forward ([N, H] rows): y = (x - mean) rstd w + b with the row's
// f32 mean and rstd = rsqrt(mean((x - mean)^2) + eps), y in x's dtype, mean
// and rstd f32 [N].  Bound by bytes: x in and y out once (plus w, b and 8
// bytes of statistics a row), 6.3 us at [16384, 320] in bf16 on an H100,
// against ~7 operations an element.  The TPU kernel takes blocks of 256
// rows in VMEM (padding the rows to a whole block); the rows here are short
// (640 B at H 320) and many, or few and wide, so the problem is bytes in
// flight per SM and a row's latency, with no barrier between a row's load
// and its sums where a warp holds it.  A row is held in registers by P
// threads, K 16-byte vectors each (columns (k P + p) VW ...), at most
// LNF_VALUES values a thread (more cost registers and occupancy); the
// wrapper picks (K, P) from H alone, the pair that leaves the fewest slots
// empty: H 320 in 16 lanes (K 3), H 640 in 32 (K 3), H 1280 in a CTA of
// 160 threads (K 1).  A row's sums run in a fixed order (each vector
// pairwise, the vectors in order, then butterflies), so its bits depend on
// the row and on (K, P) alone, never on the grid: bitwise the same run to
// run.  The mean, then M2 about it: two passes over the registers, never
// E[x^2] - mean^2.
//   ln_fwd_warp_kernel<T, K, LANES, SAME>: a row per 8, 16 or 32 lanes (4,
//     2 or 1 rows a warp at once), a persistent grid at the occupancy cap;
//     a warp walks its groups of rows and issues the next group's loads
//     before this one's sums, which are xor-shuffle butterflies over the
//     row's lanes (no shared memory, no __syncthreads).  w and b are
//     loaded once a lane and kept in f32 registers: a lane takes the same
//     columns in every row.
//   ln_fwd_cta_kernel<T, K, SAME>: a row per CTA of 2..8 warps, one CTA a
//     row (the rows that need it are few: their time is a load's round trip
//     and the sums' latency); warp butterflies, then the warps' sums in warp
//     order; w and b loaded after the sums.
//   ln_fwd_row_kernel<T>: any H and any alignment: a CTA a row, scalar
//     loads, block sums in warp order.
//   SAME: w and b both in x's dtype, whose code is then a constant; other
//   affine dtypes convert by codes read at run time (measured slower at
//   every SD UNet shape: more instructions an element).
// y leaves in 16-byte stores; one thread a row writes mean and rstd.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_sm90.cuh"
#include "kernels.h"

namespace norms {

namespace cg = cooperative_groups;
using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::smem_u32;

constexpr int LN_WARPS = 8;     // warps of a LayerNorm CTA
constexpr int LN_CLUSTER = 8;   // CTAs of a LayerNorm cluster
constexpr int LNF_VALUES = 24;  // values a LayerNorm forward thread holds at most
constexpr int GN_WARPS = 8;     // warps of a GroupNorm CTA
constexpr int GN_MAX_CLUSTER = 8;
constexpr int GN_PIECE = 8192;  // bytes of x a bulk copy brings at least
constexpr int GN_STAGES = 3;    // rows of chunks a CTA holds: summed, awaiting dx, loading
constexpr int GN_UNROLL = 4;    // vectors a thread loads before it computes on them
constexpr int GNF_WARPS = 8;    // warps of a GroupNorm forward CTA
constexpr int GNF_PIECE = 32768;  // bytes of x a forward bulk copy brings at most
constexpr unsigned FULL = 0xffffffffu;

struct LnArgs {
  const void* x;
  const void* w;
  const float* mean;
  const float* rstd;
  const void* g;
  void* dx;
  void* dw;
  void* db;
  float* ws;     // [clusters][2H] cluster partials, then (row kernel) [ctas][2H]
  int* ticket;
  int n, h, wdtype;
};

struct GnArgs {
  const void* x;
  const void* w;
  const float* mean;
  const float* rstd;
  const void* g;
  void* dx;
  void* dw;
  void* db;
  float* ws;     // [2][N][C]: dw partials, then db partials
  int* ticket;
  int n, c, groups, hw, wdtype, s, max_ch;
};

struct LnFwdArgs {
  const void* x;
  const void* w;
  const void* b;
  void* y;
  float* stats;  // [2][n]: the rows' mean, then their rstd
  int n, h, wdtype, bdtype;
  float eps;
};

struct GnFwdArgs {
  const void* x;
  const void* w;
  const void* b;
  void* y;
  float* stats;  // [2][rows]: the rows' mean, then their rstd
  int rows, cg, groups, hw, wdtype, bdtype, s, max_ch;
  float eps;
};

// --------------------------------------------------------------- numbers
template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f<__half>(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }

template <typename T, int VW>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[VW]) {
  if constexpr (VW == 1) {
    *p = from_f<T>(f[0]);
  } else {
    uint4 v;
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int i = 0; i < VW; ++i) e[i] = from_f<T>(f[i]);
    *reinterpret_cast<uint4*>(p) = v;
  }
}

// VW elements as loaded: one 16-byte vector, or one element (VW = 1)
template <typename T, int VW>
using Raw = typename std::conditional<VW == 1, T, uint4>::type;

template <typename T, int VW>
__device__ __forceinline__ Raw<T, VW> load_raw(const T* p) {
  return *reinterpret_cast<const Raw<T, VW>*>(p);
}

template <typename T, int VW>
__device__ __forceinline__ void unpack_raw(const Raw<T, VW>& v, float (&f)[VW]) {
  const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int i = 0; i < VW; ++i) f[i] = to_f<T>(e[i]);
}

// the weight's dtype at run time: 0 f32, 1 bf16, 2 f16
__device__ __forceinline__ float load_w(const void* w, int code, int i) {
  if (code == 1) return to_f(static_cast<const __nv_bfloat16*>(w)[i]);
  if (code == 2) return to_f(static_cast<const __half*>(w)[i]);
  return static_cast<const float*>(w)[i];
}

__device__ __forceinline__ void store_w(void* w, int code, int i, float v) {
  if (code == 1) static_cast<__nv_bfloat16*>(w)[i] = from_f<__nv_bfloat16>(v);
  else if (code == 2) static_cast<__half*>(w)[i] = from_f<__half>(v);
  else static_cast<float*>(w)[i] = v;
}

// v summed over each aligned group of LANES lanes (a power of two up to 32);
// every lane of a group ends with the same bits (each butterfly step adds
// the same two values on both lanes of a pair)
template <int LANES>
__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) { return lanes_sum<32>(v); }

// v summed over a CTA of WARPS warps through red[WARPS]: every thread adds
// the warps' sums in warp order, so all end with the same bits
template <int WARPS>
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += red[w];
  return s;
}

// one bulk copy of `bytes` (a multiple of 16) from device memory into this
// CTA's shared memory, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Wait for the phase of the given parity of a barrier in this CTA's shared
// memory.  The common case (the copy has landed) is one try_wait; only a
// wait that has to spin reads the clock, and one longer than 10 s (a lost
// arrival) traps instead of hanging the card.
__device__ __forceinline__ void wait_parity(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .u64 t0, t1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t0, %%globaltimer;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t1, %%globaltimer;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.lt.u64 p, t1, 10000000000;\n"
      "@p bra WAIT;\n"
      "trap;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Two floats into rank `rank`'s shared memory at the address of `dst` in
// this CTA, completing 8 bytes on that rank's barrier at the address of
// `bar`: a store across the cluster that orders nothing else (no fence
// waits for this CTA's earlier stores to device memory).
__device__ __forceinline__ void push2(float* dst, uint64_t* bar, int rank, float a, float b) {
  asm volatile(
      "{\n"
      ".reg .b32 d, m;\n"
      "mapa.shared::cluster.u32 d, %0, %2;\n"
      "mapa.shared::cluster.u32 m, %1, %2;\n"
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [d], {%3, %4}, [m];\n"
      "}\n" ::"r"(smem_u32(dst)),
      "r"(smem_u32(bar)), "r"(rank), "f"(a), "f"(b)
      : "memory");
}

// out(col, sum over r < rows of src[r * stride + col], taken in r order)
// for every col in [lo, hi), over the CTA's threads.  A thread keeps CB
// columns x RB rows of loads in flight: the rows are partials in L2, and
// one load at a time would pay its latency once per row (the compiler
// cannot overlap one column's loads with the last one's stores, which may
// alias them).
template <int CB, int RB, typename Out>
__device__ __forceinline__ void sum_rows(const float* src, int rows, size_t stride, int lo,
                                         int hi, Out out) {
  for (int c0 = lo + threadIdx.x; c0 < hi; c0 += CB * blockDim.x) {
    float s[CB];
#pragma unroll
    for (int k = 0; k < CB; ++k) s[k] = 0.f;
    for (int r0 = 0; r0 < rows; r0 += RB) {
      float v[CB][RB];
#pragma unroll
      for (int k = 0; k < CB; ++k)
#pragma unroll
        for (int j = 0; j < RB; ++j) {
          const int col = c0 + k * blockDim.x;
          v[k][j] = col < hi && r0 + j < rows ? __ldcg(src + (size_t)(r0 + j) * stride + col)
                                              : 0.f;
        }
#pragma unroll
      for (int k = 0; k < CB; ++k)
#pragma unroll
        for (int j = 0; j < RB; ++j)
          if (r0 + j < rows) s[k] += v[k][j];
    }
#pragma unroll
    for (int k = 0; k < CB; ++k)
      if (c0 + k * blockDim.x < hi) out(c0 + k * blockDim.x, s[k]);
  }
}

// The end of both kernels, once every CTA has written its rows of the
// partials ws [rows][cols]: each cluster takes a ticket, and the last
// cluster (the ticket's count, which it resets) sums the rows in row order,
// its `size` CTAs splitting the columns.  out(col, sum) writes a result.
// Ordering: the cluster barrier (release / acquire) puts the cluster's
// partial writes before rank 0's ticket, an acq_rel atomic at GPU scope;
// the last cluster's rank 0 acquires every other cluster's writes through
// it and passes them on through the next cluster barrier (the pattern of
// a CTA barrier and one thread's release in CUTLASS's semaphore).
template <int CB, int RB, typename Out>
__device__ void last_cluster_sums(int* ticket, int size, const float* ws, int rows, int cols,
                                  Out out) {
  __shared__ int s_last;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    int old;
    asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                 : "=r"(old)
                 : "l"(ticket)
                 : "memory");
    const int last = old == (int)gridDim.x / size - 1;
    if (last) atomicExch(ticket, 0);
    for (int q = 0; q < size; ++q) *cluster.map_shared_rank(&s_last, q) = last;
  }
  cluster.sync();
  if (!s_last) return;
  sum_rows<CB, RB>(ws, rows, cols, (int)((int64_t)rank * cols / size),
                   (int)((int64_t)(rank + 1) * cols / size), out);
}

// ------------------------------------------------------------- LayerNorm
// The cross-CTA sum of dw and db (see the file comment).  `part` is this
// CTA's partial [2H] (dw, then db): in shared memory (global == false) or
// in its workspace row (global == true, the row kernel).
__device__ void ln_tail(const LnArgs& a, float* part, bool global) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nclusters = gridDim.x / LN_CLUSTER;
  const int h2 = 2 * a.h, nt = blockDim.x;
  const int hi = (int)((int64_t)(rank + 1) * h2 / LN_CLUSTER);
  float* cws = a.ws + (size_t)(blockIdx.x / LN_CLUSTER) * h2;
  cluster.sync();
  // two columns a pass: 16 loads in flight
  for (int col = (int)((int64_t)rank * h2 / LN_CLUSTER) + threadIdx.x; col < hi;
       col += 2 * nt) {
    const bool two = col + nt < hi;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int q = 0; q < LN_CLUSTER; ++q) {
      const float* p =
          global ? part + (int64_t)(q - rank) * h2 : cluster.map_shared_rank(part, q);
      s0 += global ? __ldcg(p + col) : p[col];
      if (two) s1 += global ? __ldcg(p + col + nt) : p[col + nt];
    }
    cws[col] = s0;
    if (two) cws[col + nt] = s1;
  }
  last_cluster_sums<2, 32>(a.ticket, LN_CLUSTER, a.ws, nclusters, h2, [&](int col, float s) {
    if (col < a.h)
      store_w(a.dw, a.wdtype, col, s);
    else
      store_w(a.db, a.wdtype, col - a.h, s);
  });
}

// shared memory of the warp-per-row kernel, in floats: the weight, each
// warp's dw and db, the CTA's partial [2H]
template <int VW, int K>
__host__ __device__ constexpr int ln_slots() { return K * VW * 32; }
__host__ __device__ inline int ln_pad4(int h) { return (h + 3) & ~3; }

template <typename T, int K>
__global__ void __launch_bounds__(LN_WARPS * 32)
    ln_bwd_warp_kernel(const LnArgs a) {
  constexpr int VW = 16 / sizeof(T);
  constexpr int SLOTS = ln_slots<VW, K>();
  extern __shared__ __align__(16) float ln_smem[];
  const int h = a.h, nvec = h / VW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* wf = ln_smem;                                 // [H] weight in f32
  // [LN_WARPS][2][SLOTS]: each warp's dw and db at the end, slot
  // (k VW + e) 32 + lane for column (k 32 + lane) VW + e: a warp's stores
  // fall on 32 consecutive words (no bank conflicts)
  float* acc = ln_smem + ln_pad4(h);
  float* part = acc + LN_WARPS * 2 * SLOTS;            // [2H]
  const T* x = static_cast<const T*>(a.x);
  const T* g = static_cast<const T*>(a.g);
  T* dx = static_cast<T*>(a.dx);
  float dw[K][VW], db[K][VW];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < VW; ++e) dw[k][e] = db[k][e] = 0.f;

  const int64_t stride = (int64_t)gridDim.x * LN_WARPS;
  int64_t r = (int64_t)blockIdx.x * LN_WARPS + warp;
  uint4 xc[K], gc[K];
  float mc = 0.f, rc = 0.f;
  auto load_row = [&](int64_t row, uint4 (&xv)[K], uint4 (&gv)[K], float& m, float& rs) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * h);
    const uint4* gr = reinterpret_cast<const uint4*>(g + row * h);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = k * 32 + lane;
      if (j < nvec) {
        xv[k] = __ldcs(xr + j);
        gv[k] = __ldcs(gr + j);
      }
    }
    m = a.mean[row];
    rs = a.rstd[row];
  };
  if (r < a.n) load_row(r, xc, gc, mc, rc);
  // the weight, while the first row is in flight
#pragma unroll 4
  for (int i = threadIdx.x; i < h; i += blockDim.x) wf[i] = load_w(a.w, a.wdtype, i);
  __syncthreads();
  while (r < a.n) {
    const int64_t rn = r + stride;
    uint4 xn[K], gn[K];
    float mn = 0.f, rsn = 0.f;
    if (rn < a.n) load_row(rn, xn, gn, mn, rsn);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = k * 32 + lane;
      if (j < nvec) {
        float xf[VW], gf[VW];
        unpack_raw<T, VW>(xc[k], xf);
        unpack_raw<T, VW>(gc[k], gf);
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          const float gw = gf[e] * wf[j * VW + e];
          s1 += gw;
          s2 += gw * ((xf[e] - mc) * rc);
        }
      }
    }
    const float c1 = warp_sum(s1) / (float)h;
    const float c2 = warp_sum(s2) / (float)h;
    uint4* dxr = reinterpret_cast<uint4*>(dx + r * h);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = k * 32 + lane;
      if (j < nvec) {
        float xf[VW], gf[VW], df[VW];
        unpack_raw<T, VW>(xc[k], xf);
        unpack_raw<T, VW>(gc[k], gf);
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          const float xh = (xf[e] - mc) * rc;
          df[e] = rc * (gf[e] * wf[j * VW + e] - c1 - xh * c2);
          dw[k][e] += gf[e] * xh;
          db[k][e] += gf[e];
        }
        uint4 v;
        T* o = reinterpret_cast<T*>(&v);
#pragma unroll
        for (int e = 0; e < VW; ++e) o[e] = from_f<T>(df[e]);
        __stcs(dxr + j, v);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      xc[k] = xn[k];
      gc[k] = gn[k];
    }
    mc = mn;
    rc = rsn;
    r = rn;
  }

  // the CTA's dw, db: the warps' registers summed in warp order
  float* mine = acc + warp * 2 * SLOTS + lane;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < VW; ++e) {
      mine[(k * VW + e) * 32] = dw[k][e];
      mine[SLOTS + (k * VW + e) * 32] = db[k][e];
    }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * SLOTS; i += blockDim.x) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < LN_WARPS; ++w) s += acc[w * 2 * SLOTS + i];
    const int half = i / SLOTS, j = i % SLOTS;
    const int col = ((j / (VW * 32)) * 32 + j % 32) * VW + (j / 32) % VW;
    if (col < h) part[half * h + col] = s;
  }
  ln_tail(a, part, false);
}

template <typename T>
__global__ void __launch_bounds__(LN_WARPS * 32) ln_bwd_row_kernel(const LnArgs a) {
  __shared__ float wsum[2][LN_WARPS][2];
  const int h = a.h, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nclusters = gridDim.x / LN_CLUSTER;
  float* acc = a.ws + ((size_t)nclusters + blockIdx.x) * 2 * h;
  for (int i = threadIdx.x; i < h; i += blockDim.x) acc[i] = acc[h + i] = 0.f;
  const T* x = static_cast<const T*>(a.x);
  const T* g = static_cast<const T*>(a.g);
  T* dx = static_cast<T*>(a.dx);
  int it = 0;
  for (int64_t r = blockIdx.x; r < a.n; r += gridDim.x, it ^= 1) {
    const T* xr = x + r * h;
    const T* gr = g + r * h;
    const float m = a.mean[r], rs = a.rstd[r];
    float s1 = 0.f, s2 = 0.f;
    for (int i = threadIdx.x; i < h; i += blockDim.x) {
      const float gw = to_f<T>(gr[i]) * load_w(a.w, a.wdtype, i);
      s1 += gw;
      s2 += gw * ((to_f<T>(xr[i]) - m) * rs);
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      wsum[it][warp][0] = s1;
      wsum[it][warp][1] = s2;
    }
    __syncthreads();
    float c1 = 0.f, c2 = 0.f;
#pragma unroll
    for (int w = 0; w < LN_WARPS; ++w) {
      c1 += wsum[it][w][0];
      c2 += wsum[it][w][1];
    }
    c1 /= (float)h;
    c2 /= (float)h;
    for (int i = threadIdx.x; i < h; i += blockDim.x) {
      const float gf = to_f<T>(gr[i]);
      const float xh = (to_f<T>(xr[i]) - m) * rs;
      dx[r * h + i] = from_f<T>(rs * (gf * load_w(a.w, a.wdtype, i) - c1 - xh * c2));
      acc[i] += gf * xh;
      acc[h + i] += gf;
    }
  }
  ln_tail(a, acc, true);
}

typedef void (*LnKernel)(const LnArgs);

template <typename T>
LnKernel ln_kernel_of(int k) {
  switch (k) {
    case 0: return ln_bwd_row_kernel<T>;
    case 1: return ln_bwd_warp_kernel<T, 1>;
    case 2: return ln_bwd_warp_kernel<T, 2>;
    case 3: return ln_bwd_warp_kernel<T, 3>;
    case 4: return ln_bwd_warp_kernel<T, 4>;
    case 5: return ln_bwd_warp_kernel<T, 5>;
    case 6: return ln_bwd_warp_kernel<T, 6>;
  }
  return nullptr;
}

LnKernel ln_kernel(int dtype, int k) {
  if (dtype == 0) return ln_kernel_of<float>(k);
  if (dtype == 1) return ln_kernel_of<__nv_bfloat16>(k);
  if (dtype == 2) return ln_kernel_of<__half>(k);
  return nullptr;
}

size_t ln_smem_bytes(int dtype, int k, int h) {
  const int slots = k * (dtype == 0 ? 4 : 8) * 32;
  return k ? (size_t)(ln_pad4(h) + LN_WARPS * 2 * slots + 2 * h) * sizeof(float) : 0;
}

cudaLaunchConfig_t cluster_config(int grid, int threads, int cluster, size_t smem,
                                  cudaStream_t st, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the most clusters of `kernel` the device holds at once (the occupancy API)
template <typename Kern>
cudaError_t max_clusters(Kern kernel, int threads, int cluster, size_t smem, int* out) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(cluster, threads, cluster, smem, 0, &attr);
  e = cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
  if (e == cudaSuccess && *out <= 0) e = cudaErrorInvalidConfiguration;
  return e;
}

template <typename Kern, typename Args>
cudaError_t launch_cluster(Kern kernel, int grid, int threads, int cluster, size_t smem,
                           cudaStream_t st, const Args& a) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(grid, threads, cluster, smem, st, &attr);
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

// ----------------------------------------------------- LayerNorm forward
// the code of a dtype as the entry points take it: 0 f32, 1 bf16, 2 f16
template <typename T>
__host__ __device__ constexpr int dtype_code() {
  return std::is_same<T, float>::value ? 0 : std::is_same<T, __nv_bfloat16>::value ? 1 : 2;
}

// the affine vector's VW values from element i0 in f32, its dtype read at
// run time (0 f32, 1 bf16, 2 f16); the vector starts on a multiple of VW
// elements of a 16-byte aligned base, so it loads as 16- or 8-byte pieces
template <int VW>
__device__ __forceinline__ void load_affine(const void* p, int code, int i0, float (&f)[VW]) {
  if (code == 0) {
    const float4* q = reinterpret_cast<const float4*>(static_cast<const float*>(p) + i0);
#pragma unroll
    for (int i = 0; i < VW / 4; ++i) {
      const float4 v = q[i];
      f[4 * i] = v.x;
      f[4 * i + 1] = v.y;
      f[4 * i + 2] = v.z;
      f[4 * i + 3] = v.w;
    }
  } else {
    using V = typename std::conditional<VW == 8, uint4, uint2>::type;
    const V v = *reinterpret_cast<const V*>(static_cast<const unsigned short*>(p) + i0);
    const unsigned short* e = reinterpret_cast<const unsigned short*>(&v);
#pragma unroll
    for (int i = 0; i < VW; ++i)
      f[i] = code == 1 ? __bfloat162float(__ushort_as_bfloat16(e[i]))
                       : __half2float(__ushort_as_half(e[i]));
  }
}

// The register-held forward row of one thread: K 16-byte vectors of x (its
// vectors k P + p of the row, p its place among the P threads that hold
// the row) and the affine values of those columns in f32.  SAME: w and b
// are both in x's dtype, whose code is a constant; otherwise each is
// converted by its own code read at run time.  Its partial sums run in a
// fixed order: each vector's values pairwise, then the vectors in order
// (short dependency chains, the same bits every run).
template <typename T, int K, bool SAME>
struct LnFwdRow {
  static constexpr int VW = 16 / sizeof(T);
  uint4 x[K];
  float w[K][VW], b[K][VW];

  __device__ __forceinline__ void load(const T* row, int p, int P, int nvec, bool valid) {
    const uint4* xr = reinterpret_cast<const uint4*>(row);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = k * P + p;
      x[k] = valid && j < nvec ? xr[j] : make_uint4(0, 0, 0, 0);
    }
  }
  __device__ __forceinline__ void load_affine_of(const LnFwdArgs& a, int p, int P, int nvec) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = k * P + p;
      if (j < nvec) {   // SAME: the codes are constants, their branches fold away
        load_affine<VW>(a.w, SAME ? dtype_code<T>() : a.wdtype, j * VW, w[k]);
        load_affine<VW>(a.b, SAME ? dtype_code<T>() : a.bdtype, j * VW, b[k]);
      }
    }
  }
  static __device__ __forceinline__ float pairwise(float (&t)[VW]) {
#pragma unroll
    for (int s = VW / 2; s > 0; s >>= 1)
#pragma unroll
      for (int i = 0; i < s; ++i) t[i] += t[i + s];
    return t[0];
  }
  // the sum of the thread's values (masked vectors are 0)
  __device__ __forceinline__ float sum() const {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float f[VW];
      unpack_raw<T, VW>(x[k], f);
      s += pairwise(f);
    }
    return s;
  }
  // the sum of (x - mean)^2 over the thread's vectors of the row
  __device__ __forceinline__ float m2(float mean, int p, int P, int nvec) const {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (k * P + p < nvec) {
        float f[VW];
        unpack_raw<T, VW>(x[k], f);
#pragma unroll
        for (int e = 0; e < VW; ++e) f[e] = (f[e] - mean) * (f[e] - mean);
        s += pairwise(f);
      }
    return s;
  }
  // y = (x - mean) rstd w + b, in 16-byte stores
  __device__ __forceinline__ void store(T* row, float mean, float rstd, int p, int P,
                                        int nvec) const {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = k * P + p;
      if (j < nvec) {
        float f[VW], o[VW];
        unpack_raw<T, VW>(x[k], f);
#pragma unroll
        for (int e = 0; e < VW; ++e) o[e] = fmaf((f[e] - mean) * rstd, w[k][e], b[k][e]);
        store_vec<T, VW>(row + (int64_t)j * VW, o);
      }
    }
  }
};

// A row per LANES lanes (8, 16 or 32: 32 / LANES rows a warp at once), held
// in registers (LnFwdRow).  A warp walks its groups of rows (warp id, +
// the grid's warps, ...) and issues the next group's loads before it
// reduces this one; the row sums are xor-shuffle butterflies over the
// row's lanes: no shared memory, no barrier.
template <typename T, int K, int LANES, bool SAME>
__global__ void __launch_bounds__(LN_WARPS * 32) ln_fwd_warp_kernel(const LnFwdArgs a) {
  using Row = LnFwdRow<T, K, SAME>;
  constexpr int RPW = 32 / LANES;
  const int h = a.h, nvec = h / Row::VW;
  const float inv_h = 1.f / (float)h;   // a product, not a division, a row
  const int lane = threadIdx.x & 31, p = lane % LANES, sub = lane / LANES;
  const int warps = blockDim.x >> 5;
  const int64_t groups = ((int64_t)a.n + RPW - 1) / RPW;
  const int64_t stride = (int64_t)gridDim.x * warps;
  int64_t gi = (int64_t)blockIdx.x * warps + (threadIdx.x >> 5);
  const T* x = static_cast<const T*>(a.x);
  T* y = static_cast<T*>(a.y);
  Row cur;
  if (gi < groups) cur.load(x + (gi * RPW + sub) * h, p, LANES, nvec, gi * RPW + sub < a.n);
  cur.load_affine_of(a, p, LANES, nvec);   // while the first row is in flight
  while (gi < groups) {
    const int64_t gn = gi + stride, r = gi * RPW + sub;
    uint4 next[K];
    if (gn < groups) {
      Row nx;   // only its x is used: the affine values stay in cur
      nx.load(x + (gn * RPW + sub) * h, p, LANES, nvec, gn * RPW + sub < a.n);
#pragma unroll
      for (int k = 0; k < K; ++k) next[k] = nx.x[k];
    }
    const float mean = lanes_sum<LANES>(cur.sum()) * inv_h;
    const float rstd = rsqrtf(lanes_sum<LANES>(cur.m2(mean, p, LANES, nvec)) * inv_h + a.eps);
    if (r < a.n) {
      cur.store(y + r * h, mean, rstd, p, LANES, nvec);
      if (p == 0) {
        a.stats[r] = mean;
        a.stats[a.n + r] = rstd;
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) cur.x[k] = next[k];
    gi = gn;
  }
}

// A row per CTA of W = blockDim.x / 32 warps (P = 32 W threads), held in
// registers (LnFwdRow), one CTA a row: for rows a warp would hold only in
// long runs of vectors a lane.  Such rows are few (256 and 1024 in the SD
// UNet), so a row's time is one load's round trip and its sums' latency:
// the row sums are warp butterflies, then the warps' sums, loaded at once
// and added in warp order.  The affine values are loaded after the sums:
// loaded beside x, the whole of w and b for each of the ~8 CTAs an SM
// holds slowed x's own loads (measured on the card).
template <typename T, int K, bool SAME>
__global__ void __launch_bounds__(LN_WARPS * 32) ln_fwd_cta_kernel(const LnFwdArgs a) {
  using Row = LnFwdRow<T, K, SAME>;
  __shared__ float red[2][LN_WARPS];
  const int h = a.h, nvec = h / Row::VW;
  const float inv_h = 1.f / (float)h;   // a product, not a division, a row
  const int p = threadIdx.x, P = blockDim.x, warps = P >> 5;
  const int64_t r = blockIdx.x;
  // the warps' sums in warp order (every thread the same bits)
  auto row_sum = [&](float v, float* slot) {
    v = warp_sum(v);
    if ((p & 31) == 0) slot[p >> 5] = v;
    __syncthreads();
    float part[LN_WARPS];
#pragma unroll
    for (int w = 0; w < LN_WARPS; ++w) part[w] = w < warps ? slot[w] : 0.f;
    float s = part[0];
#pragma unroll
    for (int w = 1; w < LN_WARPS; ++w) s += part[w];
    return s;
  };
  Row row;
  row.load(static_cast<const T*>(a.x) + r * h, p, P, nvec, true);
  const float mean = row_sum(row.sum(), red[0]) * inv_h;
  const float rstd = rsqrtf(row_sum(row.m2(mean, p, P, nvec), red[1]) * inv_h + a.eps);
  row.load_affine_of(a, p, P, nvec);
  row.store(static_cast<T*>(a.y) + r * h, mean, rstd, p, P, nvec);
  if (p == 0) {
    a.stats[r] = mean;
    a.stats[a.n + r] = rstd;
  }
}

// Any H and any alignment: a CTA a row, scalar loads, the row read three
// times (the later passes hit L1), block sums in warp order.
template <typename T>
__global__ void __launch_bounds__(LN_WARPS * 32) ln_fwd_row_kernel(const LnFwdArgs a) {
  __shared__ float red[2][LN_WARPS];
  const int h = a.h;
  const int64_t r = blockIdx.x;
  const T* xr = static_cast<const T*>(a.x) + r * h;
  T* yr = static_cast<T*>(a.y) + r * h;
  float s = 0.f;
  for (int i = threadIdx.x; i < h; i += blockDim.x) s += to_f<T>(xr[i]);
  const float mean = block_sum<LN_WARPS>(s, red[0]) / (float)h;
  float m2 = 0.f;
  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    const float d = to_f<T>(xr[i]) - mean;
    m2 = fmaf(d, d, m2);
  }
  const float rstd = rsqrtf(block_sum<LN_WARPS>(m2, red[1]) / (float)h + a.eps);
  for (int i = threadIdx.x; i < h; i += blockDim.x)
    yr[i] = from_f<T>(fmaf((to_f<T>(xr[i]) - mean) * rstd, load_w(a.w, a.wdtype, i),
                           load_w(a.b, a.bdtype, i)));
  if (threadIdx.x == 0) {
    a.stats[r] = mean;
    a.stats[a.n + r] = rstd;
  }
}

typedef void (*LnFwdKernel)(const LnFwdArgs);

// k vectors a thread, `threads` threads a row (layer_norm_fwd_layout in
// ops/layer_norm.py): 8, 16 or 32 lanes of a warp, or a CTA of 64..256
template <typename T, int K, bool SAME>
LnFwdKernel ln_fwd_kernel_k(int threads) {
  if (threads == 8) return ln_fwd_warp_kernel<T, K, 8, SAME>;
  if (threads == 16) return ln_fwd_warp_kernel<T, K, 16, SAME>;
  if (threads == 32) return ln_fwd_warp_kernel<T, K, 32, SAME>;
  return ln_fwd_cta_kernel<T, K, SAME>;
}

// (k, threads): the row kernel (0, 0), or k vectors a thread, at most
// LNF_VALUES values (k <= 3 in 2-byte types, 6 in f32)
template <typename T, bool SAME>
LnFwdKernel ln_fwd_kernel_of(int k, int threads) {
  if (k == 0) return threads == 0 ? ln_fwd_row_kernel<T> : nullptr;
  switch (k) {
    case 1: return ln_fwd_kernel_k<T, 1, SAME>(threads);
    case 2: return ln_fwd_kernel_k<T, 2, SAME>(threads);
    case 3: return ln_fwd_kernel_k<T, 3, SAME>(threads);
  }
  if constexpr (6 * (16 / sizeof(T)) <= LNF_VALUES) {   // f32
    switch (k) {
      case 4: return ln_fwd_kernel_k<T, 4, SAME>(threads);
      case 5: return ln_fwd_kernel_k<T, 5, SAME>(threads);
      case 6: return ln_fwd_kernel_k<T, 6, SAME>(threads);
    }
  }
  return nullptr;
}

template <typename T>
LnFwdKernel ln_fwd_kernel_of(int k, int threads, bool same) {
  return same ? ln_fwd_kernel_of<T, true>(k, threads) : ln_fwd_kernel_of<T, false>(k, threads);
}

// the kernel for x's dtype and the affine dtypes (SAME where both are x's)
LnFwdKernel ln_fwd_kernel(int dtype, int wdtype, int bdtype, int k, int threads) {
  const bool same = wdtype == dtype && bdtype == dtype;
  if (dtype == 0) return ln_fwd_kernel_of<float>(k, threads, same);
  if (dtype == 1) return ln_fwd_kernel_of<__nv_bfloat16>(k, threads, same);
  if (dtype == 2) return ln_fwd_kernel_of<__half>(k, threads, same);
  return nullptr;
}

// ------------------------------------------------------------- GroupNorm
// the GroupNorm CTA's consumer warps (they alone reduce and write dx) wait
// here for one another; the producer warp never does
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(GN_WARPS * 32) : "memory");
}

template <typename T, int MODE>
__global__ void __launch_bounds__((GN_WARPS + 1) * 32) gn_bwd_kernel(const GnArgs a) {
  constexpr int VW = MODE == 2 ? 1 : 16 / sizeof(T);
  constexpr int NT = GN_WARPS * 32;   // consumer threads; warp GN_WARPS is the producer
  constexpr int ST = GN_STAGES;
  extern __shared__ __align__(128) unsigned char gn_smem[];
  // by row parity: every rank's two row-sum partials, pushed here by each
  // rank, and the barrier they complete; the row's mean(g w), mean(g w xhat)
  __shared__ __align__(8) float xch[2][GN_MAX_CLUSTER][2];
  __shared__ uint64_t xbar[2];
  __shared__ uint64_t empty[ST];   // a stage's dx is written: the producer may refill it
  __shared__ float mu[2][2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int s = a.s, cid = blockIdx.x / s, nclusters = gridDim.x / s;
  const int rows = a.n * a.groups, cgs = a.c / a.groups;
  const int nrows = (rows - cid + nclusters - 1) / nclusters;   // this cluster's
  const int c0 = (int)((int64_t)rank * cgs / s);
  const int nch = (int)((int64_t)(rank + 1) * cgs / s) - c0;
  const int hw = a.hw, vpc = hw / VW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* x = static_cast<const T*>(a.x);
  const T* g = static_cast<const T*>(a.g);
  T* dx = static_cast<T*>(a.dx);

  // shared memory (gn_smem_bytes; group_norm_bwd_smem in ops/group_norm.py):
  // MODE 0's ST stages of x and g chunks and their barriers, the sums of a
  // row, the weights of two rows
  const size_t chunk = MODE == 0 ? (size_t)a.max_ch * hw * sizeof(T) : 0;
  uint64_t* bars = reinterpret_cast<uint64_t*>(gn_smem + 2 * ST * chunk);   // [ST][max_ch]
  float2* tsum = reinterpret_cast<float2*>(bars + (MODE == 0 ? ST * a.max_ch : 0));
  float2* csum = tsum + max(GN_WARPS, a.max_ch);
  float* wf = reinterpret_cast<float*>(csum + a.max_ch);                      // [2][max_ch]
  // MODE 0 copies whole channels in pieces of at least GN_PIECE bytes of
  // x, each piece on its own barrier of the stage
  const int pc = max(1, GN_PIECE / (int)(hw * sizeof(T)));
  const int npieces = (nch + pc - 1) / pc;
  auto row_of = [&](int it) { return cid + it * nclusters; };
  auto base_of = [&](int it) { return ((int64_t)row_of(it) * cgs + c0) * hw; };
  auto src = [&](const T* p, int it, int tensor) {   // row it's x (0) or g (1) chunk
    return MODE == 0
               ? reinterpret_cast<const T*>(gn_smem + (2 * (it % ST) + tensor) * chunk)
               : p + base_of(it);
  };
  auto bar = [&](int it, int piece) { return &bars[(it % ST) * a.max_ch + piece]; };
  if (tid == 0) {
    mbar_init(&xbar[0], 1);
    mbar_init(&xbar[1], 1);
    if constexpr (MODE == 0) {
      for (int st = 0; st < ST; ++st) {
        mbar_init(&empty[st], 1);
        for (int i = 0; i < npieces; ++i) mbar_init(&bars[st * a.max_ch + i], 1);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();   // no rank pushes to a barrier before it is made

  if (warp == GN_WARPS) {
    // ----------------------------------------------------- producer (MODE 0)
    // row it's chunk into stage it % ST once row it - ST's dx is written
    if constexpr (MODE == 0) {
      if (lane == 0) {
        for (int it = 0; it < nrows; ++it) {
          if (it >= ST) wait_parity(&empty[it % ST], (it / ST - 1) & 1);
          for (int i = 0; i < npieces; ++i) {
            const int c = i * pc;
            const uint32_t bytes = (uint32_t)(min(pc, nch - c) * hw * sizeof(T));
            mbar_expect_tx(bar(it, i), 2 * bytes);
            bulk_load(const_cast<T*>(src(x, it, 0)) + (size_t)c * hw,
                      x + base_of(it) + (int64_t)c * hw, bytes, bar(it, i));
            bulk_load(const_cast<T*>(src(g, it, 1)) + (size_t)c * hw,
                      g + base_of(it) + (int64_t)c * hw, bytes, bar(it, i));
          }
        }
      }
    }
    __syncwarp();
  } else {
    // ---------------------------------------------------------- consumers
    // dx of row it from its chunk, its weights and its two means:
    // dx = g (rstd w) + (x - mean) (-rstd^2 mean(g w xhat)) - rstd mean(g w)
    const float inv_vpc = 1.f / (float)vpc;
    auto dx_row = [&](int it, float mean, float rstd) {
      const T* xs = src(x, it, 0);
      const T* gs = src(g, it, 1);
      const float* w = wf + (it & 1) * a.max_ch;
      const float b = -rstd * rstd * mu[it & 1][1], c = -rstd * mu[it & 1][0];
      if constexpr (MODE == 0)   // every piece has landed (returns at once)
        for (int i = 0; i < npieces; ++i) wait_parity(bar(it, i), (it / ST) & 1);
      T* dxg = dx + base_of(it);
      const int nv = nch * vpc;
      for (int v0 = tid; v0 < nv; v0 += GN_UNROLL * NT) {   // GN_UNROLL loads in flight
        Raw<T, VW> xr[GN_UNROLL], gr[GN_UNROLL];
#pragma unroll
        for (int u = 0; u < GN_UNROLL; ++u) {
          const int v = v0 + u * NT;
          if (v < nv) {
            xr[u] = load_raw<T, VW>(xs + (size_t)v * VW);
            gr[u] = load_raw<T, VW>(gs + (size_t)v * VW);
          }
        }
#pragma unroll
        for (int u = 0; u < GN_UNROLL; ++u) {
          const int v = v0 + u * NT;
          if (v < nv) {
            int ch = (int)((float)v * inv_vpc);   // v / vpc, corrected below
            ch -= ch * vpc > v;
            ch += (ch + 1) * vpc <= v;
            const float aw = rstd * w[ch];
            float xf[VW], gf[VW], df[VW];
            unpack_raw<T, VW>(xr[u], xf);
            unpack_raw<T, VW>(gr[u], gf);
#pragma unroll
            for (int e = 0; e < VW; ++e) df[e] = fmaf(gf[e], aw, fmaf(xf[e] - mean, b, c));
            store_vec<T, VW>(dxg + (size_t)v * VW, df);
          }
        }
      }
    };

    // The cluster walks its rows; row it's sums, pushed to every rank,
    // then row it - 1's dx (whose stage the producer then refills) while
    // the pushes land, then row it's means from what the ranks pushed.
    const int nsplit = nch < GN_WARPS ? GN_WARPS / nch : 1;
    // a row's statistics and (a thread's first) weight load one row ahead
    auto w_of = [&](int it, int i) {
      return load_w(a.w, a.wdtype, row_of(it) % a.groups * cgs + c0 + i);
    };
    float mean_n = a.mean[row_of(0)], rstd_n = a.rstd[row_of(0)];
    float w_n = tid < nch ? w_of(0, tid) : 0.f;
    float mean_p = 0.f, rstd_p = 0.f;
    for (int it = 0; it < nrows; ++it) {
      const int row = row_of(it), grp = row % a.groups, smp = row / a.groups;
      const T* xs = src(x, it, 0);
      const T* gs = src(g, it, 1);
      const float mean = mean_n, rstd = rstd_n;
      float* w = wf + (it & 1) * a.max_ch;
      if (tid < nch) w[tid] = w_n;
      for (int i = tid + NT; i < nch; i += NT) w[i] = w_of(it, i);
      if (it + 1 < nrows) {
        mean_n = a.mean[row_of(it + 1)];
        rstd_n = a.rstd[row_of(it + 1)];
        if (tid < nch) w_n = w_of(it + 1, tid);
      }

      // per channel: sum(g) and sum(g xhat), a channel split over nsplit
      // warps when the chunk has fewer channels than warps
      for (int t = warp; t < nch * nsplit; t += GN_WARPS) {
        const int ch = t / nsplit, part = t % nsplit;
        if constexpr (MODE == 0) wait_parity(bar(it, ch / pc), (it / ST) & 1);
        const int v0 = (int)((int64_t)part * vpc / nsplit);
        const int v1 = (int)((int64_t)(part + 1) * vpc / nsplit);
        const T* xp = xs + (size_t)ch * hw;
        const T* gp = gs + (size_t)ch * hw;
        float sg = 0.f, sgx = 0.f;
        for (int vb = v0 + lane; vb < v1; vb += GN_UNROLL * 32) {   // GN_UNROLL loads in flight
          Raw<T, VW> xr[GN_UNROLL], gr[GN_UNROLL];
#pragma unroll
          for (int u = 0; u < GN_UNROLL; ++u) {
            const int v = vb + u * 32;
            if (v < v1) {
              xr[u] = load_raw<T, VW>(xp + (size_t)v * VW);
              gr[u] = load_raw<T, VW>(gp + (size_t)v * VW);
            }
          }
#pragma unroll
          for (int u = 0; u < GN_UNROLL; ++u)
            if (vb + u * 32 < v1) {
              float xf[VW], gf[VW];
              unpack_raw<T, VW>(xr[u], xf);
              unpack_raw<T, VW>(gr[u], gf);
#pragma unroll
              for (int e = 0; e < VW; ++e) {
                sg += gf[e];
                sgx += gf[e] * ((xf[e] - mean) * rstd);
              }
            }
        }
        sg = warp_sum(sg);
        sgx = warp_sum(sgx);
        if (lane == 0) tsum[t] = make_float2(sg, sgx);
      }
      consumers_sync();
      // ws [N][2][C]: sum(g xhat), then sum(g), per sample and channel
      for (int ch = tid; ch < nch; ch += NT) {
        float sg = 0.f, sgx = 0.f;
        for (int p = 0; p < nsplit; ++p) {
          sg += tsum[ch * nsplit + p].x;
          sgx += tsum[ch * nsplit + p].y;
        }
        csum[ch] = make_float2(sg, sgx);
        const size_t col = (size_t)grp * cgs + c0 + ch;
        a.ws[(size_t)smp * 2 * a.c + col] = sgx;
        a.ws[((size_t)smp * 2 + 1) * a.c + col] = sg;
      }
      consumers_sync();
      if (warp == 0) {   // the chunk's sums over its channels; lane q pushes them to rank q
        float s1 = 0.f, s2 = 0.f;
        for (int ch = lane; ch < nch; ch += 32) {
          s1 += w[ch] * csum[ch].x;
          s2 += w[ch] * csum[ch].y;
        }
        s1 = warp_sum(s1);
        s2 = warp_sum(s2);
        if (lane == 0) mbar_expect_tx(&xbar[it & 1], 8 * s);
        if (lane < s) push2(&xch[it & 1][rank][0], &xbar[it & 1], lane, s1, s2);
      }
      if (it > 0) {
        dx_row(it - 1, mean_p, rstd_p);
        consumers_sync();   // row it - 1's stage and weights are free again
        if constexpr (MODE == 0)
          if (tid == 0) mbar_arrive(&empty[(it - 1) % ST]);
      }
      if (tid == 0) {   // once every rank's partials have landed: add them in rank order
        wait_parity(&xbar[it & 1], (it >> 1) & 1);
        float s1 = 0.f, s2 = 0.f;
        for (int q = 0; q < s; ++q) {
          s1 += xch[it & 1][q][0];
          s2 += xch[it & 1][q][1];
        }
        const float len = (float)cgs * (float)hw;
        mu[it & 1][0] = s1 / len;
        mu[it & 1][1] = s2 / len;
      }
      consumers_sync();
      mean_p = mean;
      rstd_p = rstd;
    }
    if (nrows > 0) dx_row(nrows - 1, mean_p, rstd_p);
  }

  // dw, db: the [N][2][C] partials summed over N
  last_cluster_sums<16, 4>(a.ticket, s, a.ws, a.n, 2 * a.c, [&](int col, float v) {
    if (col < a.c)
      store_w(a.dw, a.wdtype, col, v);
    else
      store_w(a.db, a.wdtype, col - a.c, v);
  });
}

size_t gn_smem_bytes(int mode, int max_ch, int hw, int item) {
  const size_t chunk = mode == 0 ? (size_t)max_ch * hw * item : 0;
  return 2 * GN_STAGES * chunk + (mode == 0 ? 8 * GN_STAGES * (size_t)max_ch : 0) +
         8 * (size_t)(max_ch > GN_WARPS ? max_ch : GN_WARPS) + 16 * (size_t)max_ch;
}

typedef void (*GnKernel)(const GnArgs);

template <typename T>
GnKernel gn_kernel_of(int mode) {
  if (mode == 0) return gn_bwd_kernel<T, 0>;
  if (mode == 1) return gn_bwd_kernel<T, 1>;
  return gn_bwd_kernel<T, 2>;
}

GnKernel gn_kernel(int dtype, int mode) {
  if (mode < 0 || mode > 2) return nullptr;
  if (dtype == 0) return gn_kernel_of<float>(mode);
  if (dtype == 1) return gn_kernel_of<__nv_bfloat16>(mode);
  if (dtype == 2) return gn_kernel_of<__half>(mode);
  return nullptr;
}

// ----------------------------------------------------- GroupNorm forward
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// f(v, the VW values of vector v) for the CTA's share of vectors [v0, v1)
// of src, U loads in flight a thread (device memory needs several to hide
// its latency; from shared memory one is faster)
template <typename T, int VW, int U, typename F>
__device__ __forceinline__ void for_vectors(const T* src, int v0, int v1, F f) {
  constexpr int NT = GNF_WARPS * 32;
  for (int vb = v0 + (int)threadIdx.x; vb < v1; vb += U * NT) {
    Raw<T, VW> r[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (vb + u * NT < v1) r[u] = load_raw<T, VW>(src + (size_t)(vb + u * NT) * VW);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (vb + u * NT < v1) {
        float f32[VW];
        unpack_raw<T, VW>(r[u], f32);
        f(vb + u * NT, f32);
      }
  }
}

// One CTA takes the whole channels [r Cg / S, (r + 1) Cg / S) of one row
// (rank r of the row's cluster of S; S = 1 launches no cluster).  MODE 0
// loads them once into shared memory by bulk copies of GNF_PIECE bytes, one
// barrier each, and sums each piece as it lands; MODE 1 (16-byte vectors)
// and MODE 2 (scalars) load U vectors a thread at once: a chunk of at most
// U a thread is held in registers through the passes, a larger one is
// read from device memory in every pass.  U (the plan's "hold") is the
// smallest instantiation that holds the chunk: unused slots cost.
template <typename T, int MODE, int U>
__global__ void __launch_bounds__(GNF_WARPS * 32) gn_fwd_kernel(const GnFwdArgs a) {
  constexpr int VW = MODE == 2 ? 1 : 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char gnf_smem[];
  __shared__ float red[2][GNF_WARPS];
  const int s = a.s, rank = s == 1 ? 0 : (int)(blockIdx.x % s);
  const int row = s == 1 ? (int)blockIdx.x : (int)(blockIdx.x / s);
  const int cgs = a.cg, hw = a.hw, tid = threadIdx.x;
  // the ranks' channels in 32 bits (the entry point takes Cg < 2^28)
  auto first_ch = [&](int r) { return (int)((unsigned)r * cgs / (unsigned)s); };
  const int c0 = s == 1 ? 0 : first_ch(rank);
  const int nch = s == 1 ? cgs : first_ch(rank + 1) - c0;
  const int vpc = hw / VW, nv = nch * vpc;
  const int64_t base = ((int64_t)row * cgs + c0) * hw;
  const T* xg = static_cast<const T*>(a.x) + base;
  T* yg = static_cast<T*>(a.y) + base;
  // shared memory (gn_fwd_smem_bytes; group_norm_fwd_smem in
  // ops/group_norm.py): MODE 0's chunk and a barrier a piece; the barrier
  // of the exchange and each rank's (sum, M2), pushed here by that rank;
  // the chunk's weights and biases in f32
  const size_t chunk = MODE == 0 ? (size_t)a.max_ch * hw * sizeof(T) : 0;
  uint64_t* bars = reinterpret_cast<uint64_t*>(gnf_smem + chunk);
  uint64_t* xbar = bars + (chunk + GNF_PIECE - 1) / GNF_PIECE;
  float* xch = reinterpret_cast<float*>(xbar + 1);   // [GN_MAX_CLUSTER][2]
  float* wf = xch + 2 * GN_MAX_CLUSTER;
  float* bf = wf + a.max_ch;
  const T* xs = MODE == 0 ? reinterpret_cast<const T*>(gnf_smem) : xg;
  const uint32_t bytes = MODE == 0 ? (uint32_t)(nch * hw * sizeof(T)) : 0;
  const int npieces = (int)((bytes + GNF_PIECE - 1) / GNF_PIECE);

  // barriers only where they are used: a streamed chunk of a row of its
  // own (the small rows) waits on none
  const bool barriers = MODE == 0 || s > 1;
  if (barriers && tid == 0) {
    if constexpr (MODE == 0)
      for (int p = 0; p < npieces; ++p) mbar_init(&bars[p], 1);
    mbar_init(xbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (s > 1) mbar_expect_tx(xbar, 8 * s);
  }
  // the chunk's weights and biases: loaded now, kept in registers until
  // after the second pass (waiting on them here would hold the first
  // pass for a round trip to device memory, twice where the card is busy)
  const int w0 = row % a.groups * cgs + c0;
  float w_r = 0.f, b_r = 0.f;
  if (tid < nch) {
    w_r = load_w(a.w, a.wdtype, w0 + tid);
    b_r = load_w(a.b, a.bdtype, w0 + tid);
  }
  // a streamed chunk of at most one batch a thread (the small rows) is
  // loaded once, here, and held in registers through the three passes
  constexpr int NT = GNF_WARPS * 32;
  const bool held = MODE != 0 && nv <= U * NT;
  Raw<T, VW> keep[U];
  if (held) {
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (tid + u * NT < nv) keep[u] = load_raw<T, VW>(xs + (size_t)(tid + u * NT) * VW);
  }
  auto each = [&](auto f) {   // f(v, its VW values) over the CTA's vectors
    if (held) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (tid + u * NT < nv) {
          float f32[VW];
          unpack_raw<T, VW>(keep[u], f32);
          f(tid + u * NT, f32);
        }
    } else {
      for_vectors<T, VW, U>(xs, 0, nv, f);
    }
  };
  if (barriers) __syncthreads();   // the barriers are made
  if (s > 1) cluster_arrive_relaxed();   // waited for before the first push
  // the copies, after the barrier: an issue blocks while the SM's copy
  // queue is full, and the other warps start on the first piece meanwhile
  if constexpr (MODE == 0)
    if (tid == 0)
      for (int p = 0; p < npieces; ++p) {
        const uint32_t pb = min((uint32_t)GNF_PIECE, bytes - p * GNF_PIECE);
        mbar_expect_tx(&bars[p], pb);
        bulk_load(gnf_smem + (size_t)p * GNF_PIECE,
                  reinterpret_cast<const unsigned char*>(xg) + (size_t)p * GNF_PIECE, pb, &bars[p]);
      }

  // the chunk's sum, then M2 about its own mean (two passes, never E[x^2])
  float s1 = 0.f;
  auto add = [&](int, const float(&f)[VW]) {
#pragma unroll
    for (int e = 0; e < VW; ++e) s1 += f[e];
  };
  if constexpr (MODE == 0) {
    constexpr int PV = GNF_PIECE / 16;   // vectors a piece
    for (int p = 0; p < npieces; ++p) {
      wait_parity(&bars[p], 0);
      for_vectors<T, VW, U>(xs, p * PV, min(nv, (p + 1) * PV), add);
    }
  } else {
    each(add);
  }
  const float n_loc = (float)nch * (float)hw, n_row = (float)cgs * (float)hw;
  const float sum = block_sum<GNF_WARPS>(s1, red[0]);
  const float m_loc = sum / n_loc;
  float s2 = 0.f;
  each([&](int, const float(&f)[VW]) {
#pragma unroll
    for (int e = 0; e < VW; ++e) {
      const float d = f[e] - m_loc;
      s2 = fmaf(d, d, s2);
    }
  });
  if (tid < nch) {   // in shared memory once block_sum's barrier has passed
    wf[tid] = w_r;
    bf[tid] = b_r;
  }
  for (int i = tid + GNF_WARPS * 32; i < nch; i += GNF_WARPS * 32) {
    wf[i] = load_w(a.w, a.wdtype, w0 + i);
    bf[i] = load_w(a.b, a.bdtype, w0 + i);
  }
  const float m2 = block_sum<GNF_WARPS>(s2, red[1]);

  // the row's statistics: each rank's (sum, M2) to every rank, merged in
  // rank order by Chan's formula, M2 = sum over r of M2_r + n_r (mean_r -
  // mean)^2 (every thread of every rank computes the same bits)
  float mean = m_loc, m2_row = m2;
  if (s > 1) {
    cluster_wait();
    if (tid < s) push2(&xch[2 * rank], xbar, tid, sum, m2);
    wait_parity(xbar, 0);
    float tot = 0.f;
    for (int q = 0; q < s; ++q) tot += xch[2 * q];
    mean = tot / n_row;
    m2_row = 0.f;
    for (int q = 0; q < s; ++q) {
      const float nq = (float)(first_ch(q + 1) - first_ch(q)) * (float)hw;
      const float d = xch[2 * q] / nq - mean;
      m2_row += xch[2 * q + 1] + nq * d * d;
    }
  }
  const float rstd = rsqrtf(m2_row / n_row + a.eps);
  if (rank == 0 && tid == 0) {
    a.stats[row] = mean;
    a.stats[a.rows + row] = rstd;
  }

  // y = (x - mean) (rstd w[c]) + b[c], in x's dtype
  const float inv_vpc = 1.f / (float)vpc;
  each([&](int v, const float(&f)[VW]) {
    int ch;
    if (nv < (1 << 22)) {   // v / vpc by a float product, corrected: exact here
      ch = (int)((float)v * inv_vpc);
      ch -= ch * vpc > v;
      ch += (ch + 1) * vpc <= v;
    } else {
      ch = v / vpc;
    }
    const float sc = rstd * wf[ch], sh = bf[ch];
    float o[VW];
#pragma unroll
    for (int e = 0; e < VW; ++e) o[e] = fmaf(f[e] - mean, sc, sh);
    store_vec<T, VW>(yg + (size_t)v * VW, o);
  });
}

size_t gn_fwd_smem_bytes(int mode, int max_ch, int hw, int item) {
  const size_t chunk = mode == 0 ? (size_t)max_ch * hw * item : 0;
  return chunk + 8 * ((chunk + GNF_PIECE - 1) / GNF_PIECE + 1 + GN_MAX_CLUSTER + (size_t)max_ch);
}

typedef void (*GnFwdKernel)(const GnFwdArgs);

// (mode, hold): staged with one load in flight, or streamed holding /
// loading `hold` vectors a thread (group_norm_fwd_hold in ops/group_norm.py)
template <typename T>
GnFwdKernel gn_fwd_kernel_of(int mode, int hold) {
  if (mode == 0 && hold == 1) return gn_fwd_kernel<T, 0, 1>;
  if (mode == 1 && hold == 4) return gn_fwd_kernel<T, 1, 4>;
  if (mode == 1 && hold == 8) return gn_fwd_kernel<T, 1, 8>;
  if (mode == 1 && hold == 10) return gn_fwd_kernel<T, 1, 10>;
  if (mode == 2 && hold == 4) return gn_fwd_kernel<T, 2, 4>;
  return nullptr;
}

GnFwdKernel gn_fwd_kernel_for(int dtype, int mode, int hold) {
  if (dtype == 0) return gn_fwd_kernel_of<float>(mode, hold);
  if (dtype == 1) return gn_fwd_kernel_of<__nv_bfloat16>(mode, hold);
  if (dtype == 2) return gn_fwd_kernel_of<__half>(mode, hold);
  return nullptr;
}

}  // namespace norms

using namespace norms;

extern "C" int layer_norm_bwd_max_ctas(int dtype, int h, int k, int* ctas) {
  LnKernel kernel = ln_kernel(dtype, k);
  if (kernel == nullptr || h <= 0) return cudaErrorInvalidValue;
  int clusters = 0;
  const cudaError_t e =
      max_clusters(kernel, LN_WARPS * 32, LN_CLUSTER, ln_smem_bytes(dtype, k, h), &clusters);
  *ctas = clusters * LN_CLUSTER;
  return e;
}

extern "C" int layer_norm_bwd(const void* x, const void* w, const float* mean,
                              const float* rstd, const void* g, void* dx, void* dw,
                              void* db, float* ws, int ws_floats, int* ticket, int n, int h,
                              int dtype, int wdtype, int k, int ctas, void* stream) {
  LnKernel kernel = ln_kernel(dtype, k);
  if (kernel == nullptr || n <= 0 || h <= 0 || ctas <= 0 || ctas % LN_CLUSTER ||
      wdtype < 0 || wdtype > 2 ||
      (int64_t)ws_floats < (int64_t)(ctas / LN_CLUSTER + (k ? 0 : ctas)) * 2 * h)
    return cudaErrorInvalidValue;
  const LnArgs a = {x, w, mean, rstd, g, dx, dw, db, ws, ticket, n, h, wdtype};
  return launch_cluster(kernel, ctas, LN_WARPS * 32, LN_CLUSTER, ln_smem_bytes(dtype, k, h),
                        static_cast<cudaStream_t>(stream), a);
}

// a forward launch's geometry: the row kernel (k 0, 8 warps), a row per
// 8, 16 or 32 lanes (any warps a CTA), or a row per CTA of 2..8 warps
static bool ln_fwd_geometry(int k, int threads, int warps) {
  if (warps < 1 || warps > LN_WARPS) return false;
  if (k == 0) return threads == 0 && warps == LN_WARPS;
  return threads == 8 || threads == 16 || threads == 32 || (warps > 1 && threads == warps * 32);
}

extern "C" int layer_norm_fwd_max_ctas(int dtype, int wdtype, int bdtype, int k, int threads,
                                       int warps, int* ctas) {
  LnFwdKernel kernel = ln_fwd_kernel(dtype, wdtype, bdtype, k, threads);
  if (kernel == nullptr || !ln_fwd_geometry(k, threads, warps)) return cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, warps * 32, 0);
  if (e == cudaSuccess && per_sm <= 0) e = cudaErrorInvalidConfiguration;
  *ctas = per_sm * sms;
  return e;
}

extern "C" int layer_norm_fwd(const void* x, const void* w, const void* b, void* y, float* stats,
                              int n, int h, int dtype, int wdtype, int bdtype, int k, int threads,
                              int warps, int ctas, float eps, void* stream) {
  LnFwdKernel kernel = ln_fwd_kernel(dtype, wdtype, bdtype, k, threads);
  if (kernel == nullptr || !ln_fwd_geometry(k, threads, warps) || n <= 0 || h <= 0 ||
      ctas <= 0 || wdtype < 0 || wdtype > 2 || bdtype < 0 || bdtype > 2)
    return cudaErrorInvalidValue;
  // the CTA-a-row kernels take one row a CTA
  if ((k == 0 || threads > 32) && ctas != n) return cudaErrorInvalidValue;
  const int vw = dtype == 0 ? 4 : 8;
  if (k && (h % vw || h > k * threads * vw ||
            (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
             reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(b)) % 16))
    return cudaErrorInvalidValue;
  const LnFwdArgs a = {x, w, b, y, stats, n, h, wdtype, bdtype, eps};
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      cluster_config(ctas, warps * 32, 1, 0, static_cast<cudaStream_t>(stream), &attr);
  cfg.numAttrs = 0;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

extern "C" int group_norm_bwd_max_clusters(int dtype, int mode, int cluster, int smem_bytes,
                                           int* clusters) {
  GnKernel kernel = gn_kernel(dtype, mode);
  if (kernel == nullptr || cluster < 1 || cluster > GN_MAX_CLUSTER || smem_bytes < 0)
    return cudaErrorInvalidValue;
  return max_clusters(kernel, (GN_WARPS + 1) * 32, cluster, smem_bytes, clusters);
}

extern "C" int group_norm_bwd(const void* x, const void* w, const float* mean,
                              const float* rstd, const void* g, void* dx, void* dw,
                              void* db, float* ws, int* ticket, int n, int c, int groups,
                              int hw, int dtype, int wdtype, int mode, int cluster,
                              int clusters, int smem_bytes, void* stream) {
  GnKernel kernel = gn_kernel(dtype, mode);
  if (kernel == nullptr || n <= 0 || c <= 0 || groups <= 0 || c % groups || hw <= 0 ||
      wdtype < 0 || wdtype > 2 || cluster < 1 || cluster > GN_MAX_CLUSTER ||
      cluster > c / groups || clusters < 1 || clusters > n * groups)
    return cudaErrorInvalidValue;
  const int item = dtype == 0 ? 4 : 2;
  if (mode != 2 && (hw * item) % 16) return cudaErrorInvalidValue;
  const int max_ch = (c / groups + cluster - 1) / cluster;
  if ((size_t)smem_bytes < gn_smem_bytes(mode, max_ch, hw, item)) return cudaErrorInvalidValue;
  const GnArgs a = {x, w, mean, rstd, g, dx, dw, db, ws, ticket,
                    n, c, groups, hw, wdtype, cluster, max_ch};
  return launch_cluster(kernel, clusters * cluster, (GN_WARPS + 1) * 32, cluster, smem_bytes,
                        static_cast<cudaStream_t>(stream), a);
}

extern "C" int group_norm_fwd(const void* x, const void* w, const void* b, void* y, float* stats,
                              int n, int c, int groups, int hw, int dtype, int wdtype, int bdtype,
                              int mode, int hold, int cluster, int smem_bytes, float eps,
                              void* stream) {
  GnFwdKernel kernel = gn_fwd_kernel_for(dtype, mode, hold);
  if (kernel == nullptr || n <= 0 || c <= 0 || groups <= 0 || c % groups || hw <= 0 ||
      c / groups >= (1 << 28) || wdtype < 0 || wdtype > 2 || bdtype < 0 || bdtype > 2 ||
      cluster < 1 || cluster > GN_MAX_CLUSTER || cluster > c / groups ||
      (int64_t)n * groups * cluster > 0x7fffffff)
    return cudaErrorInvalidValue;
  const int item = dtype == 0 ? 4 : 2;
  if (mode != 2 && ((hw * item) % 16 || (reinterpret_cast<uintptr_t>(x) |
                                         reinterpret_cast<uintptr_t>(y)) % 16))
    return cudaErrorInvalidValue;
  const int max_ch = (c / groups + cluster - 1) / cluster;
  if ((size_t)smem_bytes < gn_fwd_smem_bytes(mode, max_ch, hw, item)) return cudaErrorInvalidValue;
  // above 48 KB of shared memory (static included) a kernel must opt in
  if (smem_bytes > 40 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return e;
  }
  const GnFwdArgs a = {x,  w,      b,  y,      stats,   n * groups, c / groups,
                       groups, hw, wdtype, bdtype, cluster, max_ch, eps};
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(n * groups * cluster, GNF_WARPS * 32, cluster,
                                          smem_bytes, static_cast<cudaStream_t>(stream), &attr);
  if (cluster == 1) cfg.numAttrs = 0;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}
